"""One-shot acceptance drive (port of ``scripts/accept_drive.py``): the
training benchmark, then the shipped models' quality.

Runs ``bench_torch.py`` (unless ``--skip-bench``), the shipped LLC on
HumanoidAMPGetup through ``ASEPlayer`` for ``--llc-steps`` control steps,
and every shipped HLC (heading, location, reach, strike; a missing
checkpoint reports null) through ``HRLPlayer`` for ``--hlc-steps``
decisions, all at ``--num-envs`` envs. Each player plays chunks of that
many steps until ``--games`` episodes have finished (the train config's
``player.games_num``, 2000, by default) or ``--max-chunks`` chunks have
run. Prints one JSON line of returns, lengths and success rates and
writes it to ``--out`` (``output/acceptance.json`` by default):

  python -m ase_tpu_torch.tools.accept_drive [--skip-bench] [--hlc-steps 320] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from ase_tpu_torch.tools import load_cfg, out_file
from ase_tpu_torch.utils import paths
from ase_tpu_torch.utils.config import torch_device

# downstream task -> its env config (the reference ships an LLC and 4 HLCs)
HLC_TASKS = {
    "HumanoidHeading": "humanoid_sword_shield_heading.yaml",
    "HumanoidLocation": "humanoid_sword_shield_location.yaml",
    "HumanoidReach": "humanoid_sword_shield_reach.yaml",
    "HumanoidStrike": "humanoid_sword_shield_strike.yaml",
}
LLC_FILE = "ase_llc_reallusion_sword_shield.ckpt.npz"


def hlc_checkpoint(short: str) -> str:
    return paths.data_path("models", f"ase_hlc_{short}_reallusion_sword_shield.ckpt.npz")


def success_fns():
    """Per-task goal-attainment indicators on the env state
    (``scripts/accept_drive.py:30-58``): heading, a step reward above 0.7
    (the direction term met; the reward lies in [0, 1]); location, the root
    within 0.5 m (xy) of the target; reach, the reach body within 0.3 m of
    the target point. Strike returns None: the player then reads the env's
    ``aux['successes']`` (the target knocked over). Each entry maps an env
    to its function."""
    def heading(st):
        return st.rew > 0.7

    def location(st):
        return torch.linalg.norm(st.phys.root_pos[:, :2] - st.aux["tar_pos"], dim=-1) < 0.5

    def reach(env):
        def fn(st):
            d = st.body_pos[:, env._reach_body_id, :] - st.aux["tar_pos"]
            return torch.linalg.norm(d, dim=-1) < 0.3
        return fn

    return {"heading": lambda env: heading, "location": lambda env: location,
            "reach": reach, "strike": lambda env: None}


def eval_llc(num_steps: int, num_envs: int, device, games=None, max_chunks=100) -> dict:
    """The shipped LLC on HumanoidAMPGetup through ``ASEPlayer``."""
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.learning.ase_agent import ASEAgent
    from ase_tpu_torch.learning.players import ASEPlayer

    cfg = load_cfg("humanoid_ase_sword_shield_getup.yaml")
    cfg["env"]["numEnvs"] = num_envs
    cfg["env"]["motion_file"] = paths.default_dataset()
    cfg_train = load_cfg("train/rlg/ase_humanoid.yaml")
    c = cfg_train["params"]["config"]
    c["minibatch_size"] = 4096
    c["amp_obs_demo_buffer_size"] = 4096
    c["amp_replay_buffer_size"] = 4096
    agent = ASEAgent(parse_task("HumanoidAMPGetup", cfg, device=device), cfg_train)
    player = ASEPlayer(agent, print_stats=False)
    player.restore(paths.data_path("models", LLC_FILE))
    return player.run(num_steps=num_steps, games_num=games, max_chunks=max_chunks)


def eval_hlcs(num_steps: int, num_envs: int, device, games=None, max_chunks=100) -> dict:
    """Every shipped HLC through ``HRLPlayer`` over the shipped LLC."""
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.learning.hrl_agent import HRLAgent
    from ase_tpu_torch.learning.players import HRLPlayer

    succ = success_fns()
    out = {}
    for task, cfg_name in HLC_TASKS.items():
        short = task.replace("Humanoid", "").lower()
        path = hlc_checkpoint(short)
        if not os.path.exists(path):
            out[short] = None
            continue
        cfg = load_cfg(cfg_name)
        cfg["env"]["numEnvs"] = num_envs
        cfg["env"]["motion_file"] = paths.default_dataset()
        cfg_train = load_cfg("train/rlg/hrl_humanoid.yaml")
        c = cfg_train["params"]["config"]
        c["minibatch_size"] = 4096
        c["llc_checkpoint"] = paths.data_path("models", LLC_FILE)
        env = parse_task(task, cfg, device=device)
        player = HRLPlayer(HRLAgent(env, cfg_train), print_stats=False)
        player.restore(path)
        stats = player.run(num_steps=num_steps, games_num=games, max_chunks=max_chunks,
                           success_fn=succ[short](env))
        out[short] = {
            "mean_return": round(stats["mean_return"], 1),
            "mean_length": round(stats["mean_length"], 1),
            "episodes": stats["episodes"],
            "success_rate": round(stats["success_rate"], 3),
            "success_time_frac": round(stats["success_time_frac"], 3),
        }
    return out


def run_bench() -> dict:
    """``bench_torch.py``'s JSON line (it needs the card)."""
    bench = subprocess.run([sys.executable, "-u", os.path.join(paths.repo_root(), "bench_torch.py")],
                           capture_output=True, text=True, timeout=2400)
    for line in bench.stdout.splitlines()[::-1]:
        if line.startswith("{"):
            return json.loads(line)
    print(bench.stdout[-2000:], file=sys.stderr)
    print(bench.stderr[-2000:], file=sys.stderr)
    raise SystemExit("bench_torch.py printed no JSON line")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-bench", action="store_true")
    ap.add_argument("--hlc-steps", type=int, default=320)
    ap.add_argument("--llc-steps", type=int, default=300)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--games", type=int, default=None)
    ap.add_argument("--max-chunks", type=int, default=100)
    ap.add_argument("--out", type=str, default="output/acceptance.json")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = torch_device(args.device)

    bench = {"value": None}
    if not args.skip_bench:
        bench = run_bench()
    stats = eval_llc(args.llc_steps, args.num_envs, dev, args.games, args.max_chunks)
    summary = {
        "bench_steps_per_sec": bench["value"],
        "vs_baseline": bench.get("vs_baseline"),     # bench_torch.py has no TPU baseline
        "llc_mean_return": round(stats["mean_return"], 1),
        "llc_mean_length": round(stats["mean_length"], 1),
        "llc_episodes": stats["episodes"],
        "hlc": eval_hlcs(args.hlc_steps, args.num_envs, dev, args.games, args.max_chunks),
    }
    line = json.dumps(summary)
    with open(out_file(args.out), "w") as f:
        f.write(line + "\n")
    print(line)
    return summary


if __name__ == "__main__":
    main()
