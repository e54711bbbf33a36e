"""Flagship learning validation (port of ``scripts/validate_ase.py``), in
two modes:

- ``ase``: the ASE low-level-controller pretrain on the 87-clip
  sword-and-shield dataset (``ase_humanoid.yaml`` on HumanoidAMPGetup):
  the discriminator (style) and encoder (skill) rewards and the episode
  length should rise. Saves the LLC checkpoint (``--ckpt-out``) for the
  HRL stage.
- ``hrl``: a high-level controller on one downstream task (heading,
  location, reach or strike) over a frozen LLC (``hrl_humanoid.yaml``):
  the task reward should trend up; on strike the consecutive-success
  meter is charted too.

Both train in mixed precision, as the reference's runs do. Appends a
section with the curve to ``VALIDATION.md`` in ``--out-dir`` (``output/``
by default) and writes the whole history to
``validation_{mode}[_{task}]_history.json`` there:

  python -m ase_tpu_torch.tools.validate_ase --mode ase --epochs 600
  python -m ase_tpu_torch.tools.validate_ase --mode hrl --task HumanoidStrike --epochs 400 \\
      --llc data/models/ase_llc_reallusion_sword_shield.ckpt.npz
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ase_tpu_torch.tools import load_cfg, out_file
from ase_tpu_torch.tools.validate_learning import device_name, train_curve
from ase_tpu_torch.utils import paths
from ase_tpu_torch.utils.config import torch_device

HRL_TASK_CFG = {
    "HumanoidHeading": "humanoid_sword_shield_heading.yaml",
    "HumanoidLocation": "humanoid_sword_shield_location.yaml",
    "HumanoidReach": "humanoid_sword_shield_reach.yaml",
    "HumanoidStrike": "humanoid_sword_shield_strike.yaml",
}
DUMP_EVERY = 50          # epochs between crash-safe dumps of the history


def build(args, dev):
    """(agent, curve keys, task) of the mode."""
    from ase_tpu_torch.envs import parse_task

    if args.mode == "ase":
        from ase_tpu_torch.learning.ase_agent import ASEAgent as agent_cls

        cfg = load_cfg("humanoid_ase_sword_shield_getup.yaml")
        cfg_train = load_cfg("train/rlg/ase_humanoid.yaml")
        task = "HumanoidAMPGetup"
        keys = ["disc_reward_mean", "enc_reward_mean", "game_length_mean", "reward_mean"]
    else:
        from ase_tpu_torch.learning.hrl_agent import HRLAgent as agent_cls

        cfg = load_cfg(HRL_TASK_CFG[args.task])
        cfg_train = load_cfg("train/rlg/hrl_humanoid.yaml")
        cfg_train["params"]["config"]["llc_checkpoint"] = args.llc
        task = args.task
        keys = ["reward_mean", "game_reward_mean", "game_length_mean"]
        if task == "HumanoidStrike":
            keys.append("consecutive_successes_mean")
    cfg["env"]["numEnvs"] = args.num_envs
    cfg["env"]["motion_file"] = args.motion
    cfg["env"]["resetChunk"] = 512
    cfg["name"] = task
    cfg["seed"] = args.seed + 1
    cfg_train["params"]["seed"] = args.seed
    c = cfg_train["params"]["config"]
    c["num_actors"] = args.num_envs
    c["horizon_length"] = args.horizon
    c["minibatch_size"] = min(16384, args.num_envs * args.horizon)
    c["mixed_precision"] = True
    c["save_frequency"] = 0
    env = parse_task(task, cfg, device=dev)
    return agent_cls(env, cfg_train, output_dir=args.out_dir), keys, task


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--mode", choices=["ase", "hrl"], default="ase")
    p.add_argument("--task", choices=sorted(HRL_TASK_CFG), default="HumanoidHeading",
                   help="HRL downstream task (hrl mode only)")
    p.add_argument("--epochs", type=int, default=600)
    p.add_argument("--num-envs", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--motion", default=paths.default_dataset())
    p.add_argument("--llc", default=paths.data_path(
        "models", "ase_llc_reallusion_sword_shield.ckpt.npz"))
    p.add_argument("--ckpt-out", default="")
    p.add_argument("--tag-suffix", default="",
                   help="suffix of the history json's tag (a fresh curve beside an old one)")
    p.add_argument("--no-doc", action="store_true", help="skip the VALIDATION.md section")
    p.add_argument("--out-dir", default="output")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.mode == "ase" and not args.ckpt_out:
        args.ckpt_out = os.path.join(args.out_dir, "validate_ase", "llc.ckpt.npz")
    dev = torch_device(args.device)

    agent, keys, task = build(args, dev)
    tag = args.mode if args.mode == "ase" else "hrl_" + args.task.replace("Humanoid", "").lower()
    if args.tag_suffix:
        tag = f"{tag}_{args.tag_suffix}"
    hist_path = out_file(os.path.join(args.out_dir, f"validation_{tag}_history.json"))

    def on_epoch(epoch, history):
        if args.ckpt_out and (epoch + 1) % max(args.epochs // 3, 1) == 0:
            agent.save(out_file(args.ckpt_out))
        if epoch % DUMP_EVERY == DUMP_EVERY - 1:       # crash-safe dump of the curve
            with open(hist_path, "w") as f:
                json.dump(history, f)

    t_start = time.time()
    _, history = train_curve(agent, args.epochs, keys=keys, on_epoch=on_epoch)
    wall = time.time() - t_start
    if args.ckpt_out:
        agent.save(out_file(args.ckpt_out))
    with open(hist_path, "w") as f:
        json.dump(history, f)

    if args.no_doc:
        print(f"validation ({args.mode}) done in {wall:.0f}s (doc section skipped)")
        return history
    picks = sorted({0, *range(0, args.epochs, max(args.epochs // 7, 1)), args.epochs - 1})
    title = ("ASE LLC pretrain: 87-clip sword&shield dataset" if args.mode == "ase"
             else f"HRL {args.task}: frozen LLC")
    with open(os.path.join(args.out_dir, "VALIDATION.md"), "a") as f:
        f.write(f"\n## {title}\n\n")
        f.write(f"Task {task}, {args.num_envs} envs, horizon {args.horizon}, {args.epochs} "
                f"epochs ({args.epochs * agent.batch_size:,} env-steps) in {wall:.0f}s on "
                f"{device_name(dev)}, seed {args.seed}.\n\n")
        f.write("| epoch | " + " | ".join(keys) + " |\n")
        f.write("|" + "---|" * (len(keys) + 1) + "\n")
        for e in picks:
            h = history[e]
            f.write(f"| {e} | " + " | ".join(f"{h.get(k, float('nan')):.3f}" for k in keys)
                    + " |\n")
        f.write(f"\nFull history: `{os.path.basename(hist_path)}`\n")
    print(f"validation ({args.mode}) done in {wall:.0f}s")
    return history


if __name__ == "__main__":
    main()
