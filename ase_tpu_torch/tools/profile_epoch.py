"""Profile a window of bench.py's training epoch (port of ``scripts/profile_bench_epoch.py``).

The workload is bench.py's, built as ``bench_torch.py`` builds it
(``build_bench_agent``): HumanoidAMPGetup on the sword-shield humanoid, the
87-clip dataset, self-collision on, resetChunk 512, ``ase_humanoid.yaml``
at its widths with horizon 32 and minibatch min(16384, envs x 32), bf16
dense layers unless ``--float32`` (the reference's default). After
WARMUP_EPOCHS warm-up epochs one untraced epoch gives the epoch wall, env-steps/s and
``train_epoch``'s own rollout / update split. Then a window runs under
torch.profiler (CPU and CUDA activities), each part its own Chrome trace
under ``--out-dir`` (default ``output/profile_bench``):

- by default ``--control-steps`` (2) control steps of the rollout, with the
  rollout phase's tail (rewards, GAE, the dataset) over those steps, then
  ``--minibatches`` (1) minibatch updates at the shipped minibatch size on
  the rows those steps recorded (drawn from the epoch's permutation,
  repeated where the window holds fewer rows). A getup control step makes
  ~28,000 launches, so a whole epoch nears a million events;
- with ``--whole-epoch``, one whole ``train_epoch``, as the reference does.

Prints and returns the untraced numbers and each trace's
``trace_summary``: device busy, launches, top kernels and buckets.

    python -m ase_tpu_torch.tools.profile_epoch [--num_envs 4096] [--float32] \\
        [--control-steps 2] [--minibatches 1] [--whole-epoch] [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import torch

from ase_tpu_torch.tools import trace_summary
from ase_tpu_torch.utils.profiling import profiled, sync

DATASET = "data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"
# bench.py's workload as the training CLI builds it; self-collision and
# resetChunk 512 are the shipped env config's own, and are checked, not set
BENCH_ARGV = [
    "--task", "HumanoidAMPGetup",
    "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", DATASET,
    "--seed", "0",
]
WARMUP_EPOCHS = 1                # untimed epochs before the timed one (the kernels' builds)


def build_bench_agent(num_envs: int = 4096, horizon: int = 32, mixed: bool = True,
                      device: str = "cuda"):
    """bench.py's agent at ``num_envs`` x ``horizon``, bf16 dense layers if
    ``mixed``."""
    from ase_tpu_torch import run

    def precision(cfg, cfg_train):
        cfg_train["params"]["config"]["mixed_precision"] = mixed

    agent, _, _ = run.build_agent(BENCH_ARGV + [
        "--num_envs", str(num_envs), "--horizon_length", str(horizon),
        "--minibatch_size", str(min(16384, num_envs * horizon)),
        "--device", device], edit_cfg=precision)
    dtype = agent.network.mu.compute_dtype
    if not (agent.env.sim_cfg.enable_self_collision and agent.env.reset_chunk == 512
            and dtype == (torch.bfloat16 if mixed else None)):
        raise ValueError("bench.py's workload runs self-collision on, resetChunk 512, "
                         f"mixed_precision {mixed}")
    return agent


@contextlib.contextmanager
def _cut_horizon(agent, steps: int):
    """The agent's rollout cut to ``steps`` control steps; its horizon,
    batch size, epoch and frame come back afterwards."""
    saved = agent.horizon_length, agent.batch_size, agent.epoch, agent.frame
    agent.horizon_length = steps
    agent.batch_size = steps * agent.num_actors * agent.world
    try:
        yield
    finally:
        agent.horizon_length, agent.batch_size, agent.epoch, agent.frame = saved


def trace_window(agent, env_state, out_dir: str, control_steps: int = 2, minibatches: int = 1,
                 top: int = 20):
    """Trace ``control_steps`` control steps of ``agent``'s rollout (with
    the rollout phase's tail over them), then ``minibatches`` minibatch
    updates on their rows, into ``<out_dir>/<stamp>_rollout.pt.trace.json.gz``
    and ``..._update...``. The agent trains on: the env steps on and
    the weights take the updates. Returns (env_state, {"rollout": summary,
    "update": summary}), each summary with its ``trace`` path and host
    ``wall_ms``."""
    if minibatches > agent.num_minibatches:
        raise ValueError(f"{minibatches} minibatches: an epoch has {agent.num_minibatches}")
    dev = agent.device
    stamp = time.strftime("%Y%m%d-%H%M%S")
    out = {}
    with _cut_horizon(agent, control_steps):
        path = os.path.join(out_dir, f"{stamp}_rollout.pt.trace.json.gz")
        (env_state, dataset, _), _, wall = profiled(
            lambda: agent._rollout_phase(env_state), dev, path)
    out["rollout"] = dict(trace_summary.summarize(path, top), trace=path, wall_ms=wall * 1e3)
    rows = dataset["obs_n"].shape[0]
    mbs = agent.minibatch_size

    def update():
        perm = agent._draw_minibatch_perm()
        for i in range(minibatches):
            idx = perm[i * mbs:(i + 1) * mbs] % rows
            agent._update_minibatch(agent._gather_minibatch(dataset, idx))

    path = os.path.join(out_dir, f"{stamp}_update.pt.trace.json.gz")
    _, _, wall = profiled(update, dev, path)
    out["update"] = dict(trace_summary.summarize(path, top), trace=path, wall_ms=wall * 1e3)
    return env_state, out


def trace_epoch(agent, env_state, out_dir: str, top: int = 20):
    """One whole ``train_epoch`` traced into ``<out_dir>/<stamp>_epoch.pt.trace.json.gz``.
    Returns (env_state, {"epoch": summary})."""
    path = os.path.join(out_dir, time.strftime("%Y%m%d-%H%M%S") + "_epoch.pt.trace.json.gz")
    (env_state, _), _, wall = profiled(lambda: agent.train_epoch(env_state), agent.device,
                                       path)
    return env_state, {"epoch": dict(trace_summary.summarize(path, top), trace=path,
                                     wall_ms=wall * 1e3)}


def main(argv=None) -> dict:
    from ase_tpu_torch.utils.config import torch_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num_envs", type=int, default=4096)
    ap.add_argument("--horizon", type=int, default=32)
    ap.add_argument("--float32", action="store_true",
                    help="float32 dense layers (default: bf16, as bench.py)")
    ap.add_argument("--control-steps", type=int, default=2)
    ap.add_argument("--minibatches", type=int, default=1)
    ap.add_argument("--whole-epoch", action="store_true",
                    help="trace one whole epoch instead of the window")
    ap.add_argument("--out-dir", default="output/profile_bench")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch_device(args.device)

    agent = build_bench_agent(args.num_envs, args.horizon, not args.float32, args.device)
    t0 = time.time()
    env_state = agent.setup_training()
    for _ in range(WARMUP_EPOCHS):
        env_state, _ = agent.train_epoch(env_state)
    sync(dev)
    setup_s = time.time() - t0
    env_state, rec = agent.train_epoch(env_state)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    out = {"device": name, "num_envs": args.num_envs, "horizon": args.horizon,
           "precision": "float32" if args.float32 else "bf16", "setup_and_warmup_s": setup_s,
           "epoch_wall_s": rec["wall_s"], "rollout_s": rec["rollout_s"],
           "update_s": rec["update_s"], "env_steps_per_s": rec["env_steps_per_s"]}
    print(f"untraced epoch ({name}, {out['precision']}): wall {rec['wall_s']:.3f} s "
          f"(rollout {rec['rollout_s']:.3f} s, update {rec['update_s']:.3f} s), "
          f"{rec['env_steps_per_s']:.1f} env-steps/s; set-up and warm-up {setup_s:.1f} s",
          flush=True)
    if args.whole_epoch:
        _, traced = trace_epoch(agent, env_state, args.out_dir, args.top)
        steps = {"epoch": 1}
    else:
        _, traced = trace_window(agent, env_state, args.out_dir, args.control_steps,
                                 args.minibatches, args.top)
        steps = {"rollout": args.control_steps, "update": args.minibatches}
    for part, s in traced.items():
        unit = {"rollout": "control step", "update": "minibatch", "epoch": "epoch"}[part]
        print(f"# {s['trace']}")
        print(trace_summary.report(s, f"{part}, per {unit} (host wall "
                                      f"{s['wall_ms'] / steps[part]:.1f} ms)",
                                   steps[part], args.top), flush=True)
    out["traced"] = traced
    return out


if __name__ == "__main__":
    main()
