"""Benchmark of the PyTorch / CUDA port: ASE training env-steps/s on one card.

    python3 bench_torch.py [--epochs 5] [--num_envs 4096] [--horizon 32]

The workload of bench.py: HumanoidAMPGetup on the sword-shield humanoid,
the 87-clip Reallusion dataset, self-collision on, 4096 envs, horizon 32,
minibatch min(16384, envs x horizon), resetChunk 512, and the ASEAgent's
full PPO + AMP + ASE update at the shipped widths, built by
``ase_tpu_torch.tools.profile_epoch.build_bench_agent`` through the
training CLI's ``build_agent``, once
in float32 (the shipped ``mixed_precision: false``, TF32 off) and once
under mixed precision (``mixed_precision: true``, bench.py's default:
bfloat16 products accumulated in float32), with the same seed and epochs,
so the two are compared on one host. For each: after the train state, the
fall-state drop (made once, for the first agent) and one warm-up epoch, N
epochs are timed on the host clock, ending in a device sync.

Prints one JSON line: the float32 env-steps/s as ``value`` and both
precisions' env-steps/s with their mean rollout / update split, their
ratio, the unit, and the card's name and power limit (as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them). There is
no ``vs_baseline``: the TPU baseline of bench.py does not describe this
card. Needs the card.
"""

import argparse
import json
import subprocess
import time

import torch

from ase_tpu_torch.tools.profile_epoch import build_bench_agent


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=32)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch.py measures the card: torch.cuda.is_available() is false")

    runs, fall_states = {}, None
    for mixed in (False, True):
        runs["bf16" if mixed else "float32"], fall_states = _run(args, mixed, fall_states)
        torch.cuda.empty_cache()

    name, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].split(", ")
    print(json.dumps({
        "metric": "ase_train_env_steps_per_sec",
        "value": runs["float32"]["env_steps_per_s"],
        "unit": f"env-steps/s (full ASE train epoch, {args.num_envs} envs, horizon "
                f"{args.horizon}, one card)",
        "name": name.strip(), "power.limit": power.strip(), "epochs": args.epochs,
        "float32": runs["float32"], "bf16": runs["bf16"],
        "bf16_over_float32": runs["bf16"]["env_steps_per_s"] / runs["float32"]["env_steps_per_s"],
    }))


def _run(args, mixed: bool, fall_states):
    """Train a fresh agent of the given precision: set-up, one warm-up
    epoch, then ``args.epochs`` timed epochs. Returns (its numbers, the
    fall states, for the next agent's env)."""
    agent = build_bench_agent(args.num_envs, args.horizon, mixed)
    if fall_states is not None:
        agent.env._fall_states = fall_states     # env construction, the same for both runs
    t0 = time.time()
    env_state = agent.setup_training()
    env_state, _ = agent.train_epoch(env_state)          # warm-up
    setup_s = time.time() - t0

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    rollout_s = update_s = 0.0
    for _ in range(args.epochs):
        env_state, rec = agent.train_epoch(env_state)
        rollout_s += rec["rollout_s"]
        update_s += rec["update_s"]
    torch.cuda.synchronize()
    wall = time.time() - t0
    steps = args.epochs * args.horizon * args.num_envs
    return {"mixed_precision": mixed, "env_steps_per_s": steps / wall,
            "rollout_s_per_epoch": rollout_s / args.epochs,
            "update_s_per_epoch": update_s / args.epochs, "setup_and_warmup_s": setup_s,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}, agent.env._fall_states


if __name__ == "__main__":
    main()
