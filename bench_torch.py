"""Benchmark of the PyTorch / CUDA port: ASE training env-steps/s on one card.

    python3 bench_torch.py [--epochs 5] [--num_envs 4096] [--horizon 32]

The workload of bench.py: HumanoidAMPGetup on the sword-shield humanoid,
the 87-clip Reallusion dataset, self-collision on, 4096 envs, horizon 32,
minibatch min(16384, envs x horizon), resetChunk 512, and the ASEAgent's
full PPO + AMP + ASE update at the shipped widths, float32
(``mixed_precision: false``, TF32 off), built by ``ase_tpu_torch.run``'s
``build_agent`` as the training CLI builds it. After the train state, the
fall-state drop and one warm-up epoch, N epochs are timed on the host
clock, ending in a device sync.

Prints one JSON line: env-steps/s on the card, its unit, the card's name and
power limit (as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` gives them), ``mixed_precision``, and the mean
rollout / update split. There is no ``vs_baseline``: the TPU baseline of
bench.py does not describe this card. Needs the card.
"""

import argparse
import json
import subprocess
import time

import torch

# the agent the training CLI builds (chip_smoke.py's train phase passes the
# same flags); bench.py's self-collision and resetChunk 512 are the shipped
# env config's own, and are checked, not set
ARGV = [
    "--task", "HumanoidAMPGetup",
    "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", "data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml",
    "--seed", "0",
]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=5)
    p.add_argument("--num_envs", type=int, default=4096)
    p.add_argument("--horizon", type=int, default=32)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_torch.py measures the card: torch.cuda.is_available() is false")

    from ase_tpu_torch import run

    agent, _, _ = run.build_agent(ARGV + [
        "--num_envs", str(args.num_envs), "--horizon_length", str(args.horizon),
        "--minibatch_size", str(min(16384, args.num_envs * args.horizon))])
    mixed = agent.cfg_train["params"]["config"].get("mixed_precision", False)
    if not (agent.env.sim_cfg.enable_self_collision and agent.env.reset_chunk == 512 and not mixed):
        raise SystemExit("bench_torch.py runs bench.py's workload: self-collision on, "
                         "resetChunk 512, mixed_precision false")
    t0 = time.time()
    env_state = agent.setup_training()
    env_state, _ = agent.train_epoch(env_state)          # warm-up
    setup_s = time.time() - t0

    torch.cuda.synchronize()
    t0 = time.time()
    rollout_s = update_s = 0.0
    for _ in range(args.epochs):
        env_state, rec = agent.train_epoch(env_state)
        rollout_s += rec["rollout_s"]
        update_s += rec["update_s"]
    torch.cuda.synchronize()
    wall = time.time() - t0

    name, power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].split(", ")
    steps = args.epochs * args.horizon * args.num_envs
    print(json.dumps({
        "metric": "ase_train_env_steps_per_sec",
        "value": steps / wall,
        "unit": f"env-steps/s (full ASE train epoch, {args.num_envs} envs, horizon "
                f"{args.horizon}, one card)",
        "name": name.strip(), "power.limit": power.strip(),
        "mixed_precision": mixed, "epochs": args.epochs,
        "rollout_s_per_epoch": rollout_s / args.epochs, "update_s_per_epoch": update_s / args.epochs,
        "setup_and_warmup_s": setup_s,
    }))


if __name__ == "__main__":
    main()
