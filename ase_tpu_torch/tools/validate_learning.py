"""Learning validation (port of ``scripts/validate_learning.py``): AMP
imitation of one clip must show the reference's qualitative curves, the
discriminator reward moving as the policy meets the motion's manifold and
the episodes lengthening as it stops falling (AMP, Peng et al. 2021).

Trains a fresh AMP agent (``amp_humanoid.yaml`` on
``humanoid_sword_shield.yaml``, the idle clip by default) for ``--epochs``
epochs at ``--num-envs`` envs and writes a markdown table of the curve to
``--out`` (``output/VALIDATION.md`` by default) and the whole history to
``validation_history.json`` beside it:

  python -m ase_tpu_torch.tools.validate_learning [--epochs 300] [--num-envs 1024] \\
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from ase_tpu_torch.tools import load_cfg, out_file
from ase_tpu_torch.utils import paths
from ase_tpu_torch.utils.config import torch_device

PICKS = (0, 10, 25, 50, 100, 150, 200, 250)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def train_curve(agent, epochs: int, env_state=None, every: int = 10, keys=(),
                on_epoch=None):
    """``epochs`` epochs of ``agent`` from ``env_state`` (set up when None),
    printing ``keys`` every ``every`` epochs and at the last, and calling
    ``on_epoch(epoch, history)`` after each. Returns (env state, history:
    one dict of scalar metrics per epoch with its ``epoch`` and ``fps``)."""
    if env_state is None:
        env_state = agent.setup_training()
    history = []
    for epoch in range(epochs):
        env_state, rec = agent.train_epoch(env_state)
        m = dict(rec["metrics"], epoch=epoch, fps=rec["env_steps_per_s"])
        history.append(m)
        if epoch % every == 0 or epoch == epochs - 1:
            msg = " ".join(f"{k} {m.get(k, float('nan')):.4f}" for k in keys)
            print(f"epoch {epoch} fps {m['fps']:.0f} {msg}", flush=True)
        if on_epoch is not None:
            on_epoch(epoch, history)
    return env_state, history


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--num-envs", type=int, default=1024)
    p.add_argument("--task", default="HumanoidAMP")
    p.add_argument("--motion", default=paths.default_clip())
    p.add_argument("--out", default="output/VALIDATION.md")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    dev = torch_device(args.device)

    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.learning.amp_agent import AMPAgent

    cfg = load_cfg("humanoid_sword_shield.yaml")
    cfg["env"]["numEnvs"] = args.num_envs
    cfg["env"]["motion_file"] = args.motion
    cfg_train = load_cfg("train/rlg/amp_humanoid.yaml")
    c = cfg_train["params"]["config"]
    c["minibatch_size"] = min(16384, args.num_envs * c["horizon_length"] // 2)
    c["save_frequency"] = 0
    agent = AMPAgent(parse_task(args.task, cfg, device=dev), cfg_train,
                     output_dir=os.path.dirname(args.out) or ".")

    t_start = time.time()
    _, history = train_curve(agent, args.epochs, keys=(
        "disc_agent_acc", "reward_mean", "game_length_mean", "kl"))
    wall = time.time() - t_start

    def row(e):
        h = history[e]
        return (f"| {e} | {h['reward_mean']:.3f} | {h['disc_agent_acc']:.3f} | "
                f"{h['disc_demo_acc']:.3f} | {h['game_length_mean']:.1f} | {h['kl']:.4f} |")

    picks = [e for e in PICKS + (args.epochs - 1,) if e < len(history)]
    with open(out_file(args.out), "w") as f:
        f.write("# Learning validation: AMP single-clip imitation\n\n")
        f.write(f"Task: {args.task}, {args.num_envs} envs, clip: "
                f"`{os.path.basename(args.motion)}`, {args.epochs} epochs "
                f"({args.epochs * agent.batch_size:,} env-steps) in {wall:.0f}s "
                f"on {device_name(dev)}.\n\n")
        f.write("Reference qualitative behavior (AMP, Peng et al. 2021): the\n"
                "style (discriminator) reward moves as the policy matches the\n"
                "motion manifold, and episode lengths grow as it stops falling.\n\n")
        f.write("| epoch | disc reward (mean) | disc agent acc | disc demo acc | "
                "episode len | policy KL |\n|---|---|---|---|---|---|\n")
        for e in sorted(set(picks)):
            f.write(row(e) + "\n")
        f.write("\nFull history: validation_history.json\n")
    with open(os.path.join(os.path.dirname(args.out) or ".", "validation_history.json"), "w") as f:
        json.dump(history, f)
    print(f"wrote {args.out}")
    return history


if __name__ == "__main__":
    main()
