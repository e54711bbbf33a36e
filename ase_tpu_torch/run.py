"""CLI entry point (port of ``ase_tpu/run.py``).

Trains an AMP or ASE agent on the card:

  python -m ase_tpu_torch.run --task HumanoidAMPGetup \\
      --cfg_env humanoid_ase_sword_shield_getup.yaml \\
      --cfg_train train/rlg/ase_humanoid.yaml \\
      --motion_file data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml \\
      --max_iterations 2

or, with ``--test``, plays a shipped checkpoint:

  python -m ase_tpu_torch.run --test --task HumanoidAMPGetup \\
      --cfg_env humanoid_ase_sword_shield_getup.yaml \\
      --cfg_train train/rlg/ase_humanoid.yaml \\
      --motion_file data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml \\
      --checkpoint data/models/ase_llc_reallusion_sword_shield.ckpt.npz

Training writes no checkpoint yet: saving and ``--resume`` come with a later
slice, as do ``--multi_gpu`` / ``--horovod``; those flags raise. Without a
card the command raises unless ``--device cpu`` is given.
"""

from __future__ import annotations

from typing import Optional

import torch


def _algos():
    from ase_tpu_torch.learning.amp_agent import AMPAgent
    from ase_tpu_torch.learning.ase_agent import ASEAgent

    return {"amp": AMPAgent, "ase": ASEAgent}


def build_agent(argv=None):
    """Parse ``argv``, build the env and the agent of the config's algo.
    Returns (agent, args, cfg)."""
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.utils import config as cfg_util

    args = cfg_util.get_args(argv)
    if not args.test:
        if args.resume:
            raise NotImplementedError("--resume: checkpoint save and resume are not ported yet "
                                      "(ROADMAP.md, queue 1: checkpoint save/resume)")
        if args.multi_gpu or args.horovod:
            raise NotImplementedError("--multi_gpu / --horovod: multi-GPU training is not "
                                      "ported yet (ROADMAP.md, queue 1: multi-GPU)")
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card (or pass --device cpu)")
        # the reference pins float32 products to full precision
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, cfg_train = cfg_util.load_cfg(args)
    algo = cfg_train["params"]["algo"]["name"]
    algos = _algos()
    if algo not in algos:
        raise NotImplementedError(f"algo {algo!r} is not ported yet")
    env = parse_task(args.task, cfg, device=device)
    return algos[algo](env, cfg_train), args, cfg


def build_player(argv=None):
    """Parse ``argv`` (with ``--test``), build the env, agent and player,
    and restore the checkpoint. Returns (player, cfg)."""
    from ase_tpu_torch.learning.players import PLAYER_REGISTRY

    agent, args, cfg = build_agent(argv)
    if not args.test:
        raise ValueError("build_player needs --test")
    algo = agent.cfg_train["params"]["algo"]["name"]
    if algo not in PLAYER_REGISTRY:
        raise NotImplementedError(f"no player for algo {algo!r} yet")
    player = PLAYER_REGISTRY[algo](agent)
    player.restore(args.checkpoint)
    return player, cfg


def main(argv=None, num_steps: Optional[int] = None, max_chunks: int = 100):
    """Train (the default) or, with ``--test``, play."""
    from ase_tpu_torch.utils import config as cfg_util

    if cfg_util.get_args(argv).test:
        player, cfg = build_player(argv)
        return player.run(num_steps=num_steps or cfg["env"]["episodeLength"],
                          max_chunks=max_chunks)
    agent, _, _ = build_agent(argv)
    return agent.train()


if __name__ == "__main__":
    main()
