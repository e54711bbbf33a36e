"""CLI entry point (port of ``ase_tpu/run.py``).

Trains an AMP, ASE or HRL agent on the card, writing checkpoints
(``{name}.ckpt.npz``, ``name`` from the train config) under
``--output_path`` and TensorBoard scalars under ``--logdir``:

  python -m ase_tpu_torch.run --task HumanoidAMPGetup \\
      --cfg_env humanoid_ase_sword_shield_getup.yaml \\
      --cfg_train train/rlg/ase_humanoid.yaml \\
      --motion_file data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml \\
      --max_iterations 2

``--resume 1 --checkpoint output/Humanoid.ckpt.npz`` continues such a run
(or one of ``ase_tpu``'s) at its epoch. With ``--test`` it plays a
checkpoint instead, e.g. the shipped heading controller over the shipped
low-level controller:

  python -m ase_tpu_torch.run --test --task HumanoidHeading \\
      --cfg_env humanoid_sword_shield_heading.yaml \\
      --cfg_train train/rlg/hrl_humanoid.yaml \\
      --motion_file data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml \\
      --llc_checkpoint data/models/ase_llc_reallusion_sword_shield.ckpt.npz \\
      --checkpoint data/models/ase_hlc_heading_reallusion_sword_shield.ckpt.npz

A high-level controller trains over the shipped low-level controller the
same way, e.g. on the strike task (``--test --checkpoint
data/models/ase_hlc_strike_reallusion_sword_shield.ckpt.npz`` plays the
shipped one):

  python -m ase_tpu_torch.run --task HumanoidStrike \
      --cfg_env humanoid_sword_shield_strike.yaml \
      --cfg_train train/rlg/hrl_humanoid.yaml \
      --motion_file data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml \
      --llc_checkpoint data/models/ase_llc_reallusion_sword_shield.ckpt.npz

The view-motion task plays the motion data back kinematically through
the env (the check of a dataset; the policy's actions are ignored):

  python -m ase_tpu_torch.run --test --task HumanoidViewMotion \
      --cfg_env humanoid_ase_sword_shield.yaml \
      --cfg_train train/rlg/ase_humanoid.yaml \
      --motion_file data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml \
      --checkpoint data/models/ase_llc_reallusion_sword_shield.ckpt.npz

A train config with ``mixed_precision: true`` trains in bfloat16 (float32
master weights and heads), and ``--randomize`` with an env config's
``task.randomization_params`` block trains under domain randomization. An
env config's ``solverScheme: pgs`` solves contacts by sequential
Gauss-Seidel instead of block-Jacobi, and ``pdControl: false`` drives the
joints by torque; a train config's ``network.enc.separate: true`` gives
the ASE encoder an MLP of its own.
``--multi_gpu`` (or ``--horovod``, ``--multi_host``) trains data-parallel,
one process per card, each stepping its share of ``numEnvs``:

  torchrun --nproc_per_node=<cards> -m ase_tpu_torch.run --multi_gpu ...

(with ``--device cpu``, on gloo). ``--test`` ignores those flags.
``--test --save_video rollout.mp4`` also renders env 0's rollout to that
file (mp4 through OpenCV, else a gif through PIL; matplotlib draws the
frames). Without a card the command raises unless ``--device cpu`` is
given.
"""

from __future__ import annotations

import os
from typing import Optional

import torch


def build_alg_runner():
    """The algo and player registries."""
    from ase_tpu_torch.learning.amp_agent import AMPAgent
    from ase_tpu_torch.learning.ase_agent import ASEAgent
    from ase_tpu_torch.learning.hrl_agent import HRLAgent
    from ase_tpu_torch.learning.players import PLAYER_REGISTRY

    return {"amp": AMPAgent, "ase": ASEAgent, "hrl": HRLAgent}, PLAYER_REGISTRY


def build_agent(argv=None, edit_cfg=None, mesh=None):
    """Parse ``argv``, build the env and the agent of the config's algo.
    ``edit_cfg(cfg, cfg_train)``, if given, may change the loaded configs
    in place first (as a yaml of one's own would). Training under
    ``--multi_gpu`` joins the process group (``parallel.mesh.init``)
    unless a caller passes its ``mesh``; the rank's env takes its share of
    ``numEnvs``. Returns (agent, args, cfg)."""
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.utils import config as cfg_util

    args = cfg_util.get_args(argv)
    if args.test:
        mesh = None
    elif mesh is None and (args.multi_gpu or args.horovod or args.multi_host):
        from ase_tpu_torch.parallel import mesh as mesh_lib

        mesh = mesh_lib.init(device=args.device)
    device = cfg_util.torch_device(mesh.device if mesh is not None else args.device)
    cfg, cfg_train = cfg_util.load_cfg(args)
    if edit_cfg is not None:
        edit_cfg(cfg, cfg_train)
    algo = cfg_train["params"]["algo"]["name"]
    algos, _ = build_alg_runner()
    if algo not in algos:
        raise NotImplementedError(f"algo {algo!r} is not ported yet")
    if mesh is not None:
        num_envs = int(cfg["env"]["numEnvs"])
        if num_envs % mesh.world:
            raise ValueError(f"numEnvs {num_envs} does not divide over {mesh.world} ranks")
        cfg["env"]["numEnvs"] = num_envs // mesh.world
        # a config's seed -1 draws one per process: the run takes rank 0's
        seed = int(mesh.broadcast(torch.tensor(cfg_train["params"]["seed"], device=device)))
        cfg_train["params"]["seed"] = cfg["seed"] = cfg_util.set_seed(seed)
    env = parse_task(args.task, cfg, device=device)
    return algos[algo](env, cfg_train, output_dir=args.output_path, mesh=mesh), args, cfg


def build_player(argv=None, edit_cfg=None):
    """Parse ``argv`` (with ``--test``), build the env, agent and player
    (``edit_cfg`` as in ``build_agent``), and restore the checkpoint.
    Returns (player, cfg)."""
    agent, args, cfg = build_agent(argv, edit_cfg=edit_cfg)
    if not args.test:
        raise ValueError("build_player needs --test")
    _, players = build_alg_runner()
    algo = agent.cfg_train["params"]["algo"]["name"]
    player = players.get(algo, players["common"])(agent)
    player.restore(args.checkpoint)
    return player, cfg


def make_writer(logdir: str):
    """A TensorBoard ``SummaryWriter`` on ``logdir``, or None (with one
    printed line) when ``tensorboard`` does not import."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        print("tensorboard does not import: no summaries are written", flush=True)
        return None
    return SummaryWriter(logdir)


def main(argv=None, num_steps: Optional[int] = None, max_chunks: int = 100):
    """Train (the default) or, with ``--test``, play."""
    from ase_tpu_torch.utils import config as cfg_util

    args = cfg_util.get_args(argv)
    if args.test:
        player, cfg = build_player(argv)
        return player.run(num_steps=num_steps or cfg["env"]["episodeLength"],
                          max_chunks=max_chunks, video_path=args.save_video or None)
    agent, args, _ = build_agent(argv)
    writer = None
    if args.bench:    # training throughput only: no writer, no periodic saves
        agent.save_frequency = 0
    elif agent.rank == 0:
        writer = make_writer(args.logdir or os.path.join(args.output_path, "summaries"))
    restore_path = None
    if args.resume and args.checkpoint not in ("", "Base"):
        restore_path = args.checkpoint
    try:
        return agent.train(writer=writer, restore_path=restore_path)
    finally:
        if writer is not None:
            writer.close()
        if agent.mesh is not None:
            agent.mesh.close()


if __name__ == "__main__":
    main()
