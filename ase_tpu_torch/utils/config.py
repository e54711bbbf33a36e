"""CLI flags + YAML config loading (port of ``ase_tpu/utils/config.py``).

The flags of the player (``--test``) and of training, with the
reference's names. ``--multi_gpu``, ``--horovod`` and ``--multi_host``
each train data-parallel in the process group torchrun starts;
``--save_video`` (with ``--test``) renders env 0's rollout to a video.
``--device`` replaces the reference's ``--rl_device``: the port
runs on ``cuda`` unless told otherwise.
"""

from __future__ import annotations

import argparse
import os
import random
from typing import Any, Dict, Tuple

import numpy as np
import torch
import yaml

from ase_tpu_torch.utils import paths


def _resolve_cfg(path: str) -> str:
    if os.path.exists(path):
        return path
    cand = paths.data_path("cfg", path)
    if os.path.exists(cand):
        return cand
    raise FileNotFoundError(f"config {path} not found")


def get_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="ase_tpu_torch runner")
    p.add_argument("--test", action="store_true", help="Run trained policy, no training")
    p.add_argument("--play", action="store_true", help="Alias for --test")
    p.add_argument("--resume", type=int, default=0,
                   help="Resume training from --checkpoint (strict: the whole train state)")
    p.add_argument("--checkpoint", type=str, default="Base", help="Checkpoint path")
    p.add_argument("--headless", action="store_true", default=True)
    p.add_argument("--horovod", action="store_true", help="(compat) same as --multi_gpu")
    p.add_argument("--multi_gpu", action="store_true",
                   help="Data-parallel training, one process per card, under torchrun "
                        "(--num_envs is the global count)")
    p.add_argument("--multi_host", action="store_true",
                   help="Same as --multi_gpu: torchrun's variables span the hosts")
    p.add_argument("--task", type=str, default="HumanoidAMP")
    p.add_argument("--cfg_env", type=str, default="humanoid_sword_shield.yaml")
    p.add_argument("--cfg_train", type=str, default="train/rlg/amp_humanoid.yaml")
    p.add_argument("--motion_file", type=str, default=None)
    p.add_argument("--num_envs", type=int, default=0)
    p.add_argument("--episode_length", type=int, default=0)
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--max_iterations", type=int, default=0)
    p.add_argument("--horizon_length", type=int, default=-1)
    p.add_argument("--minibatch_size", type=int, default=-1)
    p.add_argument("--llc_checkpoint", type=str, default="",
                   help="Low-level controller checkpoint of an HRL agent")
    p.add_argument("--output_path", type=str, default="output",
                   help="Directory of the training checkpoints")
    p.add_argument("--logdir", type=str, default="",
                   help="TensorBoard dir (default <output_path>/summaries)")
    p.add_argument("--randomize", action="store_true", help="Domain randomization")
    p.add_argument("--bench", action="store_true",
                   help="Benchmark mode: no TensorBoard writer, no checkpoint saves")
    p.add_argument("--save_video", type=str, default="",
                   help="With --test: render env 0's rollout to this mp4 (or gif) file")
    p.add_argument("--device", type=str, default="cuda",
                   help="Torch device; the port runs on the card unless 'cpu' is given")
    args = p.parse_args(argv)
    if args.play:
        args.test = True
    return args


def load_cfg(args) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    with open(_resolve_cfg(args.cfg_env), "r") as f:
        cfg = yaml.safe_load(f)
    with open(_resolve_cfg(args.cfg_train), "r") as f:
        cfg_train = yaml.safe_load(f)

    if args.num_envs > 0:
        cfg["env"]["numEnvs"] = args.num_envs
    if args.episode_length > 0:
        cfg["env"]["episodeLength"] = args.episode_length
    if args.motion_file:
        cfg["env"]["motion_file"] = args.motion_file
    cfg["name"] = args.task
    cfg["headless"] = args.headless

    if "task" in cfg:
        cfg["task"]["randomize"] = bool(
            args.randomize or cfg["task"].get("randomize", False))
    else:
        cfg["task"] = {"randomize": bool(args.randomize)}

    train_cfg = cfg_train["params"]["config"]
    train_cfg["num_actors"] = cfg["env"]["numEnvs"]
    if args.max_iterations > 0:
        train_cfg["max_epochs"] = args.max_iterations
    if args.horizon_length > -1:
        train_cfg["horizon_length"] = args.horizon_length
    if args.minibatch_size > -1:
        train_cfg["minibatch_size"] = args.minibatch_size
    if args.llc_checkpoint:
        train_cfg["llc_checkpoint"] = args.llc_checkpoint

    seed = cfg_train["params"].get("seed", -1)
    if args.seed != -1:
        seed = args.seed
    cfg_train["params"]["seed"] = set_seed(seed)
    cfg["seed"] = cfg_train["params"]["seed"]
    return cfg, cfg_train


def set_seed(seed: int) -> int:
    if seed == -1:
        seed = np.random.randint(0, 10000)
    random.seed(seed)
    np.random.seed(seed)
    return seed


def torch_device(device) -> torch.device:
    """``device`` as a torch.device, the card's checked and set to the
    reference's precision: float32 products in full float32 (no TF32),
    bfloat16 products accumulated in float32. The port runs on the card
    unless the CPU is asked for."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port runs on the card (or pass --device cpu)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev
