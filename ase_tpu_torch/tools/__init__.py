"""Offline tools: importers, retargeting, playback rendering, and the
evaluation tools (``eval_llc_skills``, ``accept_drive``,
``validate_learning``, ``validate_ase``) with the helpers they share."""

from __future__ import annotations

import os

import yaml

from ase_tpu_torch.utils import paths


def load_cfg(rel: str) -> dict:
    """A config under ``data/cfg`` (e.g. ``train/rlg/ase_humanoid.yaml``)."""
    with open(paths.data_path("cfg", rel)) as f:
        return yaml.safe_load(f)


def out_file(path: str) -> str:
    """``path`` with its directory made."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    return path
