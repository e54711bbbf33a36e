"""Data-root resolution (port of ``ase_tpu/utils/paths.py``).

Resolution order: ``ASE_TPU_DATA_ROOT`` if set, else the vendored
``<repo>/data`` directory that ``ase_tpu`` reads too.
"""

from __future__ import annotations

import os

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), *[os.pardir] * 4))


def repo_root() -> str:
    return _REPO_ROOT


def data_root() -> str:
    env = os.environ.get("ASE_TPU_DATA_ROOT")
    if env:
        return env
    return os.path.join(_REPO_ROOT, "data")


def data_path(*rel: str) -> str:
    return os.path.join(data_root(), *rel)


def asset_root() -> str:
    return data_path("assets")


def motion_file(rel: str) -> str:
    """Absolute paths pass through; otherwise look under <data>/motions,
    then <data> itself."""
    if os.path.isabs(rel) and os.path.exists(rel):
        return rel
    for cand in (rel, data_path("motions", rel), data_path(rel)):
        if os.path.exists(cand):
            return cand
    raise FileNotFoundError(
        f"motion file {rel!r} not found (data root: {data_root()}; "
        "set ASE_TPU_DATA_ROOT to point at a data directory)")


DATASET_YAML = "reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"
IDLE_CLIP = "reallusion_sword_shield/RL_Avatar_Idle_Ready_Motion.npy"


def default_dataset() -> str:
    return motion_file(DATASET_YAML)


def default_clip() -> str:
    return motion_file(IDLE_CLIP)

