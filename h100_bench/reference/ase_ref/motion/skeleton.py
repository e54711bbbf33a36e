"""Skeleton trees, forward kinematics on tensors and host-side numpy
kinematics for the motion loader and the mocap tools (port of
``ase_tpu/motion/skeleton.py``).

The on-disk ``.npy`` format is the reference ``Serializable`` dict layout,
so the vendored ASE motion assets load unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from h100_bench.reference.ase_ref.ops import quat as rot


@dataclasses.dataclass(frozen=True)
class SkeletonTree:
    """Static skeleton description (host-side; hashable for jit closures)."""

    node_names: Tuple[str, ...]
    parent_indices: Tuple[int, ...]
    local_translation: np.ndarray  # (J, 3) float32

    @property
    def num_joints(self) -> int:
        return len(self.node_names)

    def index(self, name: str) -> int:
        return self.node_names.index(name)

    @staticmethod
    def from_dict(d: dict) -> "SkeletonTree":
        names = tuple(d["node_names"])
        parents = tuple(int(i) for i in np.asarray(d["parent_indices"]["arr"]))
        local_t = np.asarray(d["local_translation"]["arr"], dtype=np.float32)
        return SkeletonTree(names, parents, local_t)

    def to_dict(self) -> dict:
        return {
            "node_names": list(self.node_names),
            "parent_indices": {
                "arr": np.asarray(self.parent_indices, dtype=np.int64),
                "context": {"dtype": "int64"},
            },
            "local_translation": {
                "arr": np.asarray(self.local_translation, dtype=np.float32),
                "context": {"dtype": "float32"},
            },
            "__name__": "SkeletonTree",
        }

    def keep_nodes(self, names: Sequence[str]) -> Tuple["SkeletonTree", np.ndarray]:
        """Subtree restricted to `names` (must be closed under new parenting).

        Returns (new_tree, index_map) where index_map[i] is the old index of
        new node i. Local translations are re-chained through dropped nodes
        (reference skeleton3d.py:212-259 semantics).
        """
        keep = [self.index(n) for n in names]
        keep_set = set(keep)
        new_parent = []
        new_local = []
        for old in keep:
            p = self.parent_indices[old]
            offset = self.local_translation[old].copy()
            while p != -1 and p not in keep_set:
                offset = offset + self.local_translation[p]
                p = self.parent_indices[p]
            new_parent.append(-1 if p == -1 else keep.index(p))
            new_local.append(offset)
        tree = SkeletonTree(tuple(names), tuple(new_parent), np.stack(new_local))
        return tree, np.asarray(keep)


def fk(
    tree: SkeletonTree,
    local_rotation: torch.Tensor,
    root_translation: torch.Tensor,
    local_translation: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kinematics on the inputs' device.

    local_rotation: (..., J, 4) xyzw, root_translation: (..., 3).
    Returns (global_rotation (..., J, 4), global_translation (..., J, 3)):
    a child's global rotation is its parent's times its local one, its
    position the parent's plus the parent-rotated local offset.
    """
    if local_translation is None:
        local_translation = torch.as_tensor(tree.local_translation,
                                            device=local_rotation.device)
    grs, gts = [], []
    for j in range(tree.num_joints):
        p = tree.parent_indices[j]
        lr = local_rotation[..., j, :]
        if p == -1:
            grs.append(lr)
            gts.append(root_translation)
        else:
            grs.append(rot.quat_mul(grs[p], lr))
            gts.append(gts[p] + rot.quat_rotate(grs[p], local_translation[..., j, :]))
    return torch.stack(grs, dim=-2), torch.stack(gts, dim=-2)


def global_to_local(tree: SkeletonTree, global_rotation: torch.Tensor) -> torch.Tensor:
    """Inverse of the rotation part of ``fk``."""
    lrs = []
    for j in range(tree.num_joints):
        p = tree.parent_indices[j]
        gr = global_rotation[..., j, :]
        if p == -1:
            lrs.append(gr)
        else:
            lrs.append(rot.quat_mul(rot.quat_conjugate(global_rotation[..., p, :]), gr))
    return torch.stack(lrs, dim=-2)


def np_global_to_local(tree: SkeletonTree, global_rotation: np.ndarray) -> np.ndarray:
    """Inverse of the rotation part of FK (numpy)."""
    lrs = []
    for j in range(tree.num_joints):
        p = tree.parent_indices[j]
        gr = global_rotation[..., j, :]
        if p == -1:
            lrs.append(gr)
        else:
            lrs.append(_np_quat_mul(_np_quat_conj(global_rotation[..., p, :]), gr))
    return np.stack(lrs, axis=-2)


def compute_velocities(
    global_translation: np.ndarray,
    global_rotation: np.ndarray,
    fps: float,
    gaussian_sigma: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Finite-difference linear/angular velocities with Gaussian smoothing.

    Host-side numpy (offline preprocessing), matching the reference's
    filtered-difference estimator (skeleton3d.py:1222-1246; scipy
    gaussian_filter1d replaced by an explicit truncated Gaussian conv).
    """
    dt = 1.0 / fps
    T = global_translation.shape[0]

    lin = np.empty_like(global_translation)
    lin[:-1] = (global_translation[1:] - global_translation[:-1]) / dt
    lin[-1] = lin[-2] if T > 1 else 0.0

    q0 = global_rotation[:-1]
    q1 = global_rotation[1:]
    dq = _np_quat_mul(q1, _np_quat_conj(q0))
    angle, axis = _np_quat_to_angle_axis(dq)
    ang = np.empty(global_rotation.shape[:-1] + (3,), dtype=np.float32)
    ang[:-1] = (axis * angle[..., None]) / dt
    ang[-1] = ang[-2] if T > 1 else 0.0

    if gaussian_sigma > 0 and T > 1:
        lin = _gaussian_filter1d(lin, gaussian_sigma, axis=0)
        ang = _gaussian_filter1d(ang, gaussian_sigma, axis=0)
    return lin.astype(np.float32), ang.astype(np.float32)


# --- small numpy helpers (loader-side; no torch/scipy dependency) ---------

def np_fk(tree: SkeletonTree, local_rotation: np.ndarray, root_translation: np.ndarray):
    """Host-side numpy FK (loader path; avoids per-clip-length jit recompiles)."""
    J = tree.num_joints
    grs = [None] * J
    gts = [None] * J
    lt = tree.local_translation
    for j in range(J):
        p = tree.parent_indices[j]
        lr = local_rotation[..., j, :]
        if p == -1:
            grs[j] = lr
            gts[j] = root_translation
        else:
            grs[j] = _np_quat_mul(grs[p], lr)
            gts[j] = gts[p] + _np_quat_rotate(grs[p], lt[j])
    return np.stack(grs, axis=-2), np.stack(gts, axis=-2)


def _np_quat_rotate(q, v):
    qvec = q[..., 0:3]
    w = q[..., 3:4]
    v = np.broadcast_to(v, qvec.shape)
    t = 2.0 * np.cross(qvec, v)
    return v + w * t + np.cross(qvec, t)


def _np_quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def _np_quat_conj(q):
    return np.concatenate([-q[..., 0:3], q[..., 3:4]], axis=-1)


def _np_quat_to_angle_axis(q):
    w = np.clip(q[..., 3], -1.0, 1.0)
    sin_theta = np.sqrt(np.maximum(1.0 - w * w, 0.0))
    angle = 2.0 * np.arccos(w)
    angle = np.arctan2(np.sin(angle), np.cos(angle))
    safe = np.where(sin_theta > 1e-5, sin_theta, 1.0)
    axis = q[..., 0:3] / safe[..., None]
    default = np.zeros_like(axis)
    default[..., 2] = 1.0
    mask = sin_theta > 1e-5
    return np.where(mask, angle, 0.0), np.where(mask[..., None], axis, default)


def _gaussian_filter1d(x, sigma, axis=0):
    radius = int(4.0 * sigma + 0.5)
    t = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k = k / k.sum()
    x = np.moveaxis(x, axis, 0)
    pad = [(radius, radius)] + [(0, 0)] * (x.ndim - 1)
    xp = np.pad(x, pad, mode="edge")
    out = np.zeros_like(x)
    for i, w in enumerate(k):
        out += w * xp[i : i + x.shape[0]]
    return np.moveaxis(out, 0, axis)
