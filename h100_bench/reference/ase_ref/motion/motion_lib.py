"""Device-resident motion library (port of ``ase_tpu/motion/motion_lib.py``).

All clips are concatenated into flat frame-major tensors once at load time;
``get_motion_state`` blends two packed frame rows per query (the
reference's default packed path). Clips are read with numpy from the
``.npy`` files at every load (the frozen copy keeps no cache). Randomness
comes from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import yaml

from h100_bench.reference.ase_ref.motion import skeleton as sk
from h100_bench.reference.ase_ref.ops import quat as rot

_CACHE_FIELDS = ("gts", "grs", "lrs", "gvs", "gavs", "dvs",
                 "length_starts", "lengths", "num_frames", "dt", "weights")


@dataclasses.dataclass(frozen=True)
class MotionLib:
    gts: torch.Tensor           # (F, J, 3) global body translations
    grs: torch.Tensor           # (F, J, 4) global body rotations
    gvs: torch.Tensor           # (F, J, 3)
    gavs: torch.Tensor          # (F, J, 3)
    lengths: torch.Tensor       # (M,) seconds
    weights: torch.Tensor       # (M,) normalized sampling weights
    key_body_ids: torch.Tensor  # (K,)
    packed: torch.Tensor        # (F, Dp) [root_pos|root_rot|lrs|root_vel|root_ang_vel|dvs|key_pos]
    meta: torch.Tensor          # (M, 4) [length, num_frames, dt, length_start]
    dof_body_ids: Tuple[int, ...]
    dof_offsets: Tuple[int, ...]
    num_joints: int

    @property
    def num_dof(self) -> int:
        return self.dof_offsets[-1]

    @property
    def num_motions(self) -> int:
        return int(self.weights.shape[0])


def sample_motions(lib: MotionLib, gen: torch.Generator, n: int) -> torch.Tensor:
    """Weighted clip sampling."""
    return torch.multinomial(lib.weights, n, replacement=True, generator=gen)


def sample_time(lib: MotionLib, phase: torch.Tensor, motion_ids: torch.Tensor,
                truncate_time: float = 0.0) -> torch.Tensor:
    """Times for uniform ``phase`` in [0, 1) over the (truncated) clip."""
    return phase * (lib.lengths[motion_ids] - truncate_time)


def _calc_frame_blend(time, length, num_frames, dt):
    phase = torch.clamp(time / torch.clamp(length, min=1e-6), 0.0, 1.0)
    idx0 = (phase * (num_frames - 1).to(phase.dtype)).to(torch.long)
    idx1 = torch.minimum(idx0 + 1, num_frames - 1)
    blend = (time - idx0.to(phase.dtype) * dt) / dt
    return idx0, idx1, blend


def local_rotation_to_dof(lib: MotionLib, local_rot: torch.Tensor) -> torch.Tensor:
    """(..., J, 4) local rotations -> (..., D) dof positions."""
    pieces = []
    for j, body_id in enumerate(lib.dof_body_ids):
        size = lib.dof_offsets[j + 1] - lib.dof_offsets[j]
        q = local_rot[..., body_id, :]
        if size == 3:
            pieces.append(rot.quat_to_exp_map(q))
        elif size == 1:
            angle, axis = rot.quat_to_angle_axis(q)
            pieces.append(rot.normalize_angle(angle * axis[..., 1])[..., None])
        else:
            raise ValueError(f"unsupported joint size {size}")
    return torch.cat(pieces, dim=-1)


def _packed_offsets(lib: MotionLib):
    J, D = lib.num_joints, lib.num_dof
    o_rot = 3
    o_lrs = o_rot + 4
    o_vel = o_lrs + 4 * J
    o_avel = o_vel + 3
    o_dvs = o_avel + 3
    o_key = o_dvs + D
    return o_rot, o_lrs, o_vel, o_avel, o_dvs, o_key


def get_motion_state(lib: MotionLib, motion_ids: torch.Tensor, motion_times: torch.Tensor):
    """Blended kinematic state at arbitrary times (``_get_motion_state_packed``,
    ``motion_lib.py:186``): root_pos, root_rot, dof_pos, root_vel,
    root_ang_vel, dof_vel, key_pos."""
    meta = lib.meta[motion_ids]
    length = meta[..., 0]
    nf = meta[..., 1].to(torch.long)
    dt = meta[..., 2]
    starts = meta[..., 3].to(torch.long)

    idx0, idx1, blend = _calc_frame_blend(motion_times, length, nf, dt)
    p0 = lib.packed[idx0 + starts]
    p1 = lib.packed[idx1 + starts]
    b = blend[..., None]

    o_rot, o_lrs, o_vel, o_avel, o_dvs, o_key = _packed_offsets(lib)
    J = lib.num_joints
    K = int(lib.key_body_ids.shape[0])
    lead = tuple(p0.shape[:-1])

    root_pos = (1.0 - b) * p0[..., :o_rot] + b * p1[..., :o_rot]
    root_rot = rot.slerp(p0[..., o_rot:o_lrs], p1[..., o_rot:o_lrs], b)
    lr0 = p0[..., o_lrs:o_vel].reshape(lead + (J, 4))
    lr1 = p1[..., o_lrs:o_vel].reshape(lead + (J, 4))
    dof_pos = local_rotation_to_dof(lib, rot.slerp(lr0, lr1, b[..., None]))
    key0 = p0[..., o_key:o_key + 3 * K].reshape(lead + (K, 3))
    key1 = p1[..., o_key:o_key + 3 * K].reshape(lead + (K, 3))
    key_pos = (1.0 - b[..., None]) * key0 + b[..., None] * key1
    return {
        "root_pos": root_pos,
        "root_rot": root_rot,
        "dof_pos": dof_pos,
        "root_vel": p0[..., o_vel:o_avel],
        "root_ang_vel": p0[..., o_avel:o_dvs],
        "dof_vel": p0[..., o_dvs:o_key],
        "key_pos": key_pos,
    }


def get_body_state(lib: MotionLib, motion_ids: torch.Tensor, motion_times: torch.Tensor):
    """Full per-body kinematic state (view-motion playback)."""
    meta = lib.meta[motion_ids]
    idx0, idx1, blend = _calc_frame_blend(
        motion_times, meta[..., 0], meta[..., 1].to(torch.long), meta[..., 2])
    starts = meta[..., 3].to(torch.long)
    f0, f1 = idx0 + starts, idx1 + starts
    b = blend[..., None, None]
    body_pos = (1.0 - b) * lib.gts[f0] + b * lib.gts[f1]
    body_rot = rot.slerp(lib.grs[f0], lib.grs[f1], b)
    return body_pos, body_rot, lib.gvs[f0], lib.gavs[f0]


# -- loading (host side, once) ------------------------------------------------

def _fetch_motion_files(motion_file: str):
    """Single clip or weighted .yaml dataset."""
    if os.path.splitext(motion_file)[1] == ".yaml":
        dir_name = os.path.dirname(motion_file)
        with open(motion_file, "r") as f:
            cfg = yaml.safe_load(f)
        files, weights = [], []
        for entry in cfg["motions"]:
            w = float(entry["weight"])
            if w < 0:
                raise ValueError(f"negative motion weight in {motion_file}")
            files.append(os.path.join(dir_name, entry["file"]))
            weights.append(w)
        return files, weights
    return [motion_file], [1.0]


def _np_local_to_dof_vel(lr0, lr1, dt, dof_body_ids, dof_offsets, num_dof):
    diff = sk._np_quat_mul(sk._np_quat_conj(lr0), lr1)
    diff = diff / np.maximum(np.linalg.norm(diff, axis=-1, keepdims=True), 1e-12)
    angle, axis = sk._np_quat_to_angle_axis(diff)
    local_vel = axis * angle[..., None] / dt
    dof_vel = np.zeros((lr0.shape[0], num_dof), dtype=np.float32)
    for j, body_id in enumerate(dof_body_ids):
        off = dof_offsets[j]
        if dof_offsets[j + 1] - off == 3:
            dof_vel[:, off:off + 3] = local_vel[:, body_id]
        else:
            dof_vel[:, off] = local_vel[:, body_id, 1]
    return dof_vel


def load_motion_npy(path: str):
    """One reference-format SkeletonMotion .npy (Serializable dict)."""
    d = np.load(path, allow_pickle=True).item()
    tree = sk.SkeletonTree.from_dict(d["skeleton_tree"])
    rotation = np.asarray(d["rotation"]["arr"], dtype=np.float32)
    root_translation = np.asarray(d["root_translation"]["arr"], dtype=np.float32)
    fps = float(d["fps"])
    gv = d.get("global_velocity")
    gav = d.get("global_angular_velocity")
    gv = np.asarray(gv["arr"], dtype=np.float32) if gv is not None else None
    gav = np.asarray(gav["arr"], dtype=np.float32) if gav is not None else None
    if not bool(d.get("is_local", True)):
        rotation = sk.np_global_to_local(tree, rotation).astype(np.float32)
    return tree, rotation, root_translation, fps, gv, gav


def _parse_clips(files, weights, dof_body_ids, dof_offsets) -> Dict[str, np.ndarray]:
    """The dataset's ``_CACHE_FIELDS`` arrays from its ``.npy`` clips."""
    num_dof = int(dof_offsets[-1])
    all_gts, all_grs, all_lrs, all_gvs, all_gavs, all_dvs = [], [], [], [], [], []
    lengths, nframes, dts = [], [], []
    for path in files:
        tree, local_rot, root_t, fps, gv, gav = load_motion_npy(path)
        T = local_rot.shape[0]
        grs, gts = sk.np_fk(tree, local_rot, root_t)
        grs = np.asarray(grs, dtype=np.float32)
        gts = np.asarray(gts, dtype=np.float32)
        if gv is None or gav is None:
            gv, gav = sk.compute_velocities(gts, grs, fps)
        clip_dt = 1.0 / fps
        dvs = np.zeros((T, num_dof), dtype=np.float32)
        if T > 1:
            dvs[:-1] = _np_local_to_dof_vel(local_rot[:-1], local_rot[1:], clip_dt,
                                            dof_body_ids, dof_offsets, num_dof)
            dvs[-1] = dvs[-2]
        all_gts.append(gts)
        all_grs.append(grs)
        all_lrs.append(local_rot)
        all_gvs.append(gv)
        all_gavs.append(gav)
        all_dvs.append(dvs)
        lengths.append(clip_dt * (T - 1))
        nframes.append(T)
        dts.append(clip_dt)

    w = np.asarray(weights, dtype=np.float32)
    nf = np.asarray(nframes, dtype=np.int32)
    return {
        "gts": np.concatenate(all_gts), "grs": np.concatenate(all_grs),
        "lrs": np.concatenate(all_lrs), "gvs": np.concatenate(all_gvs),
        "gavs": np.concatenate(all_gavs), "dvs": np.concatenate(all_dvs),
        "length_starts": np.concatenate([[0], np.cumsum(nf)[:-1]]).astype(np.int32),
        "lengths": np.asarray(lengths, dtype=np.float32), "num_frames": nf,
        "dt": np.asarray(dts, dtype=np.float32), "weights": w / w.sum(),
    }


def load_motion_lib(motion_file: str, dof_body_ids: Sequence[int],
                    dof_offsets: Sequence[int], key_body_ids: Sequence[int],
                    device="cuda") -> MotionLib:
    """The dataset (a clip or a weighted ``.yaml``) as a ``MotionLib`` on
    ``device``, parsed from its clips."""
    files, weights = _fetch_motion_files(motion_file)
    arrays = _parse_clips(files, weights, dof_body_ids, dof_offsets)

    gts, grs, lrs = arrays["gts"], arrays["grs"], arrays["lrs"]
    gvs, gavs, dvs = arrays["gvs"], arrays["gavs"], arrays["dvs"]
    F = gts.shape[0]
    if F >= 2 ** 24:
        raise ValueError(f"{F} motion frames exceed the float32-exact frame index range")
    key = np.asarray(key_body_ids, dtype=np.int64)
    packed = np.concatenate([
        gts[:, 0], grs[:, 0], lrs.reshape(F, -1), gvs[:, 0], gavs[:, 0], dvs,
        gts[:, key].reshape(F, -1),
    ], axis=1).astype(np.float32)
    meta = np.stack([arrays[k].astype(np.float32)
                     for k in ("lengths", "num_frames", "dt", "length_starts")], axis=1)

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return MotionLib(
        gts=t(gts), grs=t(grs), gvs=t(gvs), gavs=t(gavs),
        lengths=t(arrays["lengths"]), weights=t(arrays["weights"]),
        key_body_ids=t(key, torch.long), packed=t(packed), meta=t(meta),
        dof_body_ids=tuple(int(i) for i in dof_body_ids),
        dof_offsets=tuple(int(i) for i in dof_offsets),
        num_joints=int(gts.shape[1]),
    )
