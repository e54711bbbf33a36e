"""Motion retargeting: map mocap clips between skeletons (port of
``ase_tpu/motion/retarget.py``).

Capability-parity with the reference poselib pipeline
(``ase/poselib/poselib/skeleton/skeleton3d.py:786-948`` ``retarget_to`` and
``ase/poselib/retarget_motion.py``): six-step rotation-transplant retarget
driven by a JSON config (joint_mapping, frame rotation, scale, trim), plus
the 3-DoF→1-DoF elbow/knee projection and ground-height fixing.

Everything operates on (T, J, 4)/(T, 3) numpy arrays + SkeletonTree — offline
tooling, so plain numpy is the right tier, as in the reference.
"""

from __future__ import annotations

import json
from typing import Dict, Sequence, Tuple

import numpy as np

from ase_tpu_torch.motion import skeleton as sk
from ase_tpu_torch.motion.skeleton import (SkeletonTree, _np_quat_conj, _np_quat_mul,
                                           _np_quat_rotate, np_fk, np_global_to_local)


def _np_quat_unit(q):
    return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)


def retarget_motion(
    source_tree: SkeletonTree,
    source_local_rot: np.ndarray,       # (T, Js, 4)
    source_root_trans: np.ndarray,      # (T, 3)
    source_tpose_local: np.ndarray,     # (Js, 4)
    target_tree: SkeletonTree,
    target_tpose_local: np.ndarray,     # (Jt, 4)
    target_tpose_root: np.ndarray,      # (3,)
    joint_mapping: Dict[str, str],
    rotation_to_target: np.ndarray,     # (4,) xyzw
    scale_to_target: float,
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (target_local_rot (T, Jt, 4), target_root_trans (T, 3)).

    Pipeline (reference skeleton3d.py:786-948):
      1. restrict the source skeleton to the mapped joints;
      2. rotate the motion into the target's coordinate frame;
      3. scale the root translation;
      4. transplant each joint's rotation *relative to its T-pose* onto the
         target T-pose;
      5. non-mapped target joints keep their T-pose local rotation;
      6. convert back to local representation on the target skeleton.
    """
    T = source_local_rot.shape[0]

    # 1. keep only mapped source joints
    keep_names = [n for n in source_tree.node_names if n in joint_mapping]
    sub_tree, keep_idx = source_tree.keep_nodes(keep_names)
    # dropped joints fold their rotation into the chain: recompute source
    # globals on the FULL tree, then take the kept joints' globals
    grs_full, _ = np_fk(source_tree, source_local_rot, source_root_trans)
    grs = grs_full[:, keep_idx]

    tpose_grs_full, _ = np_fk(
        source_tree, source_tpose_local[None], np.zeros((1, 3))
    )
    tpose_grs = tpose_grs_full[0, keep_idx]        # (Jk, 4)

    # 2. rotate into target frame
    grs = _np_quat_mul(np.broadcast_to(rotation_to_target, grs.shape), grs)
    tpose_grs = _np_quat_mul(np.broadcast_to(rotation_to_target, tpose_grs.shape), tpose_grs)
    root_trans = _np_quat_rotate(np.broadcast_to(rotation_to_target, (T, 4)), source_root_trans)

    # 3. scale
    root_trans = root_trans * scale_to_target

    # target tpose globals
    tgt_tpose_grs, tgt_tpose_gts = np_fk(
        target_tree, target_tpose_local[None], target_tpose_root[None]
    )
    tgt_tpose_grs = tgt_tpose_grs[0]

    # 4-5. transplant tpose-relative rotations onto the target tpose
    tgt_grs = np.tile(tgt_tpose_grs[None], (T, 1, 1))
    for k, name in enumerate(keep_names):
        tgt_name = joint_mapping[name]
        tj = target_tree.index(tgt_name)
        delta = _np_quat_mul(grs[:, k], _np_quat_conj(np.broadcast_to(tpose_grs[k], (T, 4))))
        tgt_grs[:, tj] = _np_quat_mul(delta, np.broadcast_to(tgt_tpose_grs[tj], (T, 4)))
    tgt_grs = _np_quat_unit(tgt_grs)

    # 6. back to local representation
    tgt_lrs = np_global_to_local(target_tree, tgt_grs)

    # the root keeps the source's (rotated, scaled) trajectory; ground
    # alignment is the caller's job (fix_ground_height + root_height_offset,
    # as in the reference script retarget_motion.py:231-243)
    return tgt_lrs.astype(np.float32), root_trans.astype(np.float32)


def _np_quat_from_angle_axis(angle: np.ndarray, axis: np.ndarray) -> np.ndarray:
    """xyzw quaternion from angle (...,) about a unit axis (...,3) or (3,)."""
    angle = np.asarray(angle, dtype=np.float64)
    axis = np.broadcast_to(axis, angle.shape + (3,))
    half = 0.5 * angle
    return np.concatenate(
        [axis * np.sin(half)[..., None], np.cos(half)[..., None]], axis=-1
    )


def project_joints(
    tree: SkeletonTree,
    local_rot: np.ndarray,    # (T, J, 4)
    root_trans: np.ndarray,
    limbs: Sequence[Tuple[str, str, str, float]] = (
        # (parent ball joint, hinge joint, end effector, hinge sign)
        ("right_upper_arm", "right_lower_arm", "right_hand", -1.0),
        ("left_upper_arm", "left_lower_arm", "left_hand", -1.0),
        ("right_thigh", "right_shin", "right_foot", 1.0),
        ("left_thigh", "left_shin", "left_foot", 1.0),
    ),
    zero_joints: Sequence[str] = ("left_hand", "right_hand"),
) -> np.ndarray:
    """Project 3-DoF elbow/knee rotations onto their single y-axis hinge.

    Matches the reference's geometric projection
    (``ase/poselib/retarget_motion.py:24-175``) limb by limb:

    1. the hinge angle is the bend angle between the upper and lower limb
       segments (``acos(-(u−m)·(e−m))`` on unit segment vectors), placed on
       the y axis with a fixed sign convention — elbows bend negative,
       knees positive (ref ``:55,:113``);
    2. the residual between the old 3-DoF rotation and the new hinge is
       absorbed into the PARENT ball joint (shoulder/hip): the angle between
       the child-offset direction under the old vs. new rotation, about the
       child-offset axis, post-multiplied onto the parent's local rotation
       (ref ``:58-68`` and its three siblings), with the reference's
       y-component sign rule (arms flip when dir0.y > 0, legs when
       dir0.y < 0, ref ``:66,:124``);
    3. hand joints are zeroed to the identity (ref ``:169-170``).
    """
    out = local_rot.copy()
    _, gts = np_fk(tree, local_rot, root_trans)
    axis_y = np.array([0.0, 1.0, 0.0])

    def _unit(v):
        return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1e-9)

    for (upper_n, mid_n, end_n, hinge_sign) in limbs:
        try:
            u, m, e = tree.index(upper_n), tree.index(mid_n), tree.index(end_n)
        except ValueError:
            continue
        # bend angle between the limb segments (0 when straight)
        delta0 = _unit(gts[:, u] - gts[:, m])
        delta1 = _unit(gts[:, e] - gts[:, m])
        theta = np.arccos(np.clip(np.sum(-delta0 * delta1, axis=-1), -1.0, 1.0))
        hinge_q = _np_quat_from_angle_axis(hinge_sign * np.abs(theta), axis_y)

        # residual: how far the child-offset direction moved when the 3-DoF
        # rotation collapsed onto the hinge — absorbed into the parent ball
        # joint about the child-offset axis so the end effector tracks
        local_dir = _unit(np.asarray(tree.local_translation[e], dtype=np.float64))
        old_mid = local_rot[:, m]
        dir0 = _np_quat_rotate(old_mid, np.broadcast_to(local_dir, (old_mid.shape[0], 3)))
        dir1 = _np_quat_rotate(hinge_q, np.broadcast_to(local_dir, (old_mid.shape[0], 3)))
        res_theta = np.arccos(np.clip(np.sum(dir0 * dir1, axis=-1), -1.0, 1.0))
        res_theta = np.where(hinge_sign * dir0[:, 1] >= 0, res_theta, -res_theta)
        comp_q = _np_quat_from_angle_axis(res_theta, local_dir)

        out[:, u] = _np_quat_mul(local_rot[:, u], comp_q)
        out[:, m] = hinge_q

    for name in zero_joints:
        try:
            j = tree.index(name)
        except ValueError:
            continue
        out[:, j] = np.array([0.0, 0.0, 0.0, 1.0])
    return out


def fix_ground_height(
    tree: SkeletonTree, local_rot: np.ndarray, root_trans: np.ndarray,
) -> np.ndarray:
    """Shift the root so the lowest BODY position over the whole clip touches
    z=0 (reference retarget_motion.py:231-236: ``min_h = min(global_pos[...,
    2])`` over all frames and all joints, no clearance). Ground-penetration
    headroom comes from the config's ``root_height_offset``, added by the
    retarget script after grounding (ref :238-240)."""
    _, gts = np_fk(tree, local_rot, root_trans)
    min_h = gts[..., 2].min()
    out = root_trans.copy()
    out[:, 2] -= min_h
    return out


def load_retarget_config(path: str) -> dict:
    """Reference config JSON schema (poselib/data/configs/retarget_*.json)."""
    with open(path, "r") as f:
        cfg = json.load(f)
    q = np.asarray(cfg["rotation"], dtype=np.float32)
    return {
        "joint_mapping": cfg["joint_mapping"],
        "rotation": q,
        "scale": float(cfg["scale"]),
        "source_tpose": cfg.get("source_tpose"),
        "target_tpose": cfg.get("target_tpose"),
        "source_motion": cfg.get("source_motion"),
        "target_motion_path": cfg.get("target_motion_path"),
        "root_height_offset": float(cfg.get("root_height_offset", 0.0)),
        "trim_frame_beg": int(cfg.get("trim_frame_beg", -1)),
        "trim_frame_end": int(cfg.get("trim_frame_end", -1)),
    }


def save_motion_npy(
    path: str, tree: SkeletonTree, local_rot: np.ndarray, root_trans: np.ndarray,
    fps: float,
) -> None:
    """Write the reference Serializable SkeletonMotion dict format so clips
    interchange with existing ASE tooling."""
    grs, gts = np_fk(tree, local_rot, root_trans)
    gv, gav = sk.compute_velocities(gts, grs, fps)

    def arr(a, dtype):
        return {"arr": np.asarray(a, dtype=dtype), "context": {"dtype": str(dtype)}}

    d = {
        "rotation": arr(local_rot, "float64"),
        "root_translation": arr(root_trans, "float64"),
        "global_velocity": arr(gv, "float64"),
        "global_angular_velocity": arr(gav, "float64"),
        "skeleton_tree": tree.to_dict(),
        "is_local": True,
        "fps": float(fps),
        "__name__": "SkeletonMotion",
    }
    np.save(path, d)
