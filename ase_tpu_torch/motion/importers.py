"""Offline asset importers (port of ``ase_tpu/motion/importers.py``).

* MJCF → SkeletonTree (reference mjcf_importer.py)
* T-pose generation for the AMP humanoid (reference
  generate_amp_humanoid_tpose.py:20-31 arm rotations)
* FBX import through the pure-Python FBX binary reader
  (``ase_tpu_torch/motion/fbx.py``): root joint by longest animation curve,
  per-frame local transform sampling, no Autodesk SDK.

Host-side numpy, as in the reference: the MJCF is read on the CPU and only
its host arrays are used.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ase_tpu_torch.motion import fbx as fbx_mod
from ase_tpu_torch.motion import skeleton as sk
from ase_tpu_torch.motion.skeleton import SkeletonTree
from ase_tpu_torch.physics import mjcf as mjcf_mod


def skeleton_from_mjcf(path: str) -> SkeletonTree:
    """Body tree of an MJCF asset as a SkeletonTree."""
    model = mjcf_mod.load_mjcf(path, device="cpu")
    return SkeletonTree(
        node_names=model.body_names,
        parent_indices=model.parents,
        local_translation=model.np("body_ipos"),
    )


def _axis_angle_quat(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    return np.concatenate([axis * np.sin(angle / 2), [np.cos(angle / 2)]]).astype(
        np.float32
    )


def generate_amp_humanoid_tpose(mjcf_path: str):
    """T-pose with arms rotated down ±90° about x
    (reference generate_amp_humanoid_tpose.py:20-31)."""
    tree = skeleton_from_mjcf(mjcf_path)
    J = tree.num_joints
    local_rot = np.tile(np.array([0, 0, 0, 1], dtype=np.float32), (J, 1))
    for name, sign in (("left_upper_arm", 1.0), ("right_upper_arm", -1.0)):
        if name in tree.node_names:
            local_rot[tree.index(name)] = _axis_angle_quat([1, 0, 0], sign * np.pi / 2)
    root = np.array([0.0, 0.0, 0.89], dtype=np.float32)
    return tree, local_rot, root


def import_fbx(
    path: str,
    fps: Optional[float] = None,
    root_joint: Optional[str] = None,
):
    """FBX mocap file → (SkeletonTree, local_rotation (T,J,4) xyzw,
    root_translation (T,3), fps): the skeleton from the first mocap frame,
    local rotations and the root joint's translation track (the reference's
    ``SkeletonMotion.from_fbx``, ``poselib/skeleton/skeleton3d.py:1164-1212``)."""
    names, parents, local_rot, local_t, root_t, out_fps = fbx_mod.load_mocap(
        path, fps=fps, root_joint=root_joint
    )
    tree = SkeletonTree(
        node_names=tuple(names),
        parent_indices=tuple(parents),
        local_translation=local_t[0].astype(np.float32),
    )
    return tree, local_rot, root_t, out_fps


def fbx_to_motion_dict(
    path: str,
    fps: Optional[float] = None,
    root_joint: Optional[str] = None,
) -> dict:
    """FBX file → the reference ``SkeletonMotion`` Serializable dict layout
    (what ``.npy`` clips store — see motion_lib.load_motion_npy), with
    velocities precomputed like the reference's ``to_file`` path."""
    tree, local_rot, root_t, out_fps = import_fbx(path, fps, root_joint)
    grs, gts = sk.np_fk(tree, local_rot, root_t)
    gv, gav = sk.compute_velocities(gts, grs, out_fps)
    return {
        "rotation": {"arr": local_rot.astype(np.float64),
                     "context": {"dtype": "float64"}},
        "root_translation": {"arr": root_t.astype(np.float64),
                             "context": {"dtype": "float64"}},
        "global_velocity": {"arr": gv.astype(np.float64),
                            "context": {"dtype": "float64"}},
        "global_angular_velocity": {"arr": gav.astype(np.float64),
                                    "context": {"dtype": "float64"}},
        "skeleton_tree": tree.to_dict(),
        "is_local": True,
        "fps": float(out_fps),
        "__name__": "SkeletonMotion",
    }
