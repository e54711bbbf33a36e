"""Retarget a mocap clip between skeletons (reference poselib/retarget_motion.py).

Usage:
  python -m ase_tpu_torch.tools.retarget_motion --config retarget_cmu_to_amp.json \
      [--source <motion.npy>] [--output <out.npy>] [--project-joints] [--plot]

The JSON config uses the reference schema: joint_mapping, rotation (xyzw),
scale, source/target tposes, trim frames.
"""

from __future__ import annotations

import argparse

import numpy as np

from ase_tpu_torch.motion import motion_lib as ml
from ase_tpu_torch.motion import retarget as rt
from ase_tpu_torch.motion.skeleton import SkeletonTree


def load_pose_npy(path: str):
    """Load a SkeletonState .npy (tpose files in the reference data)."""
    d = np.load(path, allow_pickle=True).item()
    tree = SkeletonTree.from_dict(d["skeleton_tree"])
    rotation = np.asarray(d["rotation"]["arr"], dtype=np.float32)
    root = np.asarray(d["root_translation"]["arr"], dtype=np.float32)
    return tree, rotation, root


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--source", default=None, help="override source_motion")
    p.add_argument("--output", default=None, help="override target_motion_path")
    # the reference script runs both unconditionally (retarget_motion.py:229,
    # 231-240); keep opt-outs for debugging intermediate stages
    p.add_argument("--project-joints", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="project 3-DoF elbows/knees onto 1-DoF hinges")
    p.add_argument("--fix-ground", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="ground the clip on the min body height + offset")
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)

    cfg = rt.load_retarget_config(args.config)
    src_path = args.source or cfg["source_motion"]
    out_path = args.output or cfg["target_motion_path"]

    src_tree, src_lr, src_rt_, fps, _, _ = ml.load_motion_npy(src_path)
    s_tree, s_tpose_lr, _ = load_pose_npy(cfg["source_tpose"])
    t_tree, t_tpose_lr, t_tpose_root = load_pose_npy(cfg["target_tpose"])

    out_lr, out_root = rt.retarget_motion(
        src_tree, src_lr, src_rt_, s_tpose_lr,
        t_tree, t_tpose_lr, t_tpose_root,
        cfg["joint_mapping"], cfg["rotation"], cfg["scale"],
    )

    beg = cfg["trim_frame_beg"] if cfg["trim_frame_beg"] >= 0 else 0
    end = cfg["trim_frame_end"] if cfg["trim_frame_end"] >= 0 else out_lr.shape[0]
    out_lr, out_root = out_lr[beg:end], out_root[beg:end]

    if args.project_joints:
        out_lr = rt.project_joints(t_tree, out_lr, out_root)
    if args.fix_ground:
        out_root = rt.fix_ground_height(t_tree, out_lr, out_root)
        # the reference script lifts the root by a config offset after grounding
        # (retarget_motion.py:238-240)
        out_root[:, 2] += cfg["root_height_offset"]

    rt.save_motion_npy(out_path, t_tree, out_lr, out_root, fps)
    print(f"wrote {out_path} ({out_lr.shape[0]} frames @ {fps:.1f} fps)")

    if args.plot:
        from ase_tpu_torch.viz.plotter import plot_skeleton_motion

        plot_skeleton_motion(t_tree, out_lr, out_root, fps=fps)


if __name__ == "__main__":
    main()
