"""Render a motion clip (reference poselib visualization / HumanoidViewMotion).

Usage:
  python -m ase_tpu_torch.tools.view_motion --motion <clip.npy> [--save out.mp4]
"""

from __future__ import annotations

import argparse

from ase_tpu_torch.motion import motion_lib as ml


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--motion", required=True)
    p.add_argument("--save", default=None)
    args = p.parse_args(argv)

    tree, lr, rt, fps, _, _ = ml.load_motion_npy(args.motion)
    from ase_tpu_torch.viz.plotter import plot_skeleton_motion

    plot_skeleton_motion(tree, lr, rt, fps=fps, save_path=args.save)


if __name__ == "__main__":
    main()
