"""Convert FBX mocap files to the .npy SkeletonMotion format.

CLI equivalent of the reference's ``ase/poselib/fbx_importer.py`` (load an
FBX clip, save as ``.npy``, optionally visualize) — but self-contained: the
FBX binary is parsed by the bundled pure-Python reader
(``ase_tpu_torch/motion/fbx.py``) instead of the closed Autodesk SDK.

    python -m ase_tpu_torch.tools.fbx_importer --fbx clip.fbx --out clip.npy \
        --root_joint Hips --fps 60 [--view]
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--fbx", required=True, help="input .fbx (binary) file")
    ap.add_argument("--out", required=True, help="output .npy motion file")
    ap.add_argument("--root_joint", default=None,
                    help="skeleton root joint name (default: auto-detect by "
                         "longest animation curve, like the reference)")
    ap.add_argument("--fps", type=float, default=None,
                    help="resample rate (default: the file's native rate)")
    ap.add_argument("--view", action="store_true",
                    help="open the interactive motion viewer after import")
    args = ap.parse_args(argv)

    from ase_tpu_torch.motion.importers import fbx_to_motion_dict

    d = fbx_to_motion_dict(args.fbx, fps=args.fps, root_joint=args.root_joint)
    np.save(args.out, d, allow_pickle=True)
    rot = d["rotation"]["arr"]
    print(
        f"imported {args.fbx}: {rot.shape[0]} frames, "
        f"{rot.shape[1]} joints @ {d['fps']:.0f} fps -> {args.out}"
    )

    if args.view:
        from ase_tpu_torch.motion.motion_lib import load_motion_npy
        from ase_tpu_torch.viz.plotter import plot_skeleton_motion

        tree, local_rot, root_t, fps, _, _ = load_motion_npy(args.out)
        plot_skeleton_motion(tree, local_rot, root_t, fps)


if __name__ == "__main__":
    main()
