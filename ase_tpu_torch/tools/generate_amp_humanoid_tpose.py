"""Generate the AMP humanoid T-pose file (reference
poselib/generate_amp_humanoid_tpose.py).

Usage:
  python -m ase_tpu_torch.tools.generate_amp_humanoid_tpose \
      --mjcf mjcf/amp_humanoid_sword_shield.xml --output amp_humanoid_tpose.npy
"""

from __future__ import annotations

import argparse

import numpy as np

from ase_tpu_torch.motion.importers import generate_amp_humanoid_tpose
from ase_tpu_torch.physics.mjcf import find_asset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mjcf", default="mjcf/amp_humanoid.xml")
    p.add_argument("--asset-root", default="ase/data/assets")
    p.add_argument("--output", required=True)
    p.add_argument("--plot", action="store_true")
    args = p.parse_args(argv)

    path = find_asset(args.asset_root, args.mjcf)
    tree, local_rot, root = generate_amp_humanoid_tpose(path)

    def arr(a, dtype):
        return {"arr": np.asarray(a, dtype=dtype), "context": {"dtype": str(dtype)}}

    d = {
        "rotation": arr(local_rot, "float32"),
        "root_translation": arr(root, "float32"),
        "skeleton_tree": tree.to_dict(),
        "is_local": True,
        "__name__": "SkeletonState",
    }
    np.save(args.output, d)
    print(f"wrote {args.output} ({tree.num_joints} joints)")
    if args.plot:
        from ase_tpu_torch.viz.plotter import plot_skeleton_state

        plot_skeleton_state(tree, local_rot, root)


if __name__ == "__main__":
    main()
