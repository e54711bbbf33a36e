"""Import an MJCF asset as a SkeletonTree (reference poselib/mjcf_importer.py).

Usage:
  python -m ase_tpu_torch.tools.mjcf_importer --mjcf mjcf/amp_humanoid.xml --output tree.npy
"""

from __future__ import annotations

import argparse

import numpy as np

from ase_tpu_torch.motion.importers import skeleton_from_mjcf
from ase_tpu_torch.physics.mjcf import find_asset


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--mjcf", required=True)
    p.add_argument("--asset-root", default="ase/data/assets")
    p.add_argument("--output", required=True)
    args = p.parse_args(argv)

    tree = skeleton_from_mjcf(find_asset(args.asset_root, args.mjcf))
    np.save(args.output, tree.to_dict())
    print(f"wrote {args.output}: {tree.num_joints} joints {list(tree.node_names)}")


if __name__ == "__main__":
    main()
