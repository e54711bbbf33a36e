"""Readings that the comparison's limits are set from: one cell, many
seeds, in one process (set-up is paid per reading, the process start and
the kernel build once). Not a benchmark run.

    python3 -m h100_bench.calibrate --workload ase_llc.play --seeds 11,12,13 \\
        --modes sound,tf32 --seconds 4

``sound`` runs the program as the configuration states; ``tf32`` is the
control (the program with TF32 products on, the precision below the
configuration's float32); ``plain_chol`` runs the program with its plain
Cholesky in place of the kernels (a witness, with ``--witness``: the play
cells' steps are also run by the reference with a float64 Cholesky); a
fault name plants that fault (``faults.FAULTS``). Each reading prints one
JSON line with every reading of the comparison; the diagnostics go to
standard error as in a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from h100_bench import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    p.add_argument("--modes", default="sound", help="comma-separated: sound, tf32, plain_chol, "
                   + ", ".join(faults.FAULTS))
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--witness", action="store_true")
    args = p.parse_args(argv)
    for mode in args.modes.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            try:
                r = run.run_cell(args.workload, seed, args.seconds, False, t_start=t0,
                                 control=mode if mode in ("tf32", "plain_chol") else None,
                                 fault=mode if mode in faults.FAULTS else None,
                                 witness=args.witness)
            except Exception as e:  # a reading that fails is reported, the rest go on
                print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                                  "error": repr(e)}), flush=True)
                continue
            print(json.dumps({"workload": args.workload, "seed": seed, "mode": mode,
                              "correct": r["correct"], "readings": r["readings"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
