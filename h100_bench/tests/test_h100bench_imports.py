"""Nothing a run of the benchmark loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``ase_tpu``, compared as whole names; the reference
loads nothing of ``ase_tpu_torch`` either."""

import ast
import json
import os
import subprocess
import sys

import pytest

from h100_bench import cells, run

TINY_RUN = r"""
import json, sys
import ase_tpu_torch.envs.humanoid_amp_getup as getup
getup.FALL_TICKS = 2
from h100_bench import run
tiny = json.loads(sys.argv[2])
r = run.run_cell(sys.argv[1], 77, 0.0 if sys.argv[1].endswith("train") else 4.0, False, device="cpu", overrides=tiny, need_card=False)
print(json.dumps({"bad": run.forbidden_modules(),
                  "tops": sorted({m.split(".")[0] for m in sys.modules})}))
"""


def test_whole_names_are_compared():
    assert run.forbidden_modules(["ase_tpu_torch", "ase_tpu_torch.envs", "jaxtyping"]) == []
    assert run.forbidden_modules(["ase_tpu.envs", "jax.numpy", "flax", "jaxlib.x"]) == [
        "ase_tpu", "flax", "jax", "jaxlib"]


@pytest.mark.parametrize("cell", ["ase_llc.train", "hrl_heading.play"])
def test_a_tiny_run_loads_no_jax(cell, tiny):
    env = dict(os.environ, PYTHONPATH=cells.ROOT)
    out = subprocess.run([sys.executable, "-c", TINY_RUN, cell, json.dumps(tiny)],
                         cwd=cells.ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert "ase_tpu_torch" in res["tops"]


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import h100_bench.reference.follow; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=cells.ROOT))
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip()))
    assert not tops & {"ase_tpu_torch", "ase_tpu", "jax", "jaxlib", "flax"}


def test_no_reference_source_imports_the_program():
    root = os.path.join(cells.HERE, "reference")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in ("ase_tpu_torch", "ase_tpu", "jax"), (f, n)
