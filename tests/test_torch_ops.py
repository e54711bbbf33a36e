"""Port parity: rotation and small linear algebra ops, config loading, and
the rule that ase_tpu_torch imports no JAX.

Each case feeds the same numpy inputs (from a seed) to the JAX function in
ase_tpu and to its counterpart in ase_tpu_torch on the CPU. Tolerance:
float32 elementwise math in a different order, 2e-6 absolute on unit-scale
values (1e-5 where an arccos / atan2 is involved)."""

import ast
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.ops import linalg3 as jl3
from ase_tpu.ops import quat as jq
from ase_tpu.ops import spatial as jsp
from ase_tpu.utils import config as jcfg
from ase_tpu_torch.ops import linalg3 as tl3
from ase_tpu_torch.ops import quat as tq
from ase_tpu_torch.ops import spatial as tsp
from ase_tpu_torch.utils import config as tcfg
from ase_tpu_torch.utils import paths as tpaths


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs B <= 16 here: intra-op threads would only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


PKG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "ase_tpu_torch")


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=atol, rtol=0)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("name", [
    "quat_mul", "quat_rotate", "quat_conjugate", "quat_to_rotation_matrix",
    "quat_to_tan_norm", "calc_heading_quat", "calc_heading_quat_inv", "quat_to_exp_map",
    "slerp", "quat_integrate", "quat_integrate_local",
])
def test_quat_functions_match(rng, name):
    n = 64
    a, b = _quats(rng, n), _quats(rng, n)
    v = rng.normal(size=(n, 3)).astype(np.float32)
    t = rng.uniform(size=(n, 1)).astype(np.float32)
    args = {
        "quat_mul": (a, b), "quat_rotate": (a, v), "quat_conjugate": (a,),
        "quat_to_rotation_matrix": (a,), "quat_to_tan_norm": (a,),
        "calc_heading_quat": (a,), "calc_heading_quat_inv": (a,), "quat_to_exp_map": (a,),
        "slerp": (a, b, t),
        "quat_integrate": (a, v, 1 / 120), "quat_integrate_local": (a, v, 1 / 120),
    }[name]
    ja = getattr(jq, name)(*(jnp.asarray(x) if isinstance(x, np.ndarray) else x for x in args))
    ta = getattr(tq, name)(*(torch.as_tensor(x) if isinstance(x, np.ndarray) else x for x in args))
    _close(ja, ta, 1e-5)


def test_exp_map_round_trip_and_small_angles(rng):
    e = np.concatenate([rng.normal(size=(32, 3)), 1e-7 * rng.normal(size=(4, 3)),
                        np.zeros((1, 3))]).astype(np.float32)
    _close(jq.exp_map_to_quat(jnp.asarray(e)), tq.exp_map_to_quat(torch.as_tensor(e)), 2e-6)
    q = np.concatenate([_quats(rng, 16), [[0.0, 0.0, 0.0, 1.0]]]).astype(np.float32)
    for j, t in zip(jq.quat_to_angle_axis(jnp.asarray(q)),
                    tq.quat_to_angle_axis(torch.as_tensor(q))):
        _close(j, t, 1e-5)


def test_quat_from_angle_axis_broadcasts_a_fixed_axis(rng):
    ang = rng.normal(size=(10,)).astype(np.float32)
    axis = np.array([0.0, 1.0, 0.0], np.float32)
    _close(jq.quat_from_angle_axis(jnp.asarray(ang), jnp.asarray(axis)),
           tq.quat_from_angle_axis(torch.as_tensor(ang), torch.as_tensor(axis)), 2e-6)


def test_spatial_and_linalg3_match(rng):
    v = rng.normal(size=(16, 6)).astype(np.float32)
    w = rng.normal(size=(16, 6)).astype(np.float32)
    for f in ("motion_cross", "force_cross"):
        _close(getattr(jsp, f)(jnp.asarray(v), jnp.asarray(w)),
               getattr(tsp, f)(torch.as_tensor(v), torch.as_tensor(w)), 2e-6)
    m = rng.uniform(0.5, 2.0, size=16).astype(np.float32)
    c = rng.normal(size=(16, 3)).astype(np.float32)
    i3 = np.eye(3, dtype=np.float32)[None] * rng.uniform(0.1, 1, size=(16, 1, 1)).astype(np.float32)
    _close(jsp.spatial_inertia(jnp.asarray(m), jnp.asarray(c), jnp.asarray(i3)),
           tsp.spatial_inertia(torch.as_tensor(m), torch.as_tensor(c), torch.as_tensor(i3)), 1e-5)
    A = rng.normal(size=(16, 3, 3)).astype(np.float32) + 3 * np.eye(3, dtype=np.float32)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    _close(jl3.inv3(jnp.asarray(A)), tl3.inv3(torch.as_tensor(A)), 1e-5)
    _close(jl3.solve3(jnp.asarray(A), jnp.asarray(x)),
           tl3.solve3(torch.as_tensor(A), torch.as_tensor(x)), 1e-5)


PLAYER_ARGS = [
    "--test", "--task", "HumanoidAMPGetup",
    "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", "reallusion_sword_shield/dataset_reallusion_sword_shield.yaml",
    "--checkpoint", "data/models/ase_llc_reallusion_sword_shield.ckpt.npz",
    "--num_envs", "8", "--seed", "3",
]


def test_config_loading_matches_reference():
    jc, jt = jcfg.load_cfg(jcfg.get_args(PLAYER_ARGS))
    tc, tt = tcfg.load_cfg(tcfg.get_args(PLAYER_ARGS))
    assert tc["env"] == jc["env"] and tc["sim"] == jc["sim"] and tc["task"] == jc["task"]
    assert tt["params"]["network"] == jt["params"]["network"]
    assert tt["params"]["seed"] == jt["params"]["seed"] == 3
    assert tcfg.get_args(PLAYER_ARGS).device == "cuda"
    assert os.path.exists(tpaths.default_dataset())


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_or_reference_package():
    """Every module of ase_tpu_torch (top level and inside functions),
    chip_smoke.py and bench_torch.py import neither jax, flax, optax nor
    ase_tpu."""
    files = [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")]
    files += [os.path.join(os.path.dirname(PKG), f) for f in ("chip_smoke.py", "bench_torch.py")]
    assert len(files) > 20
    for path in files:
        for mod in _imported_modules(path):
            root = mod.split(".")[0]
            assert root not in ("jax", "jaxlib", "flax", "optax", "ase_tpu"), (path, mod)


def test_port_runs_without_jax_installed(tmp_path):
    """Importing every port module in a fresh interpreter where jax / flax /
    ase_tpu cannot be imported succeeds."""
    block = tmp_path / "sitecustomize.py"
    block.write_text(
        "import sys\n"
        "class _Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ase_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, _Block())\n")
    code = (
        "import pkgutil, importlib, ase_tpu_torch\n"
        "for m in pkgutil.walk_packages(ase_tpu_torch.__path__, 'ase_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=f"{tmp_path}{os.pathsep}{os.path.dirname(PKG)}")
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
