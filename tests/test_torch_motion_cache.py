"""The port's native motion cache (``ase_tpu_torch/native``, the ``.msc``
path of ``ase_tpu_torch/motion/motion_lib.py``) on the CPU: the extension
built from ``native/motion_cache.cpp`` into ``ase_tpu_torch/_build/``, its
file format shared with ``ase_tpu``, and ``load_motion_lib``'s miss, hit
and stale paths. ``HOME`` points at the test's own directory, so the cache
files land there. Arrays and tensors are compared bit for bit.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from ase_tpu_torch import native
from ase_tpu_torch.motion import motion_lib as tml
from ase_tpu_torch.physics import mjcf

DATASET = "data/motions/reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"
CLIP = "data/motions/reallusion_sword_shield/RL_Avatar_Idle_Ready_Motion.npy"
KEY_BODIES = ["right_hand", "left_hand", "right_foot", "left_foot", "sword", "shield"]


@pytest.fixture(autouse=True)
def _home(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))


@pytest.fixture(scope="module")
def skeleton():
    """The sword-shield humanoid's dof layout and key bodies, as the env
    hands them to the motion library."""
    m = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"), device="cpu")
    return m.dof_body_ids, m.dof_offsets, [m.body_index(b) for b in KEY_BODIES]


def _arrays(seed=0):
    """One array per cache field, in the loader's dtypes."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "gts": rng.normal(size=(7, 5, 3)).astype(f32), "grs": rng.normal(size=(7, 5, 4)).astype(f32),
        "lrs": rng.normal(size=(7, 5, 4)).astype(f32), "gvs": rng.normal(size=(7, 5, 3)).astype(f32),
        "gavs": rng.normal(size=(7, 5, 3)).astype(f32), "dvs": rng.normal(size=(7, 9)).astype(f32),
        "length_starts": np.asarray([0, 3], np.int32), "lengths": np.asarray([0.1, 0.2], f32),
        "num_frames": np.asarray([3, 4], np.int32), "dt": np.asarray([1 / 30, 1 / 60], f32),
        "weights": np.asarray([0.25, 0.75], f32),
    }


def _assert_same(a, b):
    assert list(a) == list(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pack_load_round_trip_through_the_ports_build(tmp_path):
    """The port's g++ build of motion_cache.cpp lands in ase_tpu_torch/_build
    under a source-hash name; what its ``pack`` writes, ``load`` maps back."""
    mc = native.motion_cache()
    assert os.path.dirname(mc.__file__) == native.BUILD_DIR
    assert mc.__file__ == native.lib_path() and mc.__name__ == "_motion_cache"
    path = str(tmp_path / "x.msc")
    arrays = _arrays()
    tml._save_native_cache(path, arrays)
    assert os.listdir(tmp_path).count("x.msc") == 1 and not any(
        f.endswith(".tmp") for f in os.listdir(tmp_path))
    _assert_same(arrays, tml._try_native_cache(path))
    assert tml._try_native_cache(str(tmp_path / "missing.msc")) is None


def test_a_cache_written_by_ase_tpu_loads_in_the_port(tmp_path):
    """The format is common: ``ase_tpu``'s ``_save_native_cache`` (through
    its own build) writes a file the port reads to the same arrays."""
    from ase_tpu import native as jnative
    from ase_tpu.motion import motion_lib as jml

    if jnative.get_motion_cache() is None:
        pytest.fail("ase_tpu's motion cache did not build")
    path = str(tmp_path / "ref.msc")
    arrays = _arrays(seed=1)
    jml._save_native_cache(path, arrays)
    assert os.path.exists(path)
    _assert_same(arrays, tml._try_native_cache(path))
    assert tml._CACHE_FIELDS == jml._CACHE_FIELDS


def _lib_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if torch.is_tensor(x):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert x == y, f.name


def test_load_motion_lib_misses_then_hits_bit_equal(skeleton, tmp_path):
    """The first load parses the 87 clips and writes the cache under
    ~/.cache/ase_tpu_torch; the second maps it. Every tensor of the two
    libraries, and of one loaded without the cache, is bit-equal."""
    dof_body_ids, dof_offsets, keys = skeleton
    before = dict(tml.CACHE)
    miss = tml.load_motion_lib(DATASET, dof_body_ids, dof_offsets, keys, device="cpu")
    assert tml.CACHE == {"hits": before["hits"], "misses": before["misses"] + 1}
    files, weights = tml._fetch_motion_files(DATASET)
    path = tml._cache_path(DATASET, files, weights, dof_body_ids, dof_offsets)
    assert os.path.dirname(path) == str(tmp_path / ".cache" / "ase_tpu_torch")
    assert os.path.exists(path) and len(files) == 87
    hit = tml.load_motion_lib(DATASET, dof_body_ids, dof_offsets, keys, device="cpu")
    assert tml.CACHE == {"hits": before["hits"] + 1, "misses": before["misses"] + 1}
    _lib_equal(miss, hit)
    _lib_equal(miss, tml.load_motion_lib(DATASET, dof_body_ids, dof_offsets, keys,
                                         device="cpu", use_cache=False))
    assert miss.num_motions == 87 and tuple(hit.meta.shape) == (87, 4)


def test_a_stale_cache_misses(skeleton, tmp_path):
    """A clip whose mtime changed gives another cache key: the next load
    misses and writes a second file, with the same arrays."""
    dof_body_ids, dof_offsets, keys = skeleton
    clip = tmp_path / "clip.npy"
    clip.write_bytes(open(CLIP, "rb").read())
    first = tml.load_motion_lib(str(clip), dof_body_ids, dof_offsets, keys, device="cpu")
    before = dict(tml.CACHE)
    st = os.stat(clip)
    os.utime(clip, (st.st_atime, st.st_mtime + 10.0))
    second = tml.load_motion_lib(str(clip), dof_body_ids, dof_offsets, keys, device="cpu")
    assert tml.CACHE == {"hits": before["hits"], "misses": before["misses"] + 1}
    assert len(os.listdir(tmp_path / ".cache" / "ase_tpu_torch")) == 2
    _lib_equal(first, second)


def test_a_failed_build_raises_with_the_compilers_output(tmp_path):
    """No silent fallback: g++'s stderr is in the error."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("#include <Python.h>\nint broken( {\n")
    with pytest.raises(RuntimeError, match="motion cache build failed") as err:
        native.build(str(bad))
    assert "error" in str(err.value) and "broken.cpp" in str(err.value)
    assert not os.path.exists(native.lib_path(str(bad)))
