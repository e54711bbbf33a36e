"""Port parity for the mocap workflow: the FBX reader, the importers,
retargeting, the tensor forms of forward kinematics and the five tools,
against ``ase_tpu`` on the CPU, on the vendored CMU clip
(``data/poselib/09_11_cmu.fbx``).

The reader, the importers, retargeting and the tools are host-side numpy in
both packages, with the same operations in the same order, so their arrays
(and the tools' files) are held equal with ``np.array_equal``, dtypes too.
``skeleton.fk`` and ``global_to_local`` run on tensors: their products are
the reference's, but the JAX forms are compiled op by op and may contract
multiply-adds, so rotations are held to 1e-6 and positions to 1e-5 m.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.motion import fbx as jfbx
from ase_tpu.motion import importers as jimp
from ase_tpu.motion import motion_lib as jml
from ase_tpu.motion import retarget as jrt
from ase_tpu.motion import skeleton as jsk
from ase_tpu.utils import paths as jpaths
from ase_tpu_torch.motion import fbx as tfbx
from ase_tpu_torch.motion import importers as timp
from ase_tpu_torch.motion import retarget as trt
from ase_tpu_torch.motion import skeleton as tsk
from ase_tpu_torch.utils import paths as tpaths
from tests.test_torch_train_parts import _one_torch_thread  # noqa: F401

FBX = jpaths.data_path("poselib", "09_11_cmu.fbx")
IMPORTED = jpaths.data_path("poselib", "09_11_cmu_imported.npy")
AMP_XML = jpaths.data_path("assets", "mjcf", "amp_humanoid.xml")
RETARGET_CFG = jpaths.data_path("retarget_cfg", "retarget_cmu_to_amp.json")
T = 120          # frames retargeted, as tests/test_fbx.py does


def assert_same(ref, got, what="root"):
    """Equal structure, equal arrays (dtype included) and equal scalars."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and set(ref) == set(got), (what, set(ref), set(got))
        for k in ref:
            assert_same(ref[k], got[k], f"{what}.{k}")
    elif isinstance(ref, (list, tuple)) and not (ref and isinstance(ref[0], (int, str))):
        assert len(ref) == len(got), what
        for i, (a, b) in enumerate(zip(ref, got)):
            assert_same(a, b, f"{what}[{i}]")
    elif isinstance(ref, np.ndarray):
        assert isinstance(got, np.ndarray) and ref.dtype == got.dtype, (what, ref.dtype)
        assert np.array_equal(ref, got), what
    elif isinstance(ref, (jsk.SkeletonTree, tsk.SkeletonTree)):
        assert tuple(ref.node_names) == tuple(got.node_names), what
        assert tuple(ref.parent_indices) == tuple(got.parent_indices), what
        assert_same(np.asarray(ref.local_translation), np.asarray(got.local_translation),
                    f"{what}.local_translation")
    else:
        assert ref == got, (what, ref, got)


def _tree(t, cls):
    return cls(tuple(t.node_names), tuple(t.parent_indices), t.local_translation)


@pytest.fixture(scope="module")
def mocap():
    return jfbx.load_mocap(FBX)


@pytest.mark.parametrize("fps,root_joint", [(None, None), (60.0, None), (30.0, "Hips")])
def test_load_mocap_matches_reference(fps, root_joint):
    assert_same(jfbx.load_mocap(FBX, fps=fps, root_joint=root_joint),
                tfbx.load_mocap(FBX, fps=fps, root_joint=root_joint))


@pytest.mark.parametrize("order", ["XYZ", "XZY", "YZX", "YXZ", "ZXY", "ZYX"])
def test_euler_to_quat_matches_reference(order):
    deg = np.random.default_rng(len(order) + ord(order[0])).uniform(-180, 180, (5, 7, 3))
    assert_same(jfbx.euler_to_quat(deg, order), tfbx.euler_to_quat(deg, order))


@pytest.mark.parametrize("fn", ["skeleton_from_mjcf", "generate_amp_humanoid_tpose",
                                "import_fbx", "fbx_to_motion_dict"])
def test_importers_match_reference(fn):
    """``skeleton_from_mjcf`` reads the MJCF on the CPU in the port; the
    tree's local translations are the body anchors in float32 in both."""
    args = (AMP_XML,) if fn in ("skeleton_from_mjcf", "generate_amp_humanoid_tpose") \
        else (FBX, 60.0)
    assert_same(getattr(jimp, fn)(*args), getattr(timp, fn)(*args), fn)


def _retarget_inputs(mocap, pkg):
    names, parents, local_rot, local_t, root_t, _ = mocap
    cls = pkg["sk"].SkeletonTree
    src_tree = cls(tuple(names), tuple(parents), local_t[0])
    tgt_tree, tgt_tpose, tgt_root = pkg["imp"].generate_amp_humanoid_tpose(AMP_XML)
    cfg = pkg["rt"].load_retarget_config(RETARGET_CFG)
    return (src_tree, local_rot[2:T + 2], root_t[2:T + 2], local_rot[0],
            tgt_tree, tgt_tpose, tgt_root, cfg["joint_mapping"], cfg["rotation"], cfg["scale"])


@pytest.mark.parametrize("stage", ["retarget_motion", "project_joints", "fix_ground_height"])
def test_retarget_matches_reference(mocap, stage):
    """The retarget tool's stages in its order on 120 frames of the CMU
    clip: retarget onto the AMP humanoid's T-pose, project the elbows and
    knees onto their hinges, ground the clip."""
    out = {}
    for name, pkg in (("jax", {"sk": jsk, "imp": jimp, "rt": jrt}),
                      ("port", {"sk": tsk, "imp": timp, "rt": trt})):
        inputs = _retarget_inputs(mocap, pkg)
        tgt_tree = inputs[4]
        lr, root = pkg["rt"].retarget_motion(*inputs)
        if stage != "retarget_motion":
            lr = pkg["rt"].project_joints(tgt_tree, lr, root)
        if stage == "fix_ground_height":
            root = pkg["rt"].fix_ground_height(tgt_tree, lr, root)
        out[name] = (lr, root)
    assert_same(out["jax"], out["port"], stage)


def test_retarget_config_and_clip_files_match_reference(tmp_path):
    assert_same(jrt.load_retarget_config(RETARGET_CFG), trt.load_retarget_config(RETARGET_CFG))
    tree, lr, root, fps, _, _ = jml.load_motion_npy(tpaths.default_clip())
    for name, rt, cls in (("jax", jrt, jsk.SkeletonTree), ("port", trt, tsk.SkeletonTree)):
        rt.save_motion_npy(str(tmp_path / f"{name}.npy"), _tree(tree, cls), lr[:20], root[:20], fps)
    assert_same(np.load(tmp_path / "jax.npy", allow_pickle=True).item(),
                np.load(tmp_path / "port.npy", allow_pickle=True).item())


def _fk_case(case):
    """(tree, local rotations, root translations, local translations or None)."""
    if case == "idle_clip":
        tree, lr, root, _, _, _ = jml.load_motion_npy(tpaths.default_clip())
        return tree, lr, root, None
    tree, _, _ = jimp.generate_amp_humanoid_tpose(AMP_XML)
    rng = np.random.default_rng(5)
    J = tree.num_joints
    q = rng.normal(size=(2, 3, J, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    root = rng.normal(size=(2, 3, 3)).astype(np.float32)
    lt = (tree.local_translation + 0.05 * rng.normal(size=(2, 3, J, 3))).astype(np.float32)
    return tree, q, root, lt


@pytest.mark.parametrize("case", ["idle_clip", "random_batch"])
def test_fk_and_global_to_local_match_reference(case):
    """``skeleton.fk`` (with the tree's or per-batch local translations)
    and ``global_to_local`` of its rotations against the JAX forms."""
    tree, lr, root, lt = _fk_case(case)
    jtree = _tree(tree, jsk.SkeletonTree)
    ttree = _tree(tree, tsk.SkeletonTree)
    jgr, jgt = jsk.fk(jtree, jnp.asarray(lr), jnp.asarray(root),
                      None if lt is None else jnp.asarray(lt))
    tgr, tgt = tsk.fk(ttree, torch.as_tensor(lr), torch.as_tensor(root),
                      None if lt is None else torch.as_tensor(lt))
    assert tgr.shape == lr.shape and tgt.shape == lr.shape[:-1] + (3,)
    np.testing.assert_allclose(tgr.numpy(), np.asarray(jgr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(jgt), rtol=0, atol=1e-5)
    jl = jsk.global_to_local(jtree, jgr)
    tl = tsk.global_to_local(ttree, tgr)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-6)
    # the round trip gives the input rotations back, up to the quaternion's sign
    sign = np.sign(np.sum(tl.numpy() * lr, axis=-1, keepdims=True))
    np.testing.assert_allclose(tl.numpy() * sign, lr, rtol=0, atol=1e-6)
    if lt is None:     # and the numpy loader form agrees
        ngr, ngt = tsk.np_fk(ttree, lr, root)
        np.testing.assert_allclose(tgt.numpy(), ngt, rtol=0, atol=1e-5)


def _run_ref_tool(module, argv, monkeypatch):
    """Run an ``ase_tpu`` tool's ``main`` on ``argv`` (its FBX importer reads
    ``sys.argv``)."""
    if module.__name__.endswith("fbx_importer"):
        monkeypatch.setattr(sys, "argv", [module.__name__] + argv)
        return module.main()
    return module.main(argv)


def _gif_frames(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


TOOLS = {
    "fbx_importer": lambda d: ["--fbx", FBX, "--out", str(d / "clip.npy"), "--fps", "60"],
    "mjcf_importer": lambda d: ["--mjcf", "mjcf/amp_humanoid.xml", "--output", str(d / "tree.npy")],
    "generate_amp_humanoid_tpose": lambda d: ["--output", str(d / "tpose.npy")],
    "retarget_motion": lambda d: ["--config", RETARGET_CFG, "--source", IMPORTED,
                                  "--output", str(d / "amp.npy")],
    "view_motion": lambda d: ["--motion", str(d.parent / "short.npy"), "--save", str(d / "v.gif")],
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_matches_reference(tool, tmp_path, monkeypatch):
    """Each tool of ``ase_tpu_torch.tools`` writes what the ``ase_tpu``
    tool writes from the same flags (the retarget config's T-pose paths are
    relative to the repository's root). The FBX import at 60 fps is the
    vendored ``09_11_cmu_imported.npy``; view_motion renders a 4-frame clip
    to the same GIF frames under Agg."""
    import importlib

    import matplotlib

    matplotlib.use("Agg")
    monkeypatch.chdir(jpaths.repo_root())
    tree, lr, root, fps, _, _ = jml.load_motion_npy(tpaths.default_clip())
    trt.save_motion_npy(str(tmp_path / "short.npy"), _tree(tree, tsk.SkeletonTree),
                        lr[:4], root[:4], fps)
    outs = {}
    for pkg in ("ase_tpu", "ase_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        module = importlib.import_module(f"{pkg}.tools.{tool}")
        if pkg == "ase_tpu":
            _run_ref_tool(module, TOOLS[tool](d), monkeypatch)
        else:
            module.main(TOOLS[tool](d))
        (out,) = os.listdir(d)
        outs[pkg] = d / out
    if tool == "view_motion":
        ref, got = (_gif_frames(outs[p]) for p in ("ase_tpu", "ase_tpu_torch"))
        assert len(ref) == len(got) == 4
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a, b)
        return
    ref, got = (np.load(outs[p], allow_pickle=True).item() for p in ("ase_tpu", "ase_tpu_torch"))
    assert_same(ref, got, tool)
    if tool == "fbx_importer":
        assert_same(np.load(IMPORTED, allow_pickle=True).item(), got, "vendored clip")


def test_default_clip_matches_reference():
    assert tpaths.default_clip() == jpaths.default_clip()
    assert os.path.isfile(tpaths.default_clip())


def test_fk_keeps_the_inputs_device_and_dtype():
    """No host round trip: every output is a tensor on the inputs' device."""
    tree, _, _ = timp.generate_amp_humanoid_tpose(AMP_XML)
    lr = torch.zeros(5, tree.num_joints, 4)
    lr[..., 3] = 1.0
    gr, gt = tsk.fk(tree, lr, torch.zeros(5, 3))
    assert gr.device == lr.device and gr.dtype == gt.dtype == torch.float32
    # the identity pose: global positions are the chained local offsets
    _, ngt = tsk.np_fk(tree, lr.numpy(), np.zeros((5, 3), np.float32))
    np.testing.assert_allclose(gt.numpy(), ngt, rtol=0, atol=1e-6)
