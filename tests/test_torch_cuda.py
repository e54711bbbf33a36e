"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA card and skip without one. The machine with the
card has no JAX, so this file imports none and is run without the
repository's conftest (which imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerance: 1e-4 of the largest magnitude of the plain result (the kernel
contracts multiply-adds into FMAs the eager version rounds twice).
"""

import copy

import numpy as np
import pytest
import torch

from ase_tpu_torch.ops import chol


def _system(n, m, m2, B, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(B, n, n)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)).transpose(1, 2, 0)
    return (np.ascontiguousarray(M, np.float32),
            rng.normal(size=(n, m, B)).astype(np.float32),
            rng.normal(size=(n, m2, B)).astype(np.float32))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest tests/test_torch_cuda.py "
                    "-m cuda --noconftest` on the chip")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,B", [(37, 72, 4096), (37, 72, 129), (8, 1, 256),
                                   (48, 72, 33), (37, 1, 4096)])
def test_kernels_match_plain_versions_on_the_card(cuda, n, m, B):
    """n = 37 runs the forward kernel's unrolled instance, other n its generic
    one; (48, 72, 33) is n at the kernel's limit with a ragged last block."""
    M, R, R2 = (torch.as_tensor(x, device=cuda) for x in _system(n, m, 1, B, seed=B))
    before = dict(chol.LAUNCHES)
    L, Y, Y2 = chol.chol_forward(M, R, R2)
    L1, Y1 = chol.chol_forward(M, R)
    x = chol.back_solve(L, Y2)
    torch.cuda.synchronize()
    assert chol.LAUNCHES["chol_forward2"] == before["chol_forward2"] + 1
    assert chol.LAUNCHES["chol_forward"] == before["chol_forward"] + 1
    assert chol.LAUNCHES["back_solve"] == before["back_solve"] + 1
    Lp, Yp, Y2p = chol.chol_forward_plain(M, R, R2)
    xp = chol.back_solve_plain(Lp, Y2p)
    for got, ref in ((L, Lp), (Y, Yp), (Y2, Y2p), (L1, Lp), (Y1, Yp), (x, xp)):
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,B,offset", [
    (37, 72, 4096, 0),   # many columns: every warp solves
    (37, 1, 129, 0),     # ragged B: 4-byte copies
    (37, 1, 36, 0),      # B % 4 == 0 with a partial last block: 16-byte copies
    (48, 72, 33, 0),     # generic instance at the kernel's n limit, ragged B
    (48, 1, 4096, 0),    # generic instance, 16-byte copies
    (37, 1, 4096, 1),    # L and y one float past a 16-byte boundary
    (37, 72, 129, 3),
])
def test_back_solve_matches_plain_version_on_the_card(cuda, n, m, B, offset):
    """back_solve at the shapes and alignments its launcher tells apart:
    16-byte staging copies need L 16-byte aligned and B % 4 == 0, anything
    else takes the 4-byte ones. ``offset`` floats in front of L and y make a
    contiguous view whose data_ptr is not 16-byte aligned."""
    M, R, _ = _system(n, m, 1, B, seed=n + m + B)
    L, _ = chol.chol_forward_plain(torch.as_tensor(M, device=cuda), torch.as_tensor(R, device=cuda))
    y = torch.as_tensor(R, device=cuda)
    if offset:
        L, y = (torch.cat([torch.zeros(offset, device=cuda), t.flatten()])[offset:].view(t.shape)
                for t in (L, y))
        assert L.is_contiguous() and L.data_ptr() % 16 != 0 and y.data_ptr() % 16 != 0
    before = chol.LAUNCHES["back_solve"]
    x = chol.back_solve(L, y)
    torch.cuda.synchronize()
    assert chol.LAUNCHES["back_solve"] == before + 1
    xp = chol.back_solve_plain(L, y)
    tol = 1e-4 * max(1.0, float(xp.abs().max()))
    assert float((x - xp).abs().max()) <= tol


@pytest.mark.cuda
def test_kernel_rejects_n_above_its_shared_memory_limit(cuda):
    M, R, _ = (torch.as_tensor(x, device=cuda) for x in _system(64, 2, 1, 32, seed=4))
    with pytest.raises(ValueError):
        chol.chol_forward(M, R)


@pytest.mark.cuda
def test_engine_tick_on_the_card_matches_the_cpu(cuda):
    """One engine tick at B = 8 through the kernels on the card and through
    the plain versions on the CPU, float32 contact solve on both: 1e-4 of
    scale on velocities, 5e-5 on positions (h = 1/120 s of that). The check
    is ``chip_smoke.check_tick``, which the smoke run also applies to the
    player's own states."""
    import chip_smoke
    from ase_tpu_torch.physics import dynamics, engine, mjcf
    from ase_tpu_torch.physics.solver import SolverConfig

    assert (chip_smoke.TICK_POS_TOL, chip_smoke.TICK_VEL_RTOL) == (5e-5, 1e-4)
    torch.backends.cuda.matmul.allow_tf32 = False
    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cpu")
    rng = np.random.default_rng(0)
    st = dynamics.default_state(model, 8)
    st = st._replace(root_pos=st.root_pos + torch.tensor([0.0, 0.0, 0.85]),
                     u=torch.as_tensor(rng.normal(size=(8, 37)).astype(np.float32)))
    act = torch.as_tensor(rng.uniform(-1, 1, (8, 31)).astype(np.float32))
    chip_smoke.check_tick(model, engine.SimConfig(solver=SolverConfig(matvec_bf16=False)),
                          st, act)


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["strike", "perturb"])
def test_prop_tick_on_the_card_matches_the_cpu(cuda, task):
    """One engine tick at B = 8 with free props, card vs CPU through
    ``chip_smoke.check_tick`` (props' poses held with the character's): the
    strike target standing on the plane, its side 3 cm into the sword hand,
    or a perturb projectile at 30 m/s 2 cm into the torso with a second one
    resting against it (the other 11 parked), the character at rest in its
    default pose with a random heading."""
    import chip_smoke
    from ase_tpu_torch.envs.humanoid_perturb import PERTURB_OBJS
    from ase_tpu_torch.physics import dynamics, dynamics2, engine, mjcf
    from ase_tpu_torch.physics.solver import SolverConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cpu")
    if task == "strike":
        props = [mjcf.box_prop([0.2, 0.2, 0.9], density=30.0)]
    else:
        props = [mjcf.box_prop([0.1] * 3, density=200.0) if k == "small"
                 else mjcf.box_prop([0.25] * 3, density=100.0) for k, _ in PERTURB_OBJS]
    model = mjcf.add_props(model, props)
    cfg = engine.SimConfig(solver=SolverConfig(matvec_bf16=False))
    rng = np.random.default_rng(1)
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, 8).astype(np.float32))
    zero = torch.zeros(8)
    st = dynamics.default_state(model, 8)
    st = st._replace(root_pos=st.root_pos + torch.tensor([0.0, 0.0, 0.9]),
                     root_quat=torch.stack([zero, zero, torch.sin(yaw / 2), torch.cos(yaw / 2)], -1))
    kin = dynamics2.fk_batched(model, engine.Tables(model, cfg).dyn, st)
    ang = torch.as_tensor(rng.uniform(0, 2 * np.pi, 8).astype(np.float32))
    out = torch.stack([torch.cos(ang), torch.sin(ang), zero], -1)
    pos, u = st.prop_pos.clone(), st.u.clone()
    if task == "strike":
        pos[:, 0] = kin.body_pos[:, model.body_index("right_hand")] + out * 0.21
        pos[:, 0, 2] = 0.895
    else:
        b = model.body_index("torso")
        pos[:] = torch.tensor([[200.0 + i, 0.0, 1.0] for i in range(model.num_props)])
        pos[:, 0] = kin.body_pos[:, b] + kin.body_R[:, b, :, 2] * 0.12 + out * 0.19
        pos[:, 1] = pos[:, 0] + out * 0.19 + torch.tensor([0.0, 0.0, 0.05])
        u[:, model.nu:model.nu + 3] = -30.0 * out
        u[:, model.nu + 3:model.nu + 6] = torch.as_tensor(rng.normal(size=(8, 3)).astype(np.float32))
    st = st._replace(prop_pos=pos, u=u)
    act = torch.as_tensor(rng.uniform(-0.5, 0.5, (8, 31)).astype(np.float32))
    errs = chip_smoke.check_tick(model, cfg, st, act)
    assert set(errs) >= {"prop_pos", "prop_quat"}


@pytest.mark.cuda
def test_pgs_tick_on_the_card_matches_the_cpu(cuda):
    """One engine tick at B = 8 under the PGS scheme (library Cholesky and
    triangular solves, the sequential sweep), card vs CPU through
    ``chip_smoke.check_tick``, which also holds the card tick to no
    Cholesky kernel launch; the state as the Jacobi tick's test, in
    contact."""
    import chip_smoke
    from ase_tpu_torch.physics import dynamics, engine, mjcf
    from ase_tpu_torch.physics.solver import SolverConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cpu")
    rng = np.random.default_rng(0)
    st = dynamics.default_state(model, 8)
    st = st._replace(root_pos=st.root_pos + torch.tensor([0.0, 0.0, 0.85]),
                     u=torch.as_tensor(rng.normal(size=(8, 37)).astype(np.float32)))
    act = torch.as_tensor(rng.uniform(-1, 1, (8, 31)).astype(np.float32))
    before = dict(chol.LAUNCHES)
    chip_smoke.check_tick(model, engine.SimConfig(solver=SolverConfig(scheme="pgs")), st, act)
    assert dict(chol.LAUNCHES) == before


@pytest.mark.cuda
def test_separate_encoder_forward_on_the_card_matches_the_cpu(cuda):
    """The shipped ase_humanoid.yaml's ASE network at its full widths with
    ``enc.separate`` (its enc units, 1024-1024-512): every head on the card
    within 1e-4 of the CPU's largest magnitude (float32 products summed in
    another order)."""
    import yaml

    from ase_tpu_torch.models import networks
    from ase_tpu_torch.utils import paths

    torch.backends.cuda.matmul.allow_tf32 = False
    with open(paths.data_path("cfg", "train/rlg/ase_humanoid.yaml")) as f:
        params = yaml.safe_load(f)["params"]
    params["network"]["enc"]["separate"] = True
    net = networks.build_ase_network(params, 253, 31, 1400, 64)
    assert net.enc_mlp is not None
    rng = np.random.default_rng(3)
    obs, amp = (torch.as_tensor(rng.normal(size=(256, d)).astype(np.float32)) for d in (253, 1400))
    z = networks.normalize_latents(torch.as_tensor(rng.normal(size=(256, 64)).astype(np.float32)))

    def heads(n, dev):
        n = n.to(dev)
        with torch.no_grad():
            o, zz, a = obs.to(dev), z.to(dev), amp.to(dev)
            return [n.eval_actor(o, zz)[0], n.eval_critic(o, zz), n.eval_disc(a), n.eval_enc(a)]

    cpu = heads(net, "cpu")
    for got, ref in zip(heads(copy.deepcopy(net), cuda), cpu):
        assert float((got.cpu() - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_motion_library_queries_on_the_card_match_the_cpu(cuda):
    """4096 random queries of the 87-clip dataset on the card and on the
    CPU: every field within 1e-5 (slerp decides its small-angle branch
    from a dot product summed in one fixed order on every device; a
    reduction sums in another order on the card, and one ulp of the dot
    can flip the branch)."""
    from ase_tpu_torch.motion import motion_lib as ml
    from ase_tpu_torch.physics import mjcf
    from ase_tpu_torch.utils import paths

    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cpu")
    path = paths.motion_file("reallusion_sword_shield/dataset_reallusion_sword_shield.yaml")
    key_ids = [model.body_index(b) for b in ("right_hand", "left_hand", "right_foot",
                                             "left_foot", "sword", "shield")]
    libs = {dev: ml.load_motion_lib(path, model.dof_body_ids, model.dof_offsets, key_ids,
                                    device=dev) for dev in ("cpu", "cuda")}
    gen = torch.Generator().manual_seed(0)
    ids = torch.randint(0, libs["cpu"].num_motions, (4096,), generator=gen)
    times = torch.rand(4096, generator=gen) * libs["cpu"].lengths[ids]
    ref = ml.get_motion_state(libs["cpu"], ids, times)
    got = ml.get_motion_state(libs["cuda"], ids.to(cuda), times.to(cuda))
    for k in ref:
        assert float((got[k].cpu() - ref[k]).abs().max()) <= 1e-5, k


@pytest.mark.cuda
def test_skeleton_fk_on_the_card_matches_the_cpu(cuda):
    """``skeleton.fk`` (tree and per-pose local translations) and
    ``global_to_local`` of 4096 random poses of the AMP humanoid's skeleton
    on the card and on the CPU: rotations within 1e-6, positions within
    1e-5 m (``chip_smoke``'s FK_ROT_TOL and FK_POS_TOL); the outputs stay
    on the card."""
    import chip_smoke
    from ase_tpu_torch.motion import importers
    from ase_tpu_torch.motion import skeleton as sk
    from ase_tpu_torch.utils import paths

    tree, _, _ = importers.generate_amp_humanoid_tpose(
        paths.data_path("assets", "mjcf", "amp_humanoid.xml"))
    rng = np.random.default_rng(6)
    J = tree.num_joints
    q = rng.normal(size=(4096, J, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    root = rng.normal(size=(4096, 3)).astype(np.float32)
    lt = (tree.local_translation + 0.05 * rng.normal(size=(4096, J, 3))).astype(np.float32)
    for local in (None, lt):
        args = [q, root] + ([] if local is None else [local])
        ref = sk.fk(tree, *(torch.as_tensor(a) for a in args))
        got = sk.fk(tree, *(torch.as_tensor(a, device=cuda) for a in args))
        assert all(t.device.type == "cuda" for t in got)
        for a, b, tol in zip(got, ref, (chip_smoke.FK_ROT_TOL, chip_smoke.FK_POS_TOL)):
            assert float((a.cpu() - b).abs().max()) <= tol
        back = sk.global_to_local(tree, got[0])
        assert float((back.cpu() - sk.global_to_local(tree, ref[0])).abs().max()) <= \
            chip_smoke.FK_ROT_TOL


def _amp_humanoid_cfg(tmp_path, num_envs, device):
    """The mocap workflow's env config: the vendored CMU clip imported and
    retargeted onto the AMP humanoid by the port's tools (into
    ``tmp_path``), HumanoidAMP on humanoid.yaml and amp_humanoid.yaml."""
    import chip_smoke
    from ase_tpu_torch.tools import fbx_importer, retarget_motion
    from ase_tpu_torch.utils import config as cfg_util

    imported, clip = str(tmp_path / "cmu.npy"), str(tmp_path / "cmu_amp.npy")
    fbx_importer.main(["--fbx", chip_smoke.MOCAP_FBX, "--out", imported, "--fps", "60"])
    retarget_motion.main(["--config", chip_smoke.RETARGET_CFG, "--source", imported,
                          "--output", clip])
    cfg, _ = cfg_util.load_cfg(cfg_util.get_args(
        chip_smoke.MOCAP_ARGV + ["--motion_file", clip, "--num_envs", str(num_envs),
                                 "--device", device]))
    return cfg


def _amp_humanoid_state(cfg, steps=4):
    """A CPU ``VecEnv`` on ``cfg`` after a reset and ``steps`` random steps,
    and the actions of one more."""
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.envs.vec_env import VecEnv

    vec = VecEnv(parse_task(cfg["name"], copy.deepcopy(cfg), device="cpu"))
    vec.reset()
    gen = torch.Generator().manual_seed(0)
    n, na = vec.task.num_envs, vec.task.get_action_size()
    for _ in range(steps):
        vec.step(torch.rand(n, na, generator=gen) * 2 - 1)
    return vec, torch.rand(n, na, generator=gen) * 2 - 1


@pytest.mark.cuda
def test_vec_env_step_on_amp_humanoid_on_the_card_matches_the_cpu(cuda, tmp_path, monkeypatch):
    """One ``VecEnv`` step of HumanoidAMP on the AMP humanoid (nu = 34, the
    Cholesky kernels' generic instance) at 8 envs, card vs CPU from the
    same state, through ``chip_smoke.check_vec_step`` (positions to 5e-5,
    velocities to 1e-4 of scale; 4 launches of each kernel on the card)."""
    import chip_smoke
    from ase_tpu_torch.utils import paths

    torch.backends.cuda.matmul.allow_tf32 = False
    monkeypatch.chdir(paths.repo_root())
    cfg = _amp_humanoid_cfg(tmp_path, 8, "cpu")
    vec, act = _amp_humanoid_state(cfg)
    assert vec.task.model.nu == 34
    chip_smoke.check_vec_step(cfg, vec.state, torch.arange(8), act)


def _small_ase_agent(device, mixed_precision=False):
    """An ASEAgent on 8 HumanoidAMPGetup envs with small widths (32-16,
    latent 8): the config of tests/test_learning.py's TRAIN_CFG, in float32
    or under mixed precision."""
    import yaml

    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.learning.ase_agent import ASEAgent
    from ase_tpu_torch.utils import paths

    with open(paths.data_path("cfg", "humanoid_ase_sword_shield_getup.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update({"numEnvs": 8, "resetChunk": 4,
                       "motion_file": "reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"})
    cfg["task"] = {"randomize": False}
    with open(paths.data_path("cfg", "train/rlg/ase_humanoid.yaml")) as f:
        cfg_train = yaml.safe_load(f)
    net = cfg_train["params"]["network"]
    net["mlp"]["units"] = net["disc"]["units"] = net["enc"]["units"] = [32, 16]
    cfg_train["params"]["seed"] = 7
    c = cfg_train["params"]["config"]
    c.update({"latent_dim": 8, "horizon_length": 4, "minibatch_size": 8,
              "learning_rate": 2e-4, "mixed_precision": mixed_precision})
    return ASEAgent(parse_task("HumanoidAMPGetup", cfg, device=device), cfg_train)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 256])
def test_minibatch_update_on_the_card_matches_the_cpu(cuda, rows):
    """One minibatch update (normalizer updates, PPO + discriminator with
    its second-order grad penalty + encoder + diversity losses, backward,
    Adam step) from the same weights, batch and draws on the card and on the
    CPU, against a float64 witness on the relu gates of the witness (each
    side's own gates may differ from them only within 1e-5 of a layer's
    largest pre-activation): losses within 1e-4 of max(1, |loss|); every
    gradient within 1e-4 of its tensor's largest from the witness's; each
    side's new weights within 1e-3 x lr of Adam's first step from its own
    gradients; new weights card vs CPU within 1e-2 x lr where |g| is above
    1e-4 of its tensor's largest. ``chip_smoke.check_minibatch`` applies the
    same check at the full widths in the smoke run."""
    import chip_smoke

    assert (chip_smoke.MB_LOSS_RTOL, chip_smoke.MB_GRAD_RTOL, chip_smoke.MB_GATE_RTOL,
            chip_smoke.MB_STEP_ATOL, chip_smoke.MB_W_ATOL, chip_smoke.MB_W_GMIN) == \
        (1e-4, 1e-4, 1e-5, 1e-3, 1e-2, 1e-4)
    torch.backends.cuda.matmul.allow_tf32 = False
    chip_smoke.check_minibatch(_small_ase_agent(cuda), rows=rows, seed=rows)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64, 256])
def test_bf16_minibatch_update_on_the_card_matches_the_cpu(cuda, rows):
    """One minibatch update under mixed precision (bfloat16 dense layers,
    float32 parameters, heads and losses) from the same weights, batch and
    draws on the card and on the CPU, the card on the CPU's relu gates
    (its own may differ only within 2^-5 of a layer's largest
    pre-activation), rows whose policy means differ left out of the actor
    terms: policy means within 2^-6 of their largest, losses within 2^-8 of
    max(1, |loss|), every gradient within 2^-5 of its tensor's largest (a
    bias also within 2^-6 of its layer's sum of |cotangent|).
    ``chip_smoke.check_minibatch_bf16`` applies the same check at the full
    widths in the smoke run, where its docstring gives the rounding
    argument."""
    import chip_smoke

    assert (chip_smoke.MB16_FWD_RTOL, chip_smoke.MB16_LOSS_RTOL, chip_smoke.MB16_GRAD_RTOL,
            chip_smoke.MB16_ROW_RTOL, chip_smoke.MB16_GATE_RTOL) == \
        (2.0 ** -6, 2.0 ** -8, 2.0 ** -5, 2.0 ** -6, 2.0 ** -5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    chip_smoke.check_minibatch_bf16(_small_ase_agent(cuda, mixed_precision=True), rows=rows,
                                    seed=rows)


@pytest.mark.cuda
def test_dr_tick_on_the_card_matches_the_cpu(cuda):
    """One engine tick at B = 8 with every domain-randomization knob away
    from its base (friction per shape, PD gain and damping per dof, mass
    per body, gravity, restitution 0.3-0.9 and actor scale 0.9-1.1), the
    characters in their default pose falling at 0.5-1.5 m/s onto the plane
    so that restitution bounces the feet: card vs CPU through
    ``chip_smoke.check_tick`` at its tolerances."""
    import chip_smoke
    from ase_tpu_torch.physics import dynamics, engine, mjcf
    from ase_tpu_torch.physics.solver import SolverConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cpu")
    rng = np.random.default_rng(2)
    B, nb, nd = 8, model.nb + model.num_props, model.nd
    yaw = torch.as_tensor(rng.uniform(-np.pi, np.pi, B).astype(np.float32))
    zero = torch.zeros(B)
    st = dynamics.default_state(model, B)
    u = st.u.clone()
    u[:, 2] = -torch.as_tensor(rng.uniform(0.5, 1.5, B).astype(np.float32))
    st = st._replace(root_pos=st.root_pos + torch.tensor([0.0, 0.0, 0.88]),
                     root_quat=torch.stack([zero, zero, torch.sin(yaw / 2), torch.cos(yaw / 2)],
                                           -1), u=u)

    def uni(lo, hi, *shape):
        return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32))

    knobs = {"friction_scale": uni(0.05, 1.3, B, nb), "gain_scale": uni(0.5, 1.5, B, nd),
             "mass_scale": uni(0.6, 1.4, B, model.nb), "gravity_scale": uni(0.5, 1.5, B),
             "damping_scale": uni(0.1, 3.0, B, nd), "restitution": uni(0.3, 0.9, B),
             "actor_scale": uni(0.9, 1.1, B)}
    act = uni(-0.5, 0.5, B, 31)
    chip_smoke.check_tick(model, engine.SimConfig(solver=SolverConfig(matvec_bf16=False)),
                          st, act, knobs)


@pytest.mark.cuda
def test_gloo_group_stages_cuda_tensors_through_the_host(cuda, monkeypatch):
    """A gloo group carrying CUDA tensors (how two ranks share one card:
    NCCL refuses two ranks on one device) stages each collective through
    host memory; the results come back on the card. World 1, this process."""
    import socket

    import torch.distributed as dist
    from ase_tpu_torch.parallel import mesh as mesh_lib

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}.items():
        monkeypatch.setenv(k, v)
    mesh = mesh_lib.init(backend="gloo")
    try:
        assert mesh.staged and mesh.device == torch.device("cuda", 0)
        assert dist.get_backend() == "gloo"
        x = torch.arange(6.0, device=cuda).reshape(3, 2)
        ints = torch.tensor([[1 << 40, -3]], dtype=torch.int64, device=cuda)
        for got, want in ((mesh.all_reduce_sum(x), x), (mesh.all_gather_rows(x), x),
                          (mesh.broadcast(x), x), (mesh.all_gather_rows(ints), ints)):
            assert got.device == want.device and torch.equal(got, want)
    finally:
        mesh.close()


# The minibatch checks themselves, on the CPU (their "card" side on the CPU too).

@pytest.fixture(scope="module")
def small_cpu_agent():
    torch.set_num_threads(1)
    return _small_ase_agent(torch.device("cpu"))


def test_minibatch_check_passes_on_the_cpu(small_cpu_agent):
    """The check's witness and gate alignment hold float32 against float64
    at the tolerances the card test uses."""
    import chip_smoke

    loss_err, grad_err, _ = chip_smoke.check_minibatch(small_cpu_agent, rows=64, seed=64,
                                                        device="cpu")
    assert loss_err == 0.0 and grad_err <= chip_smoke.MB_GRAD_RTOL


@pytest.mark.parametrize("fault", ["first_order_grad_penalty", "scaled_gradient"])
def test_minibatch_check_catches_a_wrong_gradient(small_cpu_agent, monkeypatch, fault):
    """A float32 side whose grad penalty stops at first order, or whose
    discriminator-logit gradient is 1% off, fails the check, although its
    Adam step follows its gradients and its first step moves every weight
    by about lr either way."""
    import chip_smoke

    if fault == "first_order_grad_penalty":
        grad = torch.autograd.grad

        def first_order(outputs, inputs, **kw):
            if inputs.dtype == torch.float32:
                kw.update(create_graph=False, retain_graph=True)
            return grad(outputs, inputs, **kw)

        monkeypatch.setattr(torch.autograd, "grad", first_order)
    else:
        twin = chip_smoke._twin

        def scaled(agent, device, z, dtype=None):
            t = twin(agent, device, z, dtype)
            if dtype == torch.float32:
                t.network.disc_logits.weight.register_hook(lambda g: g * 1.01)
            return t

        monkeypatch.setattr(chip_smoke, "_twin", scaled)
    with pytest.raises(chip_smoke.Failed, match="gradient of"):
        chip_smoke.check_minibatch(small_cpu_agent, rows=64, seed=64, device="cpu")


@pytest.fixture(scope="module")
def small_bf16_cpu_agent():
    torch.set_num_threads(1)
    return _small_ase_agent(torch.device("cpu"), mixed_precision=True)


def test_bf16_minibatch_check_passes_on_the_cpu(small_bf16_cpu_agent):
    """With both sides on the CPU the bf16 check's sides run the same
    roundings: no gate flips, losses and gradients equal."""
    import chip_smoke

    loss_err, grad_err, flips = chip_smoke.check_minibatch_bf16(small_bf16_cpu_agent, rows=64,
                                                                seed=64, device="cpu")
    assert (loss_err, grad_err, flips) == (0.0, 0.0, 0)


def test_bf16_minibatch_check_catches_a_wrong_gradient(small_bf16_cpu_agent, monkeypatch):
    """A second side whose discriminator-logit gradient is 10% off (four
    bf16 ulps are 3.1%) fails the bf16 check."""
    import chip_smoke

    twin, made = chip_smoke._twin, []

    def scaled(agent, device, z, dtype=None):
        t = twin(agent, device, z, dtype)
        made.append(t)
        if len(made) > 4:      # the case, both sides' policy means and the CPU side stay right
            t.network.disc_logits.weight.register_hook(lambda g: g * 1.1)
        return t

    monkeypatch.setattr(chip_smoke, "_twin", scaled)
    with pytest.raises(chip_smoke.Failed, match="beyond their bounds: disc_logits.weight"):
        chip_smoke.check_minibatch_bf16(small_bf16_cpu_agent, rows=64, seed=64, device="cpu")


def test_vec_step_check_passes_on_the_cpu(tmp_path, monkeypatch):
    """``chip_smoke.check_vec_step`` with its card side on the CPU: the
    state carried into fresh adapters steps identically, and the CPU side
    launches no kernel."""
    import chip_smoke
    from ase_tpu_torch.utils import paths

    torch.set_num_threads(1)
    monkeypatch.chdir(paths.repo_root())
    cfg = _amp_humanoid_cfg(tmp_path, 4, "cpu")
    vec, act = _amp_humanoid_state(cfg, steps=2)
    errs = chip_smoke.check_vec_step(cfg, vec.state, torch.arange(1, 4), act[1:], device="cpu")
    assert set(errs.values()) == {0.0}


@pytest.mark.cuda
@pytest.mark.parametrize("n,m,B", [(37, 72, 1), (1, 9, 1), (1, 9, 33), (1, 1, 4096)])
def test_kernels_at_one_env_and_n_one_match_plain_versions_on_the_card(cuda, n, m, B):
    """The shapes the one-env ``engine.step`` gives the kernels: B = 1 (one
    live lane in the block; back_solve's 4-byte copies) at the engine's
    n = 37, and the pendulum's n = 1 (the generic instances' column loops
    at their smallest)."""
    M, R, R2 = (torch.as_tensor(x, device=cuda) for x in _system(n, m, 1, B, seed=n + B))
    before = dict(chol.LAUNCHES)
    L, Y, Y2 = chol.chol_forward(M, R, R2)
    x = chol.back_solve(L, Y2)
    torch.cuda.synchronize()
    assert chol.LAUNCHES["chol_forward2"] == before["chol_forward2"] + 1
    assert chol.LAUNCHES["back_solve"] == before["back_solve"] + 1
    Lp, Yp, Y2p = chol.chol_forward_plain(M, R, R2)
    xp = chol.back_solve_plain(Lp, Y2p)
    for got, ref in ((L, Lp), (Y, Yp), (Y2, Y2p), (x, xp)):
        tol = 1e-4 * max(1.0, float(ref.abs().max()))
        assert float((got - ref).abs().max()) <= tol


@pytest.mark.cuda
def test_one_env_step_on_the_card_matches_the_cpu(cuda):
    """``engine.step`` (B = 1) for 3 ticks on the card, each tick held to the
    CPU's from the same state at ``check_tick``'s tolerances
    (``chip_smoke.check_one_env_steps``): 2 launches of chol_forward2 and of
    back_solve a tick."""
    import chip_smoke
    from ase_tpu_torch.physics import dynamics, engine, mjcf

    torch.backends.cuda.matmul.allow_tf32 = False
    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cpu")
    st = dynamics.default_state(model)._replace(root_pos=torch.tensor([0.0, 0.0, 0.9]))
    acts = [torch.full((31,), 0.1 * k) for k in range(3)]
    launched, _ = chip_smoke.check_one_env_steps(model, engine.SimConfig(), st, acts)
    assert launched == {"chol_forward2": 6, "back_solve": 6, "chol_forward": 0}


@pytest.mark.cuda
def test_pendulum_on_the_card_keeps_its_period_and_energy(cuda):
    """tests/test_physics.py:125's pendulum (n = 1, B = 1) through the kernels."""
    import chip_smoke

    before = dict(chol.LAUNCHES)
    chip_smoke.pendulum_check("cuda")
    assert chol.LAUNCHES["chol_forward2"] - before["chol_forward2"] == chip_smoke.PENDULUM_TICKS


def test_oracle_check_passes_on_the_cpu():
    """``chip_smoke.check_oracle`` (the AoS oracles against the batched
    forms) with the model on the CPU, at 8 poses."""
    import chip_smoke
    from ase_tpu_torch.physics import mjcf

    torch.set_num_threads(1)
    model = mjcf.load_mjcf(mjcf.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"),
                           device="cpu")
    errs = chip_smoke.check_oracle(model, 8)
    assert errs["contacts depth"] <= chip_smoke.ORACLE_DEPTH_TOL
    assert errs["contacts normal"] <= chip_smoke.ORACLE_ATTR_TOL


def test_oracle_contact_comparison_catches_a_moved_contact():
    """``chip_smoke._rank_matched`` reports a normal that differs at a
    matching rank, and leaves out ranks whose depths tie."""
    import chip_smoke
    from ase_tpu_torch.physics.collision import Contacts

    depth = torch.tensor([[0.3, 0.1, 0.1 + 1e-6, 0.0]])
    normal = torch.tensor([[[0.0, 0.0, 1.0]] * 4])
    c = Contacts(pos=torch.zeros(1, 4, 3), normal=normal, depth=depth,
                 body_a=torch.zeros(1, 4, dtype=torch.long),
                 body_b=torch.zeros(1, 4, dtype=torch.long), friction=torch.ones(1, 4))
    errs, left = chip_smoke._rank_matched(c, c)
    assert errs["depth"] == 0.0 and errs["normal"] == (0.0, 0.0) and left == 2
    assert errs["normal count"] == 0
    moved = c._replace(normal=torch.tensor([[[1.0, 0.0, 0.0]] + [[0.0, 0.0, 1.0]] * 3]))
    errs, _ = chip_smoke._rank_matched(c, moved)
    assert errs["normal"] == (1.0, 1.0)      # one contact compared: no share to spare
