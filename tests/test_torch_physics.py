"""Port parity for the physics layer: MJCF model, static tables, FK,
batch-last dynamics, the narrow phase and the engine tick.

Inputs are built with numpy from a seed and handed to ase_tpu and to
ase_tpu_torch on the CPU (B = 8, the sword-shield humanoid, self-collision
on, K = 24). The engine compares float32 with float32: both sides run the
contact solve with ``matvec_bf16=False``.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.physics import collision2 as jc2
from ase_tpu.physics import collision3 as jc3
from ase_tpu.physics import dynamics as jd
from ase_tpu.physics import dynamics2 as jd2
from ase_tpu.physics import engine as je
from ase_tpu.physics import mjcf as jm
from ase_tpu.physics import solver as jsol
from ase_tpu_torch.physics import collision3 as tc3
from ase_tpu_torch.physics import dynamics as td
from ase_tpu_torch.physics import dynamics2 as td2
from ase_tpu_torch.physics import engine as te
from ase_tpu_torch.physics import mjcf as tm
from ase_tpu_torch.physics.solver import SolverConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs B <= 16 here: intra-op threads would only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 8
ASSET = "mjcf/amp_humanoid_sword_shield.xml"


@pytest.fixture(scope="module")
def models():
    path = tm.find_asset("", ASSET)
    return jm.load_mjcf(path), tm.load_mjcf(path, device="cpu")


@pytest.fixture(scope="module")
def tables(models):
    jmodel, tmodel = models
    return jc2.build_tables(jmodel, True), te.Tables(tmodel, te.SimConfig())


def random_state(models, seed, height=(0.2, 0.9), vel=1.0):
    """Numpy state: random root pose near the ground, perturbed joints,
    random velocities. Returns (jax State, torch State)."""
    jmodel, _ = models
    rng = np.random.default_rng(seed)
    ns, nh = len(jd.sph_ids(jmodel)), len(jd.hinge_ids(jmodel))
    q = rng.normal(size=(B, 4))
    jq = np.concatenate([rng.normal(scale=0.3, size=(B, ns, 3)), np.ones((B, ns, 1))], -1)
    s = dict(
        root_pos=np.stack([rng.normal(scale=0.3, size=B), rng.normal(scale=0.3, size=B),
                           rng.uniform(*height, B)], -1),
        root_quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
        joint_q=jq / np.linalg.norm(jq, axis=-1, keepdims=True),
        hinge_q=rng.normal(scale=0.5, size=(B, nh)),
        u=rng.normal(scale=vel, size=(B, jmodel.nv)),
        prop_pos=np.zeros((B, 0, 3)), prop_quat=np.zeros((B, 0, 4)),
    )
    s = {k: v.astype(np.float32) for k, v in s.items()}
    return (jd.State(**{k: jnp.asarray(v) for k, v in s.items()}),
            td.State(**{k: torch.as_tensor(v) for k, v in s.items()}))


def close(ref, got, atol, rtol_scale=0.0):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64) if isinstance(got, torch.Tensor) else np.asarray(got)
    tol = atol + rtol_scale * float(np.abs(ref).max())
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    assert err <= tol, (err, tol)


def test_model_matches_reference(models):
    jmodel, tmodel = models
    for f in ("body_names", "parents", "jtype", "dof_offset", "nu", "dof_body_ids",
              "dof_offsets", "num_props", "geom_types", "geom_body"):
        assert getattr(tmodel, f) == getattr(jmodel, f), f
    for f in ("body_ipos", "body_iquat", "joint_axis", "mass", "com", "inertia",
              "stiffness", "damping", "armature", "dof_limit_lo", "dof_limit_hi",
              "motor_gear", "geom_pos", "geom_quat", "geom_size", "geom_friction",
              "gravity", "plane_friction", "ang_damping", "max_ang_vel"):
        np.testing.assert_array_equal(tmodel.np(f), np.asarray(getattr(jmodel, f)), f)
    assert (tmodel.nb, tmodel.nu, tmodel.nd) == (17, 37, 31)


def test_static_tables_match_reference(models, tables):
    jmodel, tmodel = models
    jt, tt = tables
    for f in jc3.SoATables._fields:
        np.testing.assert_allclose(getattr(tt.soa, f), np.asarray(getattr(jt.soa, f)),
                                   atol=1e-7, err_msg=f)
    np.testing.assert_array_equal(tt.Amask.numpy(), jd.ancestor_mask(jmodel))
    assert td.sph_ids(tmodel) == jd.sph_ids(jmodel)
    assert td.hinge_ids(tmodel) == jd.hinge_ids(jmodel)


@pytest.mark.parametrize("seed", [0, 1])
def test_fk_and_dynamics_match_reference(models, tables, seed):
    """fk_batched and compute_dynamics_batch_last: float32 assembly in a
    different order; 2e-6 absolute on unit-scale kinematics, 1e-6 of the
    largest entry on M, bias and Phi."""
    jmodel, tmodel = models
    js, ts = random_state(models, seed)
    T = tables[1]
    jk = jd2.fk_batched(jmodel, js)
    tk = td2.fk_batched(tmodel, T.dyn, ts)
    for f in jk._fields:
        close(getattr(jk, f), getattr(tk, f), 2e-6, 1e-6)
    h = 1.0 / 120.0
    for ref, got in zip(jd2.compute_dynamics_batch_last(jmodel, js, jk, h),
                        td2.compute_dynamics_batch_last(tmodel, T.dyn, ts, tk, T.diag)):
        close(ref, got, 0.0, 1e-6)


def test_pd_and_limit_torques_match_reference(models, tables):
    jmodel, tmodel = models
    js, ts = random_state(models, 5)
    tgt = np.random.default_rng(5).uniform(-1.5, 1.5, size=(B, 31)).astype(np.float32)
    close(jd.pd_torques_batched(jmodel, js, jnp.asarray(tgt), 1 / 120),
          td.pd_torques_batched(tmodel, tables[1].dof, ts, torch.as_tensor(tgt), 1 / 120),
          0.0, 1e-6)
    close(jd.limit_torques_batched(jmodel, js), td.limit_torques_batched(tmodel, tables[1].dof, ts),
          0.0, 1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_contact_sets_match_reference(models, tables, seed):
    """detect_batched on random poses near the ground with self-collision
    on: the same K=24 contacts in the same slots (depth, normal, point,
    friction, body ids)."""
    jmodel, tmodel = models
    jt, tt = tables
    js, ts = random_state(models, 10 + seed, height=(0.1, 0.5))
    jk = jd2.fk_batched(jmodel, js)
    tk = td2.fk_batched(tmodel, tt.dyn, ts)
    jc = jc3.detect_batched(jmodel, jt.soa, jk.body_quat, jk.body_pos, js.prop_quat,
                            js.prop_pos, 24, margin=0.02)
    tc = tc3.detect_batched(tt.detect, tk.body_quat, tk.body_pos, ts.prop_quat, ts.prop_pos, 24,
                            margin=0.02)
    assert int((np.asarray(jc.depth) > 0).sum()) > B        # real contacts present
    assert int((np.asarray(jc.body_b) >= 0).sum() - (np.asarray(jc.depth) != 0).sum()) <= B * 24
    np.testing.assert_array_equal(tc.body_a.numpy(), np.asarray(jc.body_a))
    np.testing.assert_array_equal(tc.body_b.numpy(), np.asarray(jc.body_b))
    for f in ("pos", "normal", "depth", "friction"):
        close(getattr(jc, f), getattr(tc, f), 2e-6)
    # self-collision pairs reached the selection
    ba, bb = tc.body_a.numpy(), tc.body_b.numpy()
    assert tt.detect.num_candidates == int(jt.soa.pl_geom.size + jt.soa.ss_i.size
                                           + jt.soa.sc_s.size + jt.soa.cc_i.size
                                           + jt.soa.bo_box.size + jt.soa.bb_src.size)
    assert ((ba >= 0) & (bb >= 0) & (ba != bb)).any() or seed != 0


def _f32_configs():
    return (je.SimConfig(solver=jsol.SolverConfig(matvec_bf16=False)),
            te.SimConfig(solver=SolverConfig(matvec_bf16=False)))


@pytest.fixture(scope="module")
def jax_step(models, tables):
    jcfg, _ = _f32_configs()
    return jax.jit(partial(je.step_batched, models[0], jcfg, tables[0]))


def test_one_tick_matches_reference(models, tables, jax_step):
    """One engine tick at B = 8 from a random state with contacts, float32
    on both sides: velocities and contact forces to 1e-4 of their largest
    magnitude (the contact solve sums in another order); positions and
    quaternions, which integrate those velocities over h = 1/120 s (up to
    1e-4 x 64 / 120 ~ 5e-5), to 5e-5."""
    _, tcfg = _f32_configs()
    js, ts = random_state(models, 21, height=(0.2, 0.6))
    act = np.random.default_rng(21).uniform(-1, 1, size=(B, 31)).astype(np.float32)
    jo = jax_step(js, jnp.asarray(act))
    to = te.step_batched(models[1], tcfg, tables[1], ts, torch.as_tensor(act))
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
        close(getattr(jo.state, f), getattr(to.state, f), 5e-5)
    close(jo.state.u, to.state.u, 0.0, 1e-4)
    close(jo.contact_forces, to.contact_forces, 0.0, 1e-4)
    close(jo.body_pos, to.body_pos, 5e-5)
    close(jo.dof_forces, to.dof_forces, 0.0, 1e-4)


def test_short_rollout_matches_reference(models, tables, jax_step):
    """20 ticks of a gentle drop (near-default pose, zero velocity, fixed
    PD targets). Looser tolerance: a contact entering or leaving the
    K-budget on one side a tick before the other changes that tick's
    impulses, and float32 differences grow over a rollout, so body
    positions are held to 1e-3 m and velocities to 2e-2 of their scale."""
    _, tcfg = _f32_configs()
    js, ts = random_state(models, 33, height=(0.89, 0.95), vel=0.0)
    rng = np.random.default_rng(33)
    q = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (B, 1))
    js = js._replace(root_quat=jnp.asarray(q))
    ts = ts._replace(root_quat=torch.as_tensor(q))
    act = rng.uniform(-0.3, 0.3, size=(B, 31)).astype(np.float32)
    kin = None
    for _ in range(20):
        jo = jax_step(js, jnp.asarray(act))
        to = te.step_batched(models[1], tcfg, tables[1], ts, torch.as_tensor(act), kin0=kin)
        js, ts, kin = jo.state, to.state, to.kin
    close(jo.body_pos, to.body_pos, 1e-3)
    close(jo.state.u, to.state.u, 0.0, 2e-2)
    assert float(to.body_pos[:, 0, 2].max()) < 0.95      # it fell and touched down
