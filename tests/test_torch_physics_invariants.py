"""The reference's physics invariants (``tests/test_physics.py``) on the port:
free fall, standing stability, the dof-view round trip, a symmetric
positive-definite mass matrix, FK velocities equal to Phi u, the pendulum's
energy and period, the self-collision stress run and the joint-batched
actuation against the joint loops, each through the port's ``engine.step``
(or its batched helpers) under the reference's bounds. Random inputs come
from numpy (the reference draws its own with ``jax.random``); these are
invariants, not parity checks, so nothing of ``ase_tpu`` runs here.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from ase_tpu_torch.physics import dynamics, engine, mjcf

ASSET = "mjcf/amp_humanoid_sword_shield.xml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One env or four: intra-op threads would only contend with the other
    test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def humanoid():
    return mjcf.load_mjcf(mjcf.find_asset("", ASSET), device="cpu")


@pytest.fixture(scope="module")
def stepper(humanoid):
    cfg = engine.SimConfig(enable_self_collision=False, max_contacts=24)
    tables = engine.Tables(humanoid, cfg)
    return lambda s, a: engine.step(humanoid, cfg, tables, s, a)


def _normal(seed, *shape, scale=1.0):
    return torch.as_tensor(scale * np.random.default_rng(seed).normal(size=shape),
                           dtype=torch.float32)


def test_model_matches_reference_dof_tables(humanoid):
    # the reference's humanoid.py:190-195
    assert humanoid.dof_body_ids == (1, 2, 3, 4, 5, 7, 8, 11, 12, 13, 14, 15, 16)
    assert humanoid.dof_offsets == (0, 3, 6, 9, 10, 13, 16, 17, 20, 21, 24, 27, 28, 31)
    assert humanoid.nd == 31
    assert humanoid.nb == 17


def test_free_fall(humanoid, stepper):
    s = dynamics.default_state(humanoid)._replace(root_pos=torch.tensor([0.0, 0.0, 50.0]))
    n = 30
    for _ in range(n):
        s = stepper(s, torch.zeros(humanoid.nd)).state
    # semi-implicit Euler at the substep rate: z = z0 - g h^2 (1 + 2 + ... + N)
    h = (1.0 / 60.0) / 2
    N = n * 2
    expected = 50.0 - 9.81 * h * h * (N * (N + 1) / 2)
    np.testing.assert_allclose(float(s.root_pos[2]), expected, atol=1e-3)
    np.testing.assert_allclose(float(s.u[2]), -9.81 * h * N, atol=1e-3)


def test_standing_stability(humanoid, stepper):
    s = dynamics.default_state(humanoid)._replace(root_pos=torch.tensor([0.0, 0.0, 0.89]))
    out = None
    for _ in range(120):
        out = stepper(s, torch.zeros(humanoid.nd))
        s = out.state
    assert bool(torch.isfinite(s.u).all())
    assert 0.8 < float(s.root_pos[2]) < 0.95, "humanoid should remain standing"
    assert float(s.u.abs().max()) < 0.5, "should come to rest"
    total_fz = float(out.contact_forces[:, 2].sum())
    weight = float(humanoid.mass.sum()) * 9.81
    np.testing.assert_allclose(total_fz, weight, rtol=0.05)


def test_dof_state_roundtrip(humanoid):
    st = dynamics.default_state(humanoid)
    dp = _normal(0, humanoid.nd, scale=0.4)
    dv = _normal(1, humanoid.nd)
    st2 = dynamics.set_dof_state(humanoid, st, dp, dv)
    np.testing.assert_allclose(dynamics.dof_pos(humanoid, st2).numpy(), dp.numpy(), atol=1e-4)
    np.testing.assert_allclose(dynamics.dof_vel(humanoid, st2).numpy(), dv.numpy(), atol=1e-6)


def test_mass_matrix_symmetric_posdef(humanoid):
    st = dynamics.set_dof_state(humanoid, dynamics.default_state(humanoid),
                                _normal(2, humanoid.nd, scale=0.3), torch.zeros(humanoid.nd))
    kin = dynamics.fk(humanoid, st)
    Mm = dynamics.compute_dynamics(humanoid, st, kin, 1.0 / 120.0).Mmat.numpy()
    np.testing.assert_allclose(Mm, Mm.T, atol=1e-4)
    eig = np.linalg.eigvalsh(Mm)
    assert eig.min() > 0, f"mass matrix not PD, min eig {eig.min()}"
    # the total mass appears in the translational block
    np.testing.assert_allclose(Mm[0, 0], float(humanoid.mass.sum()), rtol=1e-3)


def test_velocity_fk_consistency(humanoid):
    """Body velocities from FK equal Phi u (Jacobian consistency)."""
    st = dynamics.set_dof_state(humanoid, dynamics.default_state(humanoid),
                                _normal(3, humanoid.nd, scale=0.3), _normal(4, humanoid.nd))
    st = dynamics.set_root_state(st, torch.tensor([0.1, -0.2, 1.0]), st.root_quat,
                                 torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.3, -0.2, 0.1]))
    kin = dynamics.fk(humanoid, st)
    Phi, _ = dynamics.motion_subspace(humanoid, kin, st.root_pos)
    A = dynamics.ancestor_mask(humanoid)
    u = st.u[:humanoid.nu].numpy()
    v_sp = np.einsum("bd,dk->bk", A, Phi.numpy() * u[:, None])
    for b in range(humanoid.nb):
        w_fk = kin.body_vel[b, 0:3].numpy()
        v_fk_origin = kin.body_vel[b, 3:6].numpy()
        # the spatial velocity at the root's reference point -> the body origin's
        lever = (st.root_pos - kin.body_pos[b]).numpy()
        v_at_origin = v_sp[b, 3:6] - np.cross(v_sp[b, 0:3], lever)
        np.testing.assert_allclose(v_sp[b, 0:3], w_fk, atol=1e-4)
        np.testing.assert_allclose(v_at_origin, v_fk_origin, atol=1e-4)


PENDULUM = """
<mujoco model="pend">
  <worldbody>
    <body name="anchor" pos="0 0 2">
      <geom type="sphere" size="0.01" density="100"/>
      <body name="rod" pos="0 0 0">
        <joint name="swing" type="hinge" axis="0 1 0" range="-180 180"
               stiffness="0" damping="0" armature="0"/>
        <geom type="capsule" fromto="0 0 0 0 0 -1.0" size="0.02" density="1000"/>
      </body>
    </body>
  </worldbody>
</mujoco>
"""
PENDULUM_TICKS = 1400
PENDULUM_DT = 1.0 / 600.0


def pendulum_model(device="cpu"):
    """The reference's single-hinge pendulum: a fixed base (n = 1)."""
    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(PENDULUM)
        path = f.name
    try:
        return mjcf.load_mjcf(path, device=device)
    finally:
        os.unlink(path)


def pendulum_swing(m, ticks=PENDULUM_TICKS, theta0=0.1):
    """The hinge angle after each of ``ticks`` ticks from rest at ``theta0``
    (undamped, no contacts, torque control at zero torque), on the model's
    device."""
    cfg = engine.SimConfig(dt=PENDULUM_DT, substeps=1, enable_self_collision=False,
                           max_contacts=4, torque_control=True)
    tables = engine.Tables(m, cfg)
    dev = m.device
    s = dynamics.set_dof_state(m, dynamics.default_state(m), torch.tensor([theta0], device=dev),
                               torch.zeros(1, device=dev))
    zero = torch.zeros(m.nd, device=dev)
    thetas = []
    for _ in range(ticks):
        s = engine.step(m, cfg, tables, s, zero).state
        thetas.append(dynamics.dof_pos(m, s)[0])
    return torch.stack(thetas).cpu().numpy()


def pendulum_bounds(m, thetas):
    """(period, analytic period, late amplitude, early amplitude): the
    reference's test holds the period to 5% of the small-angle physical
    pendulum's and the amplitude of the last 400 ticks to 10% of the
    first 400's."""
    centered = thetas - thetas.mean()
    crossings = np.where(np.diff(np.sign(centered)) != 0)[0]
    assert len(crossings) >= 2, "pendulum did not oscillate"
    period = 2.0 * np.diff(crossings).mean() * PENDULUM_DT
    mass = float(m.mass[1])
    com_d = abs(float(m.com[1][2]))
    I_p = float(m.inertia[1][1, 1]) + mass * com_d ** 2
    T_analytic = 2 * np.pi * np.sqrt(I_p / (mass * 9.81 * com_d))
    return period, T_analytic, np.abs(centered[-400:]).max(), np.abs(centered[:400]).max()


def test_pendulum_energy():
    """A single-hinge pendulum conserves energy with no damping or contacts
    and matches the analytic small-angle period."""
    m = pendulum_model()
    assert (m.nu, m.root_dofs) == (1, 0)
    period, T_analytic, late, early = pendulum_bounds(m, pendulum_swing(m))
    np.testing.assert_allclose(period, T_analytic, rtol=0.05)
    np.testing.assert_allclose(late, early, rtol=0.1)


def test_random_action_stress_self_collision(humanoid):
    """Self-collision must not pump joint velocities past the explicit
    integrator's stability limit: the per-substep dof rate clamp
    (``SimConfig.max_dof_vel``) bounds them."""
    cfg = engine.SimConfig(enable_self_collision=True, max_contacts=24)
    bstep = engine.make_batched_step(humanoid, cfg)
    B = 4
    st = engine.batch_default_state(humanoid, B)
    root_pos = st.root_pos.clone()
    root_pos[:, 2] = 0.89
    st = st._replace(root_pos=root_pos)
    lo, hi = humanoid.dof_limit_lo, humanoid.dof_limit_hi
    off, sc = (hi + lo) / 2, (hi - lo) / 2
    rng = np.random.default_rng(7)
    for _ in range(90):
        u = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(B, humanoid.nd)), dtype=torch.float32)
        st = bstep(st, off[None] + sc[None] * u).state
    assert bool(torch.isfinite(st.u).all())
    assert float(st.u[:, 6:].abs().max()) <= cfg.max_dof_vel + 1e-3


def test_joint_batched_actuation_matches_loop(humanoid):
    """pd / limit / dof_pos ``*_batched`` reproduce the joint-loop functions."""
    model = humanoid
    B = 5
    one = dynamics.default_state(model)
    q = _normal(11, B, 4)
    jq = _normal(12, B, *one.joint_q.shape)
    states = dynamics.State(
        root_pos=_normal(10, B, 3),
        root_quat=q / q.norm(dim=-1, keepdim=True),
        joint_q=jq / jq.norm(dim=-1, keepdim=True),
        hinge_q=_normal(13, B, *one.hinge_q.shape, scale=0.5),
        u=_normal(14, B, model.nv, scale=0.3),
        prop_pos=one.prop_pos.expand(B, -1, -1),
        prop_quat=one.prop_quat.expand(B, -1, -1),
    )
    targets = _normal(15, B, model.nd, scale=0.4)
    dt = 1.0 / 120.0
    kd_scale = torch.linspace(0.5, 1.5, B)
    tab = dynamics.dof_tables(model)

    def agree(a, b, **kw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **kw)

    agree(dynamics.dof_pos_batched(model, tab, states), dynamics.dof_pos(model, states),
          atol=1e-6)
    agree(dynamics.pd_torques_batched(model, tab, states, targets, dt),
          dynamics.pd_torques(model, states, targets, dt), rtol=1e-5, atol=1e-4)
    agree(dynamics.pd_torques_batched(model, tab, states, targets, dt, kd_scale=kd_scale),
          dynamics.pd_torques(model, states, targets, dt, kd_scale=kd_scale),
          rtol=1e-5, atol=1e-4)
    agree(dynamics.limit_torques_batched(model, tab, states, 200.0),
          dynamics.limit_torques(model, states, 200.0), rtol=1e-5, atol=1e-4)
