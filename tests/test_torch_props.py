"""Port parity for free props: the model fields ``add_props`` / ``box_prop``
append, the narrow phase with props, their contact-Jacobian block
``JT_prop``, a spinning box in free flight, and one engine tick with the
strike target and with a perturb projectile in contact.

Inputs are built with numpy from a seed and handed to ase_tpu and to
ase_tpu_torch on the CPU (B = 8, the sword-shield humanoid, self-collision
on, K = 24). The engine compares float32 with float32: both sides run the
contact solve with ``matvec_bf16=False``, and a tick is held at the card
check's tolerances (``chip_smoke.check_tick``: 5e-5 on positions and
rotations, 1e-4 of their scale on velocities).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.envs.humanoid_perturb import PERTURB_OBJS
from ase_tpu.physics import collision2 as jc2
from ase_tpu.physics import collision3 as jc3
from ase_tpu.physics import dynamics as jd
from ase_tpu.physics import dynamics2 as jd2
from ase_tpu.physics import engine as je
from ase_tpu.physics import mjcf as jm
from ase_tpu.physics import solver as jsol
from ase_tpu.physics import solver2 as js2
from ase_tpu_torch.physics import collision3 as tc3
from ase_tpu_torch.physics import dynamics as td
from ase_tpu_torch.physics import dynamics2 as td2
from ase_tpu_torch.physics import engine as te
from ase_tpu_torch.physics import mjcf as tm
from ase_tpu_torch.physics import solver2 as ts2
from ase_tpu_torch.physics.collision import Contacts
from ase_tpu_torch.physics.solver import SolverConfig
from tests.test_torch_physics import ASSET, _one_torch_thread  # noqa: F401

B = 8
POS_TOL = 5e-5        # chip_smoke.TICK_POS_TOL
VEL_RTOL = 1e-4       # chip_smoke.TICK_VEL_RTOL


def _props(mod, kind):
    if kind == "strike":
        return [mod.box_prop([0.2, 0.2, 0.9], density=30.0)]
    return [mod.box_prop([0.1] * 3, density=200.0) if k == "small"
            else mod.box_prop([0.25] * 3, density=100.0) for k, _ in PERTURB_OBJS]


@pytest.fixture(scope="module", params=["strike", "perturb"])
def world(request):
    """(kind, JAX model and tables, port model and tables)."""
    kind = request.param
    path = tm.find_asset("", ASSET)
    jmodel = jm.add_props(jm.load_mjcf(path), _props(jm, kind))
    tmodel = tm.add_props(tm.load_mjcf(path, device="cpu"), _props(tm, kind))
    cfg = te.SimConfig(solver=SolverConfig(matvec_bf16=False))
    return kind, jmodel, jc2.build_tables(jmodel, True), tmodel, te.Tables(tmodel, cfg)


def standing_state(world, seed, quiet=False, vel=0.3):
    """Numpy state: the character upright near the ground with perturbed
    joints and small velocities, or (``quiet``) in its default pose at rest
    with only its heading random; props at rest at the origin. Returns a
    dict of float32 arrays."""
    _, jmodel, _, _, _ = world
    rng = np.random.default_rng(seed)
    ns, nh, P = len(jd.sph_ids(jmodel)), len(jd.hinge_ids(jmodel)), jmodel.num_props
    jq = np.concatenate([rng.normal(scale=0.15, size=(B, ns, 3)), np.ones((B, ns, 1))], -1)
    q = np.concatenate([rng.normal(scale=0.05, size=(B, 3)), np.ones((B, 1))], -1)
    s = dict(
        root_pos=np.stack([rng.normal(scale=0.3, size=B), rng.normal(scale=0.3, size=B),
                           rng.uniform(0.86, 0.9, B)], -1),
        root_quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
        joint_q=jq / np.linalg.norm(jq, axis=-1, keepdims=True),
        hinge_q=rng.normal(scale=0.3, size=(B, nh)),
        u=np.concatenate([rng.normal(scale=vel, size=(B, jmodel.nu)), np.zeros((B, 6 * P))], 1),
        prop_pos=np.zeros((B, P, 3)), prop_quat=np.tile([0.0, 0.0, 0.0, 1.0], (B, P, 1)),
    )
    if quiet:
        yaw = rng.uniform(-np.pi, np.pi, B)
        s["root_pos"][:, 2] = 0.9
        s["root_quat"] = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], -1)
        s["joint_q"] = np.tile([0.0, 0.0, 0.0, 1.0], (B, ns, 1))
        s["hinge_q"][:] = 0.0
        s["u"][:] = 0.0
    return {k: v.astype(np.float32) for k, v in s.items()}


def both(s):
    return (jd.State(**{k: jnp.asarray(v) for k, v in s.items()}),
            td.State(**{k: torch.as_tensor(v) for k, v in s.items()}))


def geom_center(world, s, body, offset):
    """(B, 3) world position of the point ``offset`` (body frame) of
    ``body`` in numpy state ``s``."""
    _, jmodel, _, _, _ = world
    kin = jd2.fk_batched(jmodel, both(s)[0])
    b = jmodel.body_index(body)
    return np.asarray(kin.body_pos[:, b] + kin.body_R[:, b] @ jnp.asarray(offset, jnp.float32))


def in_contact(world, seed):
    """The character at rest in its default pose (its heading random): the
    strike target standing on the plane, its side 0.03 m into the sword
    hand; or a perturb projectile at 30 m/s, spinning, 0.02 m into the
    torso, and another resting against the first, the rest parked. The
    perturbed poses of ``standing_state`` bring stiff self-contacts whose
    float32 rounding dominates a tick (their 1e-7 perturbation moves the
    reference's own joint angles by ~2e-5), so the contacts here are the
    props'."""
    kind, jmodel, _, _, _ = world
    s = standing_state(world, seed, quiet=True)
    rng = np.random.default_rng(seed + 100)
    ang = rng.uniform(0, 2 * np.pi, B)
    out = np.stack([np.cos(ang), np.sin(ang), np.zeros(B)], -1)
    if kind == "strike":
        hand = geom_center(world, s, "right_hand", [0.0, 0.0, 0.0])
        s["prop_pos"][:, 0] = hand + out * (0.2 + 0.04 - 0.03)
        s["prop_pos"][:, 0, 2] = 0.895                 # its bottom 5 mm into the plane
        yaw = np.arctan2(out[:, 1], out[:, 0])
        s["prop_quat"][:, 0] = np.stack([0 * yaw, 0 * yaw, np.sin(yaw / 2), np.cos(yaw / 2)], -1)
    else:
        torso = geom_center(world, s, "torso", [0.0, 0.0, 0.12])     # the torso sphere, r 0.11
        s["prop_pos"][:] = np.array([[200.0 + i, 0.0, 1.0] for i in range(jmodel.num_props)])
        s["prop_pos"][:, 0] = torso + out * (0.11 + 0.1 - 0.02)
        s["prop_pos"][:, 1] = s["prop_pos"][:, 0] + out * 0.19 + np.array([0, 0, 0.05])
        s["u"][:, jmodel.nu:jmodel.nu + 3] = -30.0 * out
        s["u"][:, jmodel.nu + 3:jmodel.nu + 6] = rng.normal(size=(B, 3))
    return s


def close(ref, got, atol, rtol_scale=0.0, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    tol = atol + rtol_scale * float(np.abs(ref).max())
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    assert err <= tol, (what, err, tol)


def test_add_props_matches_reference(world):
    """Every field of the model with props equals the JAX model's exactly,
    and each prop's box geom hangs off body nb + k."""
    kind, jmodel, _, tmodel, _ = world
    for f in ("body_names", "parents", "jtype", "dof_offset", "nu", "dof_body_ids",
              "dof_offsets", "num_props", "geom_types", "geom_body", "nv", "ng"):
        assert getattr(tmodel, f) == getattr(jmodel, f), f
    for f in ("body_ipos", "body_iquat", "joint_axis", "mass", "com", "inertia",
              "stiffness", "damping", "armature", "dof_limit_lo", "dof_limit_hi",
              "motor_gear", "geom_pos", "geom_quat", "geom_size", "geom_friction",
              "gravity", "plane_friction", "ang_damping", "max_ang_vel"):
        np.testing.assert_array_equal(tmodel.np(f), np.asarray(getattr(jmodel, f)), f)
    P = 1 if kind == "strike" else 13
    assert tmodel.num_props == P and tmodel.nv == 37 + 6 * P
    assert tmodel.geom_body[-P:] == tuple(range(17, 17 + P))
    assert tm.add_props(tmodel, []) is tmodel


def _contacts(world, s):
    _, jmodel, jt, tmodel, tt = world
    js, tstate = both(s)
    jk = jd2.fk_batched(jmodel, js)
    tk = td2.fk_batched(tmodel, tt.dyn, tstate)
    jc = jc3.detect_batched(jmodel, jt.soa, jk.body_quat, jk.body_pos, js.prop_quat,
                            js.prop_pos, 24, margin=0.02)
    tc = tc3.detect_batched(tt.detect, tk.body_quat, tk.body_pos, tstate.prop_quat,
                            tstate.prop_pos, 24, margin=0.02)
    return js, tstate, jk, tk, jc, tc


def test_contact_sets_with_props_match_reference(world):
    """The narrow phase with 1 (strike) and 13 (perturb: 78 box-box pairs)
    props: per env the same contacts as a set -- each port contact matched
    one to one to a reference contact of the same body pair -- with depths,
    points and normals within 1e-5; the props are in contact."""
    kind, jmodel, jt, _, tt = world
    assert tt.detect.num_candidates == int(sum(getattr(jt.soa, f).size for f in (
        "pl_geom", "ss_i", "sc_s", "cc_i", "bo_box", "bb_src")))
    if kind == "perturb":
        assert jt.soa.bb_src.size >= 78 * 2 * 8
    s = in_contact(world, 3)
    if kind == "perturb":   # two projectiles also overlap each other
        s["prop_pos"][:, 2] = s["prop_pos"][:, 1] + np.array([0.0, 0.15, 0.0], np.float32)
    *_, jc, tc = _contacts(world, s)
    nb = jmodel.nb
    ja, jb = np.asarray(jc.body_a), np.asarray(jc.body_b)
    assert ((ja >= nb) | (jb >= nb)).any(axis=1).all()           # every env touches a prop
    if kind == "strike":
        assert ((jb == -1) & (ja == nb)).any(axis=1).all()       # the box stands on the plane
    else:
        assert ((ja >= nb) & (jb >= nb)).any()                   # box-box contacts present
    fields = ("depth", "pos", "normal", "friction")
    for e in range(B):
        ref = [(int(ja[e, k]), int(jb[e, k]), *(np.asarray(getattr(jc, f)[e, k]) for f in fields))
               for k in range(24)]
        got = [(int(tc.body_a[e, k]), int(tc.body_b[e, k]),
                *(getattr(tc, f)[e, k].numpy() for f in fields)) for k in range(24)]
        assert sorted(r[:2] for r in ref) == sorted(g[:2] for g in got), e
        free = list(range(24))
        for g in got:
            cands = [i for i in free if ref[i][:2] == g[:2]]
            dist = [max(float(np.abs(np.asarray(ref[i][j]) - g[j]).max()) for j in (2, 3, 4, 5))
                    for i in cands]
            i = cands[int(np.argmin(dist))]
            assert min(dist) <= 1e-5, (e, g[:2], min(dist))
            free.remove(i)


def test_jt_prop_matches_reference(world):
    """``contact_jacobian_t_bl`` on the same contacts: the articulation
    block and the props' block (built over a props axis) within 1e-5 of
    their scale; the props' block is nonzero exactly on prop contacts."""
    _, jmodel, _, tmodel, tt = world
    js, tstate, jk, tk, jc, _ = _contacts(world, in_contact(world, 4))
    Amask = jnp.asarray(jd.ancestor_mask(jmodel))
    _, _, jPhi = jd2.compute_dynamics_batch_last(jmodel, js, jk, 1 / 120)
    jJT, jJTp = js2.contact_jacobian_t_bl(jmodel, jc, jPhi, Amask, js.root_pos, js.prop_pos)
    c = Contacts(*(torch.as_tensor(np.array(getattr(jc, f))) for f in Contacts._fields))
    c = c._replace(body_a=c.body_a.long(), body_b=c.body_b.long())
    tJT, tJTp = ts2.contact_jacobian_t_bl(tmodel, c, torch.as_tensor(np.asarray(jPhi)),
                                          tt.Amask, tstate.root_pos, tstate.prop_pos)
    close(jJT, tJT, 0.0, 1e-5, "JT")
    close(jJTp, tJTp, 0.0, 1e-5, "JT_prop")
    assert tJTp.shape == (B, 6 * tmodel.num_props, 72)
    on_prop = (c.body_a >= tmodel.nb) | (c.body_b >= tmodel.nb)
    cols = tJTp.abs().sum(1).reshape(B, 3, 24).sum(1) > 0
    assert torch.equal(cols, on_prop)


@pytest.fixture(scope="module")
def jax_step(world):
    _, jmodel, jt, _, _ = world
    cfg = je.SimConfig(solver=jsol.SolverConfig(matvec_bf16=False))
    return jax.jit(partial(je.step_batched, jmodel, cfg, jt))


def _tick(world, jax_step, s, act, ticks=1):
    _, _, _, tmodel, tt = world
    tcfg = te.SimConfig(solver=SolverConfig(matvec_bf16=False))
    js, tstate = both(s)
    kin = None
    for _ in range(ticks):
        jo = jax_step(js, jnp.asarray(act))
        to = te.step_batched(tmodel, tcfg, tt, tstate, torch.as_tensor(act), kin0=kin)
        js, tstate, kin = jo.state, to.state, to.kin
    return jo, to


def test_spinning_box_in_free_flight_matches_reference(world, jax_step):
    """10 ticks of the character and every prop in free fall, the props out
    of contact, each spinning about a random axis (about a non-principal
    one, the gyroscopic term turns the strike box's angular velocity):
    prop poses and velocities within 1e-5 (of scale for the velocities)."""
    kind, jmodel, _, _, _ = world
    s = standing_state(world, 7)
    s["root_pos"][:, 2] = 20.0
    P, nu = jmodel.num_props, jmodel.nu
    rng = np.random.default_rng(7)
    s["prop_pos"][:] = (np.array([3.0, 0.0, 10.0]) + np.arange(P)[:, None] * np.array([1.0, 0, 0])
                        ).astype(np.float32)
    q = rng.normal(size=(B, P, 4))
    s["prop_quat"] = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    blk = np.concatenate([rng.normal(size=(B, P, 3)), rng.normal(scale=8.0, size=(B, P, 3))], -1)
    s["u"][:, nu:] = blk.reshape(B, -1).astype(np.float32)
    jo, to = _tick(world, jax_step, s, np.zeros((B, 31), np.float32), ticks=10)
    assert float(np.abs(np.asarray(jo.contact_forces)[:, jmodel.nb:]).max()) == 0.0
    close(jo.state.prop_pos, to.state.prop_pos, 1e-5, what="prop_pos")
    close(jo.state.prop_quat, to.state.prop_quat, 1e-5, what="prop_quat")
    close(jo.state.u[:, nu:], to.state.u[:, nu:], 0.0, 1e-5, "prop velocities")
    w0, w1 = blk[..., 3:], np.asarray(jo.state.u[:, nu:]).reshape(B, P, 6)[..., 3:]
    turn = float(np.abs(w1 / np.linalg.norm(w1, axis=-1, keepdims=True)
                        - w0 / np.linalg.norm(w0, axis=-1, keepdims=True)).max())
    # the gyroscopic term turns the strike box's spin; the perturb cubes have none
    assert turn > 1e-2 if kind == "strike" else turn < 1e-5


def test_one_tick_with_props_matches_reference(world, jax_step):
    """One engine tick with the strike target against the sword hand and on
    the plane, or a perturb projectile hitting the torso: every state field
    and the contact forces (width nb + np) at the card check's tolerances."""
    kind, jmodel, _, _, _ = world
    s = in_contact(world, 11)
    act = np.random.default_rng(11).uniform(-0.5, 0.5, size=(B, 31)).astype(np.float32)
    jo, to = _tick(world, jax_step, s, act)
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q", "prop_pos", "prop_quat"):
        close(getattr(jo.state, f), getattr(to.state, f), POS_TOL, what=f)
    close(jo.state.u, to.state.u, 0.0, VEL_RTOL, "u")
    close(jo.contact_forces, to.contact_forces, 0.0, VEL_RTOL, "contact forces")
    assert to.contact_forces.shape == (B, jmodel.nb + jmodel.num_props, 3)
    nb = jmodel.nb
    # the props were in contact: their velocities left free fall
    v0 = s["u"][:, jmodel.nu:jmodel.nu + 3] + np.array([0.0, 0.0, -9.81 / 60], np.float32)
    dv = np.linalg.norm(to.state.u[:, jmodel.nu:jmodel.nu + 3].numpy() - v0, axis=-1)
    assert float(dv.min()) > (1e-2 if kind == "strike" else 1.0), dv
