"""Port parity for the PGS contact solver: ``jacobi_solver.solve_jacobi_xla``,
``solver.contact_jacobian``, ``solver.solve`` and ``solver.solve_batched``
(both schemes) on systems built from a real contact set, one engine tick
under ``scheme="pgs"`` without props and with the strike target, the
divergence the reference's PGS sweep shows on a stiff state, and one
HumanoidAMP control step with ``solverScheme: pgs``.

Inputs are built with numpy from a seed and handed to ase_tpu and to
ase_tpu_torch on the CPU (B = 8, the sword-shield humanoid, self-collision
on, K = 24). Impulses are held to 1e-5 of their largest magnitude (float32
sums of 72 products in another order); a tick to the tolerances of
tests/test_torch_physics.py::test_one_tick_matches_reference.
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.envs import parse_task as jparse
from ase_tpu.ops import jacobi_solver as jjs
from ase_tpu.physics import collision2 as jc2
from ase_tpu.physics import collision3 as jc3
from ase_tpu.physics import dynamics as jd
from ase_tpu.physics import dynamics2 as jd2
from ase_tpu.physics import engine as je
from ase_tpu.physics import mjcf as jm
from ase_tpu.physics import solver as jsol
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.ops import jacobi_solver as tjs
from ase_tpu_torch.physics import engine as te
from ase_tpu_torch.physics import mjcf as tm
from ase_tpu_torch.physics import solver as tsol
from ase_tpu_torch.physics.collision import Contacts
from tests.test_env import make_cfg
from tests.test_torch_physics import (  # noqa: F401  (the autouse fixture)
    ASSET, B, _one_torch_thread, close, models, random_state)
from tests.test_torch_train_parts import env_state_from_jax, t2n

H = 1.0 / 120.0
MOTION = "reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"


def _t(x):
    x = np.array(x)
    return torch.as_tensor(x.astype(np.int64) if x.dtype.kind == "i" else x)


@pytest.fixture(scope="module")
def system(models):
    """A real contact set (random state 21 near the ground, K = 24) and the
    JAX AoS branch's inputs of the contact solve: J (B, K, 3, nv), W =
    M^-1 J^T (B, nv, 3K), u_free (B, nv), all numpy; the contacts and Phi
    also as port tensors."""
    jmodel, _ = models
    js, _ = random_state(models, 21, height=(0.2, 0.6))
    Amask = jnp.asarray(jd.ancestor_mask(jmodel))
    soa = jc2.build_tables(jmodel, True).soa

    @jax.jit
    def build(js):
        jk = jd2.fk_batched(jmodel, js)
        jc = jc3.detect_batched(jmodel, soa, jk.body_quat, jk.body_pos, js.prop_quat,
                                js.prop_pos, 24, margin=0.02)
        M_bl, _, Phi = jd2.compute_dynamics_batch_last(jmodel, js, jk, H)
        J = jax.vmap(lambda c, phi, o, pp: jsol.contact_jacobian(jmodel, c, phi, Amask, o, pp))(
            jc, Phi, js.root_pos, js.prop_pos)
        L = jax.lax.linalg.cholesky(jnp.transpose(M_bl, (2, 0, 1)), symmetrize_input=False)
        return jc, Phi, J, je._chol_solve_batched(L, jnp.swapaxes(J.reshape(B, 72, -1), 1, 2))

    jc, Phi, J, W = build(js)
    tc = Contacts(*(_t(getattr(jc, f)) for f in Contacts._fields))
    assert int((np.asarray(jc.depth) > 0).sum()) > B          # real contacts present
    return dict(jc=jc, tc=tc, J=np.asarray(J), W=np.asarray(W), u=np.asarray(js.u),
                Phi=np.asarray(Phi), root_pos=np.asarray(js.root_pos),
                prop_pos=np.asarray(js.prop_pos))


def test_contact_jacobian_matches_reference(models, system):
    """The batched (B, K, 3, nv) Jacobian on the same contacts and dof axes,
    to 1e-5 of its scale."""
    _, tmodel = models
    Amask = te.Tables(tmodel, te.SimConfig()).Amask
    J = tsol.contact_jacobian(tmodel, system["tc"], _t(system["Phi"]), Amask,
                              _t(system["root_pos"]), _t(system["prop_pos"]))
    close(system["J"], J, 0.0, 1e-5)


@pytest.mark.parametrize("scheme", ["jacobi", "pgs"])
@pytest.mark.parametrize("form", ["batched", "one_env"])
def test_solve_matches_reference(models, system, scheme, form):
    """``solve_batched`` (the diagonal deactivation; Jacobi float32 with the
    impulse cap) and ``solve`` per env (neither), PGS and Jacobi at 16
    iterations: impulses to 1e-5 of their largest magnitude; velocities and
    per-body forces, sums over the contacts, to a tick's 1e-4 of theirs."""
    jmodel, tmodel = models
    cfg = jsol.SolverConfig(scheme=scheme, matvec_bf16=False)
    args = (system["J"], system["W"], system["u"])
    if form == "batched":
        ref = jax.jit(lambda c, J, W, u: jsol.solve_batched(jmodel, c, J, W, u, H, cfg))(
            system["jc"], *args)
        got = tsol.solve_batched(tmodel, system["tc"], *(_t(x) for x in args), H,
                                 tsol.SolverConfig(scheme=scheme, matvec_bf16=False))
    else:
        ref = jax.jit(jax.vmap(lambda c, J, W, u: jsol.solve(jmodel, c, J, W, u, H, cfg)))(
            system["jc"], *args)
        outs = [tsol.solve(tmodel, Contacts(*(x[e] for x in system["tc"])),
                           *(_t(x[e]) for x in args), H, tsol.SolverConfig(scheme=scheme))
                for e in range(B)]
        got = [torch.stack(x) for x in zip(*outs)]
    assert float(np.abs(np.asarray(ref[1])).max()) > 0.0
    for r, g, rtol in zip(ref, got, (1e-4, 1e-5, 1e-4)):
        close(r, g, 0.0, rtol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_solve_jacobi_xla_matches_reference(system, dtype):
    """The (B, K, 3) Jacobi iteration on the batched solve's system, float32
    without a cap, and bfloat16 with the impulse cap (bf16 operands, float32
    sums and result): impulses to 1e-5 of their largest magnitude."""
    J, W = system["J"].reshape(B, 72, -1), system["W"]
    A = (J @ W + 1e-6 * np.eye(72, dtype=np.float32)).astype(np.float32)
    jc = system["jc"]
    depth, fr = np.asarray(jc.depth), np.asarray(jc.friction)
    v0 = np.einsum("bkiv,bv->bki", system["J"], system["u"]).astype(np.float32)
    target = np.zeros((B, 24, 3), np.float32)
    target[..., 0] = np.clip(0.2 / H * np.maximum(depth - 0.002, 0), None, 10.0) \
        + np.minimum(depth, 0) / H
    diag = A.reshape(B, 24, 3, 24, 3)[:, np.arange(24), :, np.arange(24), :].transpose(1, 0, 2, 3)
    diag = diag + 1e-5 * np.eye(3, dtype=np.float32)
    diag_inv = np.linalg.inv(diag.astype(np.float64)).astype(np.float32)
    active = ((depth > -0.02) & (diag[..., 0, 0] > 1e-4)).astype(np.float32)
    mu = (fr * active).astype(np.float32)
    cap = (25.0 / np.maximum(diag[..., 0, 0], 1e-3)).astype(np.float32)
    rest = (v0, target, diag_inv, mu, active)
    if dtype == "float32":
        ref = jjs.solve_jacobi_xla(jnp.asarray(A), *map(jnp.asarray, rest), 16, 0.35)
        got = tjs.solve_jacobi_xla(_t(A), *map(_t, rest), 16, 0.35)
    else:
        ref = jjs.solve_jacobi(jnp.asarray(A).astype(jnp.bfloat16), *map(jnp.asarray, rest),
                               16, 0.35, jnp.asarray(cap))
        got = tjs.solve_jacobi(_t(A).to(torch.bfloat16), *map(_t, rest), 16, 0.35, _t(cap))
    assert got.dtype == torch.float32
    close(ref, got, 0.0, 1e-5)


# -- the engine under scheme="pgs" --------------------------------------------------------

@pytest.fixture(scope="module", params=["none", "strike"])
def world(request):
    """(props, JAX model, JAX step (jitted, PGS), port model, port tables,
    port config)."""
    path = tm.find_asset("", ASSET)
    jmodel, tmodel = jm.load_mjcf(path), tm.load_mjcf(path, device="cpu")
    if request.param == "strike":
        jmodel = jm.add_props(jmodel, [jm.box_prop([0.2, 0.2, 0.9], density=30.0)])
        tmodel = tm.add_props(tmodel, [tm.box_prop([0.2, 0.2, 0.9], density=30.0)])
    jcfg = je.SimConfig(solver=jsol.SolverConfig(scheme="pgs"))
    tcfg = te.SimConfig(solver=tsol.SolverConfig(scheme="pgs"))
    jstep = jax.jit(partial(je.step_batched, jmodel, jcfg, jc2.build_tables(jmodel, True)))
    return request.param, jmodel, jstep, tmodel, te.Tables(tmodel, tcfg), tcfg


def test_pgs_tick_matches_reference(models, world):
    """One tick from random state 21 (poses near the ground, contacts on
    every env), with the strike target standing on the plane beside the
    character, its bottom 5 mm into it: every state field to 5e-5,
    velocities, contact forces and dof forces to 1e-4 of their scale."""
    props, jmodel, jstep, tmodel, tables, tcfg = world
    js, ts = random_state(models, 21, height=(0.2, 0.6))
    if props == "strike":
        pos = np.asarray(js.root_pos) + np.array([0.6, 0.0, 0.0], np.float32)
        pos[:, 2] = 0.895
        pp = pos[:, None, :].astype(np.float32)
        pq = np.tile(np.array([0.0, 0.0, 0.0, 1.0], np.float32), (B, 1, 1))
        u = np.concatenate([np.asarray(js.u), np.zeros((B, 6), np.float32)], 1)
        js = js._replace(prop_pos=jnp.asarray(pp), prop_quat=jnp.asarray(pq), u=jnp.asarray(u))
        ts = ts._replace(prop_pos=_t(pp), prop_quat=_t(pq), u=_t(u))
    act = np.random.default_rng(21).uniform(-1, 1, size=(B, 31)).astype(np.float32)
    jo = jstep(js, jnp.asarray(act))
    to = te.step_batched(tmodel, tcfg, tables, ts, torch.as_tensor(act))
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q") + (
            ("prop_pos", "prop_quat") if props == "strike" else ()):
        close(getattr(jo.state, f), getattr(to.state, f), 5e-5)
    close(jo.state.u, to.state.u, 0.0, 1e-4)
    close(jo.contact_forces, to.contact_forces, 0.0, 1e-4)
    close(jo.body_pos, to.body_pos, 5e-5)
    close(jo.dof_forces, to.dof_forces, 0.0, 1e-4)
    if props == "strike":     # the target stands on the plane
        assert float(np.abs(np.asarray(jo.contact_forces)[:, jmodel.nb]).max()) > 0.0


# One env's state (root_pos, root_quat, joint_q, hinge_q, u) and PD targets,
# float32 in base64, from a 1024-env HumanoidAMP PGS player run on the CPU
# at its third control step: 6 m up with fast joints, seven self-contacts,
# three of them duplicates.
DIVERGING = (
    "Dy4IwpcJBsK8RcJAiClUP1YDyr6VNYm+YtuVPq9F672n4Jo+VZ7YvhaqWD9yyga+LTS0PtBnr70h"
    "OWw/D0YNvyTtBj8+ngQ/zdbFPuCljb7Raj0/28hvPuMTET9IH0Q/3E/FPVhZy73GrSA/8eOGPvjk"
    "CL1p5Lg+/9ZkPx/u5b30lnG+OBLavinAXT+aBgq9MBRBvQS5Xj/2rvo+3s8yvoruAT0X9869pZp6"
    "P5tkxz7Tgu2+Xoz4PnICNkBJSt7Dd4y5wyBQk0KAWZjBNlaTwmiH5sHagRnCMNdwwAYl6UAMVQJC"
    "EPa9PzHly8AcNDtCQvuPQRSRiMEwZmTANn4tQUwVCcHc+VfB4FK+P0QYckGQ+TZBWXQSQjSNm8He"
    "htrBxNVFQVXO0MG87yDAhAMPQW4Yb8EVS2FBXItIQNBLbEGruw9BEPFPwGmPBsBkcEVBXs59voSs"
    "DD/LY4E+2UN8v0g11b0uaOY8n5wePmy6i7+zSJw/mNOJv8lkrD4vQcg+YaAZPxeb0T/LVEm/brz9"
    "v4QF8L/nu4E+U9OWPqw7LL/fM0I/LB1TvdpMkL66XfW+lOpeP11uh77HUY6+tmMiQOALCr8nn4u+"
    "pV7KPg=="
)


@pytest.mark.parametrize("world", ["none"], indirect=True)
def test_pgs_divergence_matches_reference(world):
    """The reference's PGS sweep has no divergence guard (the Jacobi
    scheme's impulse cap is not applied to it), and on DIVERGING its
    impulses grow ~7x a sweep in the tick's second substep. The port
    follows it: after one tick both packages' velocities pass 1e10 (the
    Jacobi tick of the same state stays under 500), after two ticks both
    are non-finite."""
    import base64

    from ase_tpu_torch.physics.dynamics import State as TState

    _, _, jstep, tmodel, tables, tcfg = world
    flat = np.frombuffer(base64.b64decode(DIVERGING), np.float32)
    parts = np.split(flat, np.cumsum((3, 4, 36, 4, 37)))
    shapes = {"root_pos": (3,), "root_quat": (4,), "joint_q": (9, 4), "hinge_q": (4,),
              "u": (37,)}
    s = {f: np.tile(x.reshape(shp), (B, 1) if len(shp) == 1 else (B, 1, 1))
         for (f, shp), x in zip(shapes.items(), parts)}
    s.update(prop_pos=np.zeros((B, 0, 3), np.float32), prop_quat=np.zeros((B, 0, 4), np.float32))
    tgt = np.tile(parts[5], (B, 1))
    js = jd.State(**{k: jnp.asarray(v) for k, v in s.items()})
    ts = TState(**{k: _t(v) for k, v in s.items()})
    for tick in range(2):
        js = jstep(js, jnp.asarray(tgt)).state
        ts = te.step_batched(tmodel, tcfg, tables, ts, _t(tgt)).state
        ju, tu = np.asarray(js.u), t2n(ts.u)
        if tick == 0:
            assert float(np.abs(ju).max()) > 1e10 and float(np.abs(tu).max()) > 1e10
        else:
            assert not np.isfinite(ju).all() and not np.isfinite(tu).all()
    jac = te.SimConfig(solver=tsol.SolverConfig(matvec_bf16=False))
    out = te.step_batched(tmodel, jac, te.Tables(tmodel, jac),
                          TState(**{k: _t(v) for k, v in s.items()}), _t(tgt))
    assert float(out.state.u.abs().max()) < 500.0


def test_unknown_scheme_is_rejected(models):
    """The reference runs PGS for any scheme string but "jacobi"; the port
    refuses it."""
    with pytest.raises(ValueError, match="scheme"):
        te.Tables(models[1], te.SimConfig(solver=tsol.SolverConfig(scheme="gs")))


# -- HumanoidAMP with solverScheme: pgs -------------------------------------------------------

class AMPDraws:
    """The numbers one JAX HumanoidAMP reset pass draws (Hybrid starts,
    ``HumanoidAMP._reset_actors``), in the port's ``_draw_reset`` format."""

    def __init__(self, jenv):
        self.jenv, self.key = jenv, None

    def __call__(self, n):
        keys = jax.random.split(self.key, 3)
        self.key = keys[0]
        k1, k2 = jax.random.split(keys[1])
        w = self.jenv._motion_lib.weights
        d = {"motion_ids": jax.random.categorical(k1, jnp.log(jnp.maximum(w, 1e-12)), shape=(n,)),
             "motion_phase": jax.random.uniform(k2, (n,)),
             "u_hybrid": jax.random.uniform(keys[2], (n,))}
        return {k: _t(v) for k, v in d.items()}


def test_humanoid_amp_step_with_pgs_matches_reference():
    """HumanoidAMP at 8 envs (Hybrid starts, reset chunk 4) under
    ``solverScheme: pgs``, its initial reset from replayed draws: the
    same motion ids and key chain; then, from the JAX state carried across, one
    control step (2 ticks) with random actions: positions to 1e-3 and
    observations to 1e-2 of their scale (tests/test_torch_env.py's bounds
    for stiff steps: an RSI frame can start a foot in the ground)."""
    cfg = make_cfg(numEnvs=B, resetChunk=4, stateInit="Hybrid", solverScheme="pgs",
                   enableSelfCollision=True, maxContacts=24, motion_file=MOTION)
    jenv = jparse("HumanoidAMP", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMP", copy.deepcopy(cfg), device="cpu")
    assert jenv.sim_cfg.solver.scheme == tenv.sim_cfg.solver.scheme == "pgs"
    draws = AMPDraws(jenv)
    tenv._draw_reset = draws
    key = jax.random.PRNGKey(3)
    js = jenv.initial_state(key)
    draws.key = key
    ts = tenv.initial_state()
    np.testing.assert_array_equal(t2n(ts.aux["reset_motion_ids"]),
                                  np.asarray(js.aux["reset_motion_ids"]))
    assert draws.key.tolist() == js.rng.tolist()

    ts = env_state_from_jax(js, ts)
    act = np.random.default_rng(4).uniform(-1, 1, size=(B, 31)).astype(np.float32)
    js = jax.jit(jenv.step)(js, jnp.asarray(act))
    ts = tenv.step(ts, torch.as_tensor(act))
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
        err = float(np.abs(np.asarray(getattr(js.phys, f)) - t2n(getattr(ts.phys, f))).max())
        assert err <= 1e-3, (f, err)
    ref = np.asarray(js.obs)
    assert float(np.abs(ref - t2n(ts.obs)).max()) <= 1e-2 * float(np.abs(ref).max())
    assert float(np.abs(ref - np.asarray(jenv.initial_state(key).obs)).max()) > 0.1
