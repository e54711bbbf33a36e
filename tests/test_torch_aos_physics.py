"""Port parity for the physics oracles: the AoS dynamics (``fk``,
``compute_dynamics``, ``pd_torques``, ``limit_torques`` and the dof
views), the table-driven narrow phase ``collision2``, the batch-first
contact Jacobian and solve of ``solver2``, and the one-env
``engine.step``.

Each part is held against ``ase_tpu`` on the CPU, on both humanoid assets,
from the same numpy inputs (B <= 4, one torch thread). The port's own
batched forms (``dynamics2``, ``collision3``, ``contact_jacobian_t_bl``)
are then held against its AoS oracles at the tolerances of the
reference's tests (``tests/test_dynamics2.py``,
``tests/test_collision_soa.py``, ``tests/test_solver2.py``).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.physics import collision as jcol
from ase_tpu.physics import collision2 as jc2
from ase_tpu.physics import dynamics as jd
from ase_tpu.physics import engine as je
from ase_tpu.physics import mjcf as jm
from ase_tpu.physics import solver as jsol
from ase_tpu.physics import solver2 as js2
from ase_tpu_torch.ops import quat as tq
from ase_tpu_torch.physics import collision as tcol
from ase_tpu_torch.physics import collision2 as tc2
from ase_tpu_torch.physics import collision3 as tc3
from ase_tpu_torch.physics import dynamics as td
from ase_tpu_torch.physics import dynamics2 as td2
from ase_tpu_torch.physics import engine as te
from ase_tpu_torch.physics import mjcf as tm
from ase_tpu_torch.physics import solver2 as ts2
from ase_tpu_torch.physics.solver import SolverConfig


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs B <= 4 here: intra-op threads would only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 4
ASSETS = ["mjcf/amp_humanoid_sword_shield.xml", "mjcf/amp_humanoid.xml"]


@pytest.fixture(scope="module", params=ASSETS, ids=["sword_shield", "amp_humanoid"])
def models(request):
    path = tm.find_asset("", request.param)
    return jm.load_mjcf(path), tm.load_mjcf(path, device="cpu")


def close(ref, got, atol, rtol_scale=0.0, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    if not ref.size:
        return
    tol = atol + rtol_scale * float(np.abs(ref).max())
    err = float(np.abs(ref - got).max())
    assert err <= tol, (what, err, tol)


def random_state(jmodel, seed, height=(0.5, 1.5), vel=1.0, n=B):
    """Numpy state, as ``tests/test_dynamics2.py`` builds it: random root
    pose and joint rotations, random hinge angles and velocities. Returns
    (jax State, torch State), batched over ``n``."""
    rng = np.random.default_rng(seed)
    ns, nh = len(jd.sph_ids(jmodel)), len(jd.hinge_ids(jmodel))
    q = rng.normal(size=(n, 4))
    jq = rng.normal(size=(n, ns, 4))
    s = dict(
        root_pos=np.stack([rng.normal(scale=0.3, size=n), rng.normal(scale=0.3, size=n),
                           rng.uniform(*height, n)], -1),
        root_quat=q / np.linalg.norm(q, axis=-1, keepdims=True),
        joint_q=jq / np.linalg.norm(jq, axis=-1, keepdims=True),
        hinge_q=rng.normal(scale=0.7, size=(n, nh)),
        u=rng.normal(scale=vel, size=(n, jmodel.nv)),
        prop_pos=np.zeros((n, 0, 3)), prop_quat=np.zeros((n, 0, 4)),
    )
    s = {k: v.astype(np.float32) for k, v in s.items()}
    return (jd.State(**{k: jnp.asarray(v) for k, v in s.items()}),
            td.State(**{k: torch.as_tensor(v) for k, v in s.items()}))


def jax_vmap(fn, *args, jit=False):
    f = jax.vmap(fn)
    return (jax.jit(f) if jit else f)(*args)


# -- the dof views ------------------------------------------------------------

def test_dof_views_match_reference(models):
    jmodel, tmodel = models
    js, ts = random_state(jmodel, 1)
    close(jax_vmap(lambda s: jd.dof_pos(jmodel, s), js), td.dof_pos(tmodel, ts), 1e-5)
    close(jax_vmap(lambda s: jd.dof_vel(jmodel, s), js), td.dof_vel(tmodel, ts), 0.0)
    rng = np.random.default_rng(2)
    dp = (0.4 * rng.normal(size=(B, jmodel.nd))).astype(np.float32)
    dv = rng.normal(size=(B, jmodel.nd)).astype(np.float32)
    jo = jax_vmap(lambda s, p, v: jd.set_dof_state(jmodel, s, p, v), js, jnp.asarray(dp),
                  jnp.asarray(dv))
    to = td.set_dof_state(tmodel, ts, torch.as_tensor(dp), torch.as_tensor(dv))
    for f in jd.State._fields:
        close(getattr(jo, f), getattr(to, f), 2e-6, what=f)
    pos, quat = np.array(js.root_pos[0] + 1.0), np.array(js.root_quat[1])
    lin, ang = jnp.arange(3.0), -jnp.arange(3.0)
    one = jax.tree_util.tree_map(lambda x: x[0], js)
    jr = jd.set_root_state(one, pos, quat, lin, ang)
    tone = td.State(*(x[0] for x in ts))
    tr = td.set_root_state(tone, torch.as_tensor(np.asarray(pos)), torch.as_tensor(
        np.asarray(quat)), torch.arange(3.0), -torch.arange(3.0))
    for f in jd.State._fields:
        close(getattr(jr, f), getattr(tr, f), 0.0, what=f)
    assert td.has_free_root(tmodel) == jd.has_free_root(jmodel)
    # the one-env default state, and the batched one
    for f, x in jd.default_state(jmodel)._asdict().items():
        close(x, getattr(td.default_state(tmodel), f), 0.0, what=f)
    for f, x in je.batch_default_state(jmodel, 3)._asdict().items():
        close(x, getattr(te.batch_default_state(tmodel, 3), f), 0.0, what=f)


# -- AoS kinematics and dynamics against the reference --------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_aos_fk_and_dynamics_match_reference(models, seed):
    """``fk``, ``motion_subspace`` and ``compute_dynamics`` on random poses
    and velocities: each output to 1e-5 of its largest magnitude."""
    jmodel, tmodel = models
    js, ts = random_state(jmodel, seed)
    jk = jax_vmap(lambda s: jd.fk(jmodel, s), js)
    tk = td.fk(tmodel, ts)
    for f in jk._fields:
        close(getattr(jk, f), getattr(tk, f), 0.0, 1e-5, what=f)
    for b in range(jmodel.nb):
        close(jax_vmap(lambda s: jd.local_joint_quat(jmodel, s, b), js),
              td.local_joint_quat(tmodel, ts, b), 2e-6, what=b)
    jphi = jax_vmap(lambda k, o: jd.motion_subspace(jmodel, k, o), jk, js.root_pos)
    for ref, got in zip(jphi, td.motion_subspace(tmodel, tk, ts.root_pos)):
        close(ref, got, 0.0, 1e-5)
    h = 1.0 / 120.0
    jdyn = jax_vmap(lambda s, k: jd.compute_dynamics(jmodel, s, k, h), js, jk)
    tdyn = td.compute_dynamics(tmodel, ts, tk, h)
    for f in ("Mmat", "bias", "Phi"):
        close(getattr(jdyn, f), getattr(tdyn, f), 0.0, 1e-5, what=f)
    close(jdyn.Amask[0], tdyn.Amask, 0.0)


def test_aos_one_env_equals_batch_row(models):
    """With no batch dim the oracle computes what a batch row computes."""
    jmodel, tmodel = models
    _, ts = random_state(jmodel, 4)
    tk = td.fk(tmodel, ts)
    dyn = td.compute_dynamics(tmodel, ts, tk, 1 / 120)
    one = td.State(*(x[2] for x in ts))
    k1 = td.fk(tmodel, one)
    for f in tk._fields:
        close(getattr(tk, f)[2].numpy(), getattr(k1, f), 1e-6, what=f)
    d1 = td.compute_dynamics(tmodel, one, k1, 1 / 120)
    close(dyn.Mmat[2].numpy(), d1.Mmat, 0.0, 1e-6)
    close(dyn.bias[2].numpy(), d1.bias, 0.0, 1e-6)


def test_aos_torques_match_reference(models):
    """``pd_torques`` (with and without a per-env damping scale) and
    ``limit_torques``, joint by joint: to 1e-5 of their scale."""
    jmodel, tmodel = models
    js, ts = random_state(jmodel, 5)
    rng = np.random.default_rng(5)
    tgt = rng.uniform(-1.5, 1.5, size=(B, jmodel.nd)).astype(np.float32)
    ks = np.linspace(0.5, 1.5, B).astype(np.float32)
    dt = 1 / 120
    close(jax_vmap(lambda s, a: jd.pd_torques(jmodel, s, a, dt), js, jnp.asarray(tgt)),
          td.pd_torques(tmodel, ts, torch.as_tensor(tgt), dt), 0.0, 1e-5)
    close(jax_vmap(lambda s, a, k: jd.pd_torques(jmodel, s, a, dt, kd_scale=k), js,
                   jnp.asarray(tgt), jnp.asarray(ks)),
          td.pd_torques(tmodel, ts, torch.as_tensor(tgt), dt, kd_scale=torch.as_tensor(ks)),
          0.0, 1e-5)
    close(jax_vmap(lambda s: jd.limit_torques(jmodel, s, 200.0), js),
          td.limit_torques(tmodel, ts, 200.0), 0.0, 1e-5)


# -- the port's batched forms against its AoS oracles ---------------------------

@pytest.mark.parametrize("seed", [5, 11])
def test_batched_dynamics_match_aos_oracle(models, seed):
    """``dynamics2.fk_batched`` and ``compute_dynamics_batch_last`` against
    the port's ``fk`` and ``compute_dynamics``, at ``tests/test_dynamics2.py``'s
    tolerances: M and bias to 2e-5 of their scale, Phi to 1e-5; FK
    quaternions 1e-6, positions, rotations and centres of mass 1e-5,
    velocities 1e-4."""
    _, tmodel = models
    _, ts = random_state(models[0], seed)
    st = td2.DynStatic(tmodel)
    ref = td.fk(tmodel, ts)
    out = td2.fk_batched(tmodel, st, ts)
    for f, tol in (("body_quat", 1e-6), ("body_pos", 1e-5), ("body_R", 1e-5),
                   ("body_vel", 1e-4), ("com_world", 1e-5)):
        close(getattr(ref, f), getattr(out, f), tol, what=f)
    h = 1.0 / 120.0
    dyn = td.compute_dynamics(tmodel, ts, ref, h)
    M_bl, bias, Phi = td2.compute_dynamics_batch_last(tmodel, st, ts, ref, st.diag(tmodel, h))
    close(dyn.Mmat, M_bl.permute(2, 0, 1), 0.0, 2e-5, what="M")
    close(dyn.bias, bias, 0.0, 2e-5, what="bias")
    close(dyn.Phi, Phi, 1e-5, what="Phi")


def test_batched_torques_match_aos_oracle(models):
    """The joint-batched actuation equals the joint loops (the reference's
    ``test_joint_batched_actuation_matches_loop``)."""
    _, tmodel = models
    _, ts = random_state(models[0], 3)
    tab = td.dof_tables(tmodel)
    tgt = torch.as_tensor(np.random.default_rng(3).normal(scale=0.4, size=(B, tmodel.nd)),
                          dtype=torch.float32)
    ks = torch.linspace(0.5, 1.5, B)
    close(td.dof_pos(tmodel, ts), td.dof_pos_batched(tmodel, tab, ts), 1e-6)
    for kd in (None, ks):
        ref = td.pd_torques(tmodel, ts, tgt, 1 / 120, kd_scale=1.0 if kd is None else kd)
        close(ref, td.pd_torques_batched(tmodel, tab, ts, tgt, 1 / 120, kd_scale=kd), 1e-4,
              1e-5)
    close(td.limit_torques(tmodel, ts), td.limit_torques_batched(tmodel, tab, ts), 1e-4, 1e-5)


# -- collision2 ----------------------------------------------------------------

def test_collision2_tables_equal_reference(models):
    jmodel, tmodel = models
    for enable_self in (True, False):
        jt, tt = jc2.build_tables(jmodel, enable_self), tc2.build_tables(tmodel, enable_self)
        for f in jc2.PlaneTable._fields:
            a, b = getattr(jt.plane, f), getattr(tt.plane, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), f
        for f in jc2.PairTables._fields:
            a, b = getattr(jt.pairs, f), getattr(tt.pairs, f)
            if f == "box_box":
                assert a == b
            else:
                assert a.dtype == b.dtype and np.array_equal(a, b), f
        for f in tc3.SoATables.__dataclass_fields__:
            assert np.array_equal(getattr(jt.soa, f), getattr(tt.soa, f)), f


def _rank_match(ref, got):
    """``tests/test_collision_soa.py``'s comparison: sorted depths to 2e-5,
    normal, position and friction to 1e-4 at matching depth ranks."""
    rd, gd = np.asarray(ref.depth), got.depth.numpy()
    np.testing.assert_allclose(np.sort(rd, axis=-1), np.sort(gd, axis=-1), atol=2e-5)
    oa = np.argsort(-rd, axis=-1, kind="stable")
    ob = np.argsort(-gd, axis=-1, kind="stable")
    for f in ("normal", "pos", "friction"):
        va, vb = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
        fa = np.take_along_axis(va, oa[..., None] if va.ndim == 3 else oa, axis=-2 + (va.ndim == 2))
        fb = np.take_along_axis(vb, ob[..., None] if vb.ndim == 3 else ob, axis=-2 + (vb.ndim == 2))
        np.testing.assert_allclose(fa, fb, atol=1e-4, err_msg=f)


@pytest.mark.parametrize("margin", [0.0, 0.02])
def test_collision2_detect_matches_reference(models, margin):
    """``detect`` at K = 24 on poses near the ground, self-collision on, from
    the same rotation matrices and positions in both packages."""
    jmodel, tmodel = models
    js, ts = random_state(jmodel, 13, height=(0.1, 0.6))
    jk = jax_vmap(lambda s: jd.fk(jmodel, s), js)
    jt, tt = jc2.build_tables(jmodel, True), tc2.build_tables(tmodel, True)
    body_R, body_pos = np.asarray(jk.body_R), np.asarray(jk.body_pos)
    pR = np.zeros((B, 0, 3, 3), np.float32)
    ref = jax_vmap(lambda R, p, r, q: jc2.detect(jmodel, jt, R, p, r, q, 24, margin=margin),
                   jnp.asarray(body_R), jnp.asarray(body_pos), jnp.asarray(pR), js.prop_pos,
                   jit=True)
    got = tc2.detect(tmodel, tt, torch.as_tensor(body_R), torch.as_tensor(body_pos),
                     torch.as_tensor(pR), ts.prop_pos, 24, margin=margin)
    assert int((np.asarray(ref.depth) > 0).sum()) > B       # real contacts present
    _rank_match(ref, got)
    # the compaction keeps the candidate order: the same slots throughout
    np.testing.assert_array_equal(got.body_a.numpy(), np.asarray(ref.body_a))
    np.testing.assert_array_equal(got.body_b.numpy(), np.asarray(ref.body_b))
    close(ref.depth, got.depth, 2e-5)
    # one env without a batch dim
    one = tc2.detect(tmodel, tt, torch.as_tensor(body_R[1]), torch.as_tensor(body_pos[1]),
                     torch.as_tensor(pR[1]), ts.prop_pos[1], 24, margin=margin)
    for f in one._fields:
        assert torch.equal(getattr(one, f), getattr(got, f)[1]), f


def test_collision3_matches_collision2_oracle(models):
    """The engine's narrow phase against the port's oracle, as
    ``tests/test_collision_soa.py`` holds the reference's."""
    _, tmodel = models
    _, ts = random_state(models[0], 3)
    tt = tc2.build_tables(tmodel, True)
    kin = td.fk(tmodel, ts)
    aos = tc2.detect(tmodel, tt, kin.body_R, kin.body_pos,
                     tq.quat_to_rotation_matrix(ts.prop_quat), ts.prop_pos, 24)
    soa = tc3.detect_batched(tc3.DetectConsts(tmodel, tt.soa, "cpu"), kin.body_quat,
                             kin.body_pos, ts.prop_quat, ts.prop_pos, 24)
    _rank_match(aos, soa)


@pytest.mark.parametrize("name", ["segment_segment", "point_box_depth"])
def test_primitive_tests_match_reference(name):
    rng = np.random.default_rng(9)
    n = 64
    if name == "segment_segment":
        pts = rng.normal(size=(4, n, 3)).astype(np.float32)
        pts[3, :8] = pts[2, :8] + (pts[1, :8] - pts[0, :8])   # parallel segments
        pts[1, 8:12] = pts[0, 8:12]                           # degenerate segment
        ref = jax.vmap(jcol._segment_segment)(*map(jnp.asarray, pts))
        got = tcol._segment_segment(*map(torch.as_tensor, pts))
    else:
        p = rng.normal(scale=0.6, size=(n, 3)).astype(np.float32)
        p[:4] = 0.0                                           # the centre: sign 0
        half = rng.uniform(0.1, 0.5, size=(n, 3)).astype(np.float32)
        ref = jax.vmap(jcol._point_box_depth)(jnp.asarray(p), jnp.asarray(half))
        got = tcol._point_box_depth(torch.as_tensor(p), torch.as_tensor(half))
    for r, g in zip(ref, got):
        close(r, g, 2e-6)


# -- solver2's batch-first forms -------------------------------------------------

def _synthetic_contacts(nb_total, K, seed):
    """Contacts with every body pairing the Jacobian distinguishes: body_a
    over the bodies and props, body_b over those and the ground (-1)."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(B, K, 3))
    nrm[:, :4] = [0.0, 0.0, 1.0]                              # the basis's other branch
    return dict(
        pos=rng.normal(size=(B, K, 3)).astype(np.float32),
        normal=(nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(np.float32),
        depth=rng.uniform(-0.01, 0.05, size=(B, K)).astype(np.float32),
        body_a=rng.integers(0, nb_total, size=(B, K)),
        body_b=rng.integers(-1, nb_total, size=(B, K)),
        friction=rng.uniform(0.5, 1.0, size=(B, K)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def prop_models():
    path = tm.find_asset("", ASSETS[0])
    return (jm.add_props(jm.load_mjcf(path), [jm.box_prop([0.25] * 3, density=100.0)] * 2),
            tm.add_props(tm.load_mjcf(path, device="cpu"),
                         [tm.box_prop([0.25] * 3, density=100.0)] * 2))


def test_contact_jacobian_t_matches_reference(prop_models):
    """The batch-first JT against the reference's, and the port's batch-last
    builder against it transposed (``tests/test_solver2.py:64``), with two
    props (either side of a contact) and synthetic contacts."""
    jmodel, tmodel = prop_models
    K = 12
    c = _synthetic_contacts(jmodel.nb + jmodel.num_props, K, 0)
    rng = np.random.default_rng(1)
    Phi = rng.normal(size=(B, jmodel.nu, 6)).astype(np.float32)
    origin = rng.normal(size=(B, 3)).astype(np.float32)
    prop_pos = rng.normal(size=(B, 2, 3)).astype(np.float32)
    Amask = jd.ancestor_mask(jmodel)
    jc = jcol.Contacts(**{k: jnp.asarray(v, jnp.int32 if k.startswith("body") else None)
                          for k, v in c.items()})
    tc = tcol.Contacts(**{k: torch.as_tensor(v) for k, v in c.items()})
    ref = js2.contact_jacobian_t(jmodel, jc, jnp.asarray(Phi), jnp.asarray(Amask),
                                 jnp.asarray(origin), jnp.asarray(prop_pos))
    args = (tmodel, tc, torch.as_tensor(Phi), torch.as_tensor(Amask), torch.as_tensor(origin),
            torch.as_tensor(prop_pos))
    JT = ts2.contact_jacobian_t(*args)
    close(ref, JT, 1e-5)
    JT_bl, JT_prop = ts2.contact_jacobian_t_bl(*args)
    close(JT[:, :jmodel.nu].numpy(), JT_bl.permute(2, 0, 1), 1e-5)
    close(JT[:, jmodel.nu:].numpy(), JT_prop, 1e-5)


def test_solve_batched_t_matches_reference(prop_models):
    """The batch-first contact solve on a W = M^-1 J^T from random SPD mass
    matrices: impulses, new velocities and body forces to 1e-4 of scale."""
    jmodel, tmodel = prop_models
    K = 12
    c = _synthetic_contacts(jmodel.nb + jmodel.num_props, K, 2)
    rng = np.random.default_rng(3)
    nv = jmodel.nv
    JT = (0.3 * rng.normal(size=(B, nv, 3 * K))).astype(np.float32)
    Mh = rng.normal(size=(B, nv, nv))
    Minv = np.linalg.inv(Mh @ Mh.transpose(0, 2, 1) + nv * np.eye(nv))
    W = (Minv @ JT).astype(np.float32)
    u_free = rng.normal(size=(B, nv)).astype(np.float32)
    jc = jcol.Contacts(**{k: jnp.asarray(v, jnp.int32 if k.startswith("body") else None)
                          for k, v in c.items()})
    tc = tcol.Contacts(**{k: torch.as_tensor(v) for k, v in c.items()})
    ref = js2.solve_batched_t(jmodel, jc, jnp.asarray(JT), jnp.asarray(W), jnp.asarray(u_free),
                              1 / 120, jsol.SolverConfig(matvec_bf16=False))
    got = ts2.solve_batched_t(tmodel, tc, torch.as_tensor(JT), torch.as_tensor(W),
                              torch.as_tensor(u_free), 1 / 120, SolverConfig(matvec_bf16=False))
    assert float(np.abs(np.asarray(ref[1])).max()) > 0       # some impulse
    for r, g, what in zip(ref, got, ("u_new", "lam", "body_forces")):
        close(r, g, 0.0, 1e-4, what=what)


# -- the one-env engine.step -------------------------------------------------------

def _f32_configs():
    return (je.SimConfig(solver=jsol.SolverConfig(matvec_bf16=False)),
            te.SimConfig(solver=SolverConfig(matvec_bf16=False)))


@pytest.mark.parametrize("start", ["default", "random"])
def test_one_env_step_matches_reference(models, start):
    """Four ticks of ``engine.step`` (one env, no batch dim) from the default
    standing pose and from a random pose near the ground: the first tick
    at ``tests/test_torch_physics.py``'s one-tick tolerances (positions and
    rotations 5e-5, velocities, contact and dof forces 1e-4 of scale), the
    fourth at its rollout ones (body positions 1e-3 m, velocities 2e-2 of
    scale)."""
    jmodel, tmodel = models
    jcfg, tcfg = _f32_configs()
    jstep = jax.jit(partial(je.step, jmodel, jcfg, jc2.build_tables(jmodel, True)))
    T = te.Tables(tmodel, tcfg)
    if start == "default":
        js = jd.default_state(jmodel)._replace(root_pos=jnp.asarray([0.0, 0.0, 0.92]))
    else:
        js = jax.tree_util.tree_map(lambda x: x[0],
                                    random_state(jmodel, 21, height=(0.3, 0.6), vel=0.5)[0])
    ts = td.State(*(torch.as_tensor(np.asarray(x)) for x in js))
    act = np.random.default_rng(7).uniform(-0.5, 0.5, size=(4, jmodel.nd)).astype(np.float32)
    for t in range(4):
        jo = jstep(js, jnp.asarray(act[t]))
        to = te.step(tmodel, tcfg, T, ts, torch.as_tensor(act[t]))
        js, ts = jo.state, to.state
        if t == 0:
            for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
                close(getattr(jo.state, f), getattr(to.state, f), 5e-5, what=f)
            close(jo.state.u, to.state.u, 0.0, 1e-4, what="u")
            close(jo.contact_forces, to.contact_forces, 0.0, 1e-4, what="forces")
            close(jo.dof_forces, to.dof_forces, 0.0, 1e-4, what="dof_forces")
    assert to.body_pos.shape == (tmodel.nb, 3) and to.kin.body_R.shape == (tmodel.nb, 3, 3)
    close(jo.body_pos, to.body_pos, 1e-3)
    close(jo.state.u, to.state.u, 0.0, 2e-2)


def test_make_batched_step_runs_the_batched_tick(models):
    """``make_batched_step`` is ``step_batched`` over the model's tables, and
    ``step`` computes a batch row, to the one-tick tolerances."""
    _, tmodel = models
    _, tcfg = _f32_configs()
    _, ts = random_state(models[0], 8, height=(0.6, 0.9), vel=0.2, n=2)
    act = torch.zeros(2, tmodel.nd)
    out = te.make_batched_step(tmodel, tcfg)(ts, act)
    ref = te.step_batched(tmodel, tcfg, te.Tables(tmodel, tcfg), ts, act)
    for f in td.State._fields:
        assert torch.equal(getattr(out.state, f), getattr(ref.state, f)), f
    one = te.step(tmodel, tcfg, te.Tables(tmodel, tcfg), td.State(*(x[1] for x in ts)), act[1])
    for f in td.State._fields:      # batch sizes sum in other orders: one-tick tolerances
        close(getattr(ref.state, f)[1].numpy(), getattr(one.state, f),
              0.0 if f == "u" else 5e-5, 1e-4 if f == "u" else 0.0, what=f)
