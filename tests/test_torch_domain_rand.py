"""Port parity for domain randomization: the randomizer, one engine tick
per knob, a few control steps of HumanoidAMP under the whole block, and
``--randomize`` through the training CLI.

The port draws unit numbers (standard normals, uniforms on [0, 1)) through
the env's ``_draw_*`` methods; these tests hand it the numbers the JAX key
chain draws (``jax_units``, ``DRDraws``), so both sides see the same
samples. The block is tests/test_domain_rand.py's ``_dr_cfg`` (frequency 2,
every knob on). Engine ticks run float32 on both sides
(``matvec_bf16=False``).
"""

import copy
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ase_tpu.envs import parse_task as jparse
from ase_tpu.envs.domain_rand import DomainRandomizer as JDR
from ase_tpu.envs.domain_rand import NoiseSpec as JSpec
from ase_tpu.physics import collision2 as jc2
from ase_tpu.physics import engine as je
from ase_tpu.physics import mjcf as jm
from ase_tpu.physics import solver as jsol
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.envs.domain_rand import DomainRandomizer as TDR
from ase_tpu_torch.envs.domain_rand import NoiseSpec as TSpec
from ase_tpu_torch.physics import engine as te
from ase_tpu_torch.physics import mjcf as tm
from ase_tpu_torch.physics.solver import SolverConfig
from tests.test_domain_rand import _dr_cfg
from tests.test_env import make_cfg
from tests.test_torch_props import both, standing_state
from tests.test_torch_train_parts import _one_torch_thread  # noqa: F401  (autouse)

ASSET = "mjcf/amp_humanoid_sword_shield.xml"
B = 8
POS_TOL = 5e-5        # chip_smoke.TICK_POS_TOL
VEL_RTOL = 1e-4       # chip_smoke.TICK_VEL_RTOL
JAX_KNOB_ORDER = ("friction_scale", "mass_scale", "stiffness_scale", "damping_scale",
                  "gravity_scale", "restitution", "actor_scale")   # keys[i] of resample_scales


def t2n(x):
    return x.detach().cpu().numpy()


def jax_units(key, jdr, scales):
    """The unit draws the JAX ``resample_scales(key, scales, ...)`` takes:
    normal or uniform at each sampled knob's shape, from split(key, 7)."""
    keys = jax.random.split(key, 7)
    out = {}
    for i, knob in enumerate(JAX_KNOB_ORDER):
        spec = getattr(jdr, {"friction_scale": "friction_spec", "mass_scale": "mass_spec",
                             "stiffness_scale": "stiffness_spec",
                             "damping_scale": "damping_spec", "gravity_scale": "gravity_spec",
                             "restitution": "restitution_spec",
                             "actor_scale": "scale_spec"}[knob])
        if spec is None:
            continue
        shape = scales[knob].shape
        u = (jax.random.normal(keys[i], shape) if spec.distribution == "gaussian"
             else jax.random.uniform(keys[i], shape))
        out[knob] = torch.as_tensor(np.array(u))
    return out


def _jgen(rng, n):
    """A correlated generator (tests/test_domain_rand.py): friction equal
    to mass, one draw per env."""
    v = 1.0 + 0.25 * jax.random.normal(rng, (n,))
    return {"friction_scale": v, "mass_scale": v}


def _extreme_cfg():
    """_dr_cfg with ranges past the clips: restitution up to 1.6 from a
    0.5 base, actor scales -5 to 12."""
    cfg = _dr_cfg()
    h = cfg["actor_params"]["humanoid"]
    h["rigid_shape_properties"]["restitution"]["range"] = [-0.9, 1.1]
    h["scale"] = {"range": [-5.0, 12.0], "operation": "scaling", "distribution": "uniform"}
    return cfg


def _span(cfg):
    """The largest |lo|, |hi| or hi - lo of the block's knob ranges."""
    out = []

    def walk(d):
        for v in d.values():
            if isinstance(v, dict):
                if "range" in v:
                    lo, hi = v["range"]
                    out.extend([abs(lo), abs(hi), hi - lo])
                else:
                    walk(v)

    walk(cfg)
    return max(out)


def _ulp_close(ref, got, what, span):
    """Within one float32 ulp of max(|ref|, span), elementwise: the same
    unit draws go through the same float32 ops, but XLA:CPU may contract
    u x (hi - lo) + lo into one fused multiply-add, which skips the
    rounding of the product (|product| <= span); integers exact."""
    ref, got = np.asarray(ref), t2n(got)
    if ref.dtype.kind in "iub":
        np.testing.assert_array_equal(got, ref, err_msg=what)
        return
    err = np.abs(got.astype(np.float64) - ref)
    tol = np.spacing(np.maximum(np.abs(ref), span).astype(np.float32))
    assert bool((err <= tol).all()), (what, float(err.max()))


@pytest.mark.parametrize("case", ["gating", "setup_only", "generator", "clips"])
def test_resample_scales_matches_reference(case):
    """Three resamples with partial masks from the same unit draws (the
    JAX key chain's): every knob within one float32 ulp of the reference's
    at the ranges' scale (``_ulp_close``) and dr_count equal.
    Frequency 2 gates the second resample of an env; a setup_only knob is
    drawn only at an env's first; the generator's correlated samples
    override the knobs it names; restitution clips to [0, 1] and the actor
    scale to [0.1, 10]."""
    cfg = _extreme_cfg() if case == "clips" else _dr_cfg()
    if case == "setup_only":
        cfg["actor_params"]["humanoid"]["rigid_body_properties"]["mass"]["setup_only"] = True
    jdr = JDR(cfg, generator=_jgen if case == "generator" else None)
    tdr = TDR(cfg)
    n, nb, ns, nd = 16, 17, 18, 31
    base = 0.5 if case == "clips" else 0.0
    js = jdr.init_scales(n, base_restitution=base, num_bodies=nb, num_shapes=ns, num_dofs=nd)
    ts = tdr.init_scales(n, base, num_bodies=nb, num_shapes=ns, num_dofs=nd, device="cpu")
    masks = [np.ones(n, bool), np.arange(n) % 2 == 0, np.arange(n) % 3 != 1]
    for i, m in enumerate(masks):
        key = jax.random.PRNGKey(10 + i)
        units = jax_units(key, jdr, js)
        gen = None
        if case == "generator":
            gen = {k: torch.as_tensor(np.array(v))
                   for k, v in _jgen(jax.random.fold_in(key, 101), n).items()}
        js = jdr.resample_scales(key, js, jnp.asarray(m))
        ts = tdr.resample_scales(units, ts, torch.as_tensor(m), gen)
        for k in js:
            _ulp_close(js[k], ts[k], f"resample {i} {k}", _span(cfg))
    assert int(ts["dr_count"].max()) == 3
    if case == "generator":
        assert torch.equal(ts["friction_scale"][:, 0], ts["mass_scale"][:, 0])
    if case == "clips":
        r, a = ts["restitution"], ts["actor_scale"]
        assert float(r.min()) == 0.0 and float(r.max()) == 1.0
        assert float(a.min()) == pytest.approx(0.1) and float(a.max()) == 10.0
    if case == "setup_only":
        # envs reset three times: mass drawn once, friction again at the third
        j = np.asarray(jax.device_get(js["dr_count"]))
        assert (j == 3).any()
    with pytest.raises(KeyError):
        tdr.resample_scales(jax_units(jax.random.PRNGKey(0), jdr, js), ts,
                            torch.ones(n, dtype=torch.bool), {"nope": torch.ones(n)})


@pytest.mark.parametrize("dist,op", [("gaussian", "additive"), ("uniform", "additive"),
                                     ("uniform", "scaling")])
def test_noise_spec_ramp_matches_reference(dist, op):
    """A linear schedule over 100 steps: noise at steps 5, 40 and 150 from
    the same unit draws equals the reference's to one float32 rounding."""
    cfg = {"range": [0.2, 1.4] if op == "scaling" else [0.0, 0.5], "operation": op,
           "distribution": dist, "schedule": "linear", "schedule_steps": 100}
    js, ts = JSpec(cfg), TSpec(cfg)
    x = np.random.default_rng(0).normal(size=(64, 5)).astype(np.float32)
    spread = []
    for step in (5.0, 40.0, 150.0):
        key = jax.random.PRNGKey(int(step))
        u = (jax.random.normal(key, x.shape) if dist == "gaussian"
             else jax.random.uniform(key, x.shape))
        ref = np.asarray(js.apply(key, jnp.asarray(x), jnp.asarray(step)))
        got = t2n(ts.apply(torch.as_tensor(np.array(u)), torch.as_tensor(x),
                           torch.tensor(step)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2 * np.spacing(np.abs(ref).max()))
        spread.append(float(np.std(got - x if op == "additive" else got / x)))
    assert spread[0] < spread[1] < spread[2]


# -- one engine tick per knob ------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    path = tm.find_asset("", ASSET)
    jmodel, tmodel = jm.load_mjcf(path), tm.load_mjcf(path, device="cpu")
    tcfg = te.SimConfig(solver=SolverConfig(matvec_bf16=False))
    jcfg = je.SimConfig(solver=jsol.SolverConfig(matvec_bf16=False))
    return jmodel, jc2.build_tables(jmodel, True), jcfg, tmodel, te.Tables(tmodel, tcfg), tcfg


@pytest.fixture(scope="module")
def jax_tick(world):
    """ONE compile of the JAX tick with every knob an argument."""
    jmodel, jt, jcfg, _, _, _ = world
    return jax.jit(partial(je.step_batched, jmodel, jcfg, jt))


def _knobs(case, nb, nd, seed):
    """Every knob at its base (scales 1, restitution 0), the knob of
    ``case`` (all of them for "all", none for "base") drawn away from it."""
    rng = np.random.default_rng(seed)
    k = {"friction_scale": np.ones((B, nb)), "gain_scale": np.ones((B, nd)),
         "mass_scale": np.ones((B, nb)), "gravity_scale": np.ones(B),
         "damping_scale": np.ones((B, nd)), "restitution": np.zeros(B),
         "actor_scale": np.ones(B)}
    draw = {"friction_scale": lambda: rng.uniform(0.05, 1.3, (B, nb)),
            "gain_scale": lambda: rng.uniform(0.5, 1.5, (B, nd)),
            "mass_scale": lambda: rng.uniform(0.6, 1.4, (B, nb)),
            "gravity_scale": lambda: rng.uniform(0.5, 1.5, B),
            "damping_scale": lambda: rng.uniform(0.1, 3.0, (B, nd)),
            "restitution": lambda: rng.uniform(0.3, 0.9, B),
            "actor_scale": lambda: rng.uniform(0.9, 1.1, B)}
    for name in (draw if case == "all" else [case] if case in draw else []):
        k[name] = draw[name]()
    return {name: v.astype(np.float32) for name, v in k.items()}


@pytest.mark.parametrize("case", ["mass_scale", "gravity_scale", "friction_scale", "gain_scale",
                                  "damping_scale", "restitution", "actor_scale", "all"])
def test_one_tick_per_knob_matches_reference(world, jax_tick, case):
    """One tick of 8 standing characters in their default pose (random
    heading), falling at 0.5-1.5 m/s onto the plane so that the feet
    impact, under random PD targets, with one knob (or all) away from its
    base: every state field at ``chip_smoke.check_tick``'s tolerances
    (positions 5e-5, velocities and contact forces 1e-4 of scale), and the
    knob moves the tick by more than that against the port's tick at the
    base values."""
    jmodel, _, _, tmodel, tt, tcfg = world
    s = standing_state((None, jmodel, None, None, None), 5, quiet=True)
    rng = np.random.default_rng(5)
    s["root_pos"][:, 2] = rng.uniform(0.86, 0.9, B).astype(np.float32)
    s["u"][:, 2] = -rng.uniform(0.5, 1.5, B).astype(np.float32)
    act = rng.uniform(-0.5, 0.5, size=(B, 31)).astype(np.float32)
    js, ts = both(s)
    knobs = _knobs(case, jmodel.nb + jmodel.num_props, jmodel.nd, 6)
    jo = jax_tick(js, jnp.asarray(act), **{k: jnp.asarray(v) for k, v in knobs.items()})
    tk = {k: torch.as_tensor(v) for k, v in knobs.items()}
    to = te.step_batched(tmodel, tcfg, tt, ts, torch.as_tensor(act), **tk)
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
        ref = np.asarray(getattr(jo.state, f))
        err = float(np.abs(ref - t2n(getattr(to.state, f))).max())
        assert err <= POS_TOL, (f, err)
    for name, ref, got in (("u", jo.state.u, to.state.u),
                           ("contact_forces", jo.contact_forces, to.contact_forces),
                           ("dof_forces", jo.dof_forces, to.dof_forces)):
        ref = np.asarray(ref)
        err = float(np.abs(ref - t2n(got)).max())
        assert err <= VEL_RTOL * float(np.abs(ref).max()), (name, err)
    assert float(np.abs(np.asarray(jo.contact_forces)).max()) > 0      # the feet touched
    at_base = _knobs("base", jmodel.nb + jmodel.num_props, jmodel.nd, 6)
    base = te.step_batched(tmodel, tcfg, tt, ts, torch.as_tensor(act),
                           **{k: torch.as_tensor(v) for k, v in at_base.items()})
    moved = float((base.state.u - to.state.u).abs().max())
    assert moved > 10 * VEL_RTOL * float(to.state.u.abs().max()), moved


# -- HumanoidAMP under the whole block -------------------------------------------------------

class DRDraws:
    """The numbers the JAX HumanoidAMP (Default starts) draws under domain
    randomization, in the port's ``_draw_reset`` / ``_draw_dr_noise``
    formats: a reset pass splits one key for the knobs (split(k, 7) across
    them) and two for ``_reset_actors``; a control step one for the action
    noise and one for the observation noise."""

    def __init__(self, jenv, scales_like):
        self.jenv = jenv
        self.like = scales_like
        self.key = None

    def _split(self):
        keys = jax.random.split(self.key, 2)
        self.key = keys[0]
        return keys[1]

    def reset(self, n):
        like = {k: np.zeros((n,) + tuple(v.shape[1:])) for k, v in self.like.items()
                if np.ndim(v)}
        units = jax_units(self._split(), self.jenv._dr, like)
        self.key = jax.random.split(self.key, 3)[0]          # _reset_actors' split(2)
        return {"dr_" + k: v for k, v in units.items()}

    def noise(self, which, shape):
        spec = self.jenv._dr.act_spec if which == "actions" else self.jenv._dr.obs_spec
        k = self._split()
        u = jax.random.normal(k, shape) if spec.distribution == "gaussian" else \
            jax.random.uniform(k, shape)
        return torch.as_tensor(np.array(u))


def _dr_env_cfg():
    cfg = make_cfg(stateInit="Default", numEnvs=B, resetChunk=4)
    cfg["task"] = {"randomize": True, "randomization_params": _dr_cfg()}
    return cfg


def _f32(env):
    env.sim_cfg = env.sim_cfg._replace(solver=env.sim_cfg.solver._replace(matvec_bf16=False))


def test_humanoid_amp_under_the_whole_block_matches_reference():
    """HumanoidAMP, 8 envs, Default starts, reset chunk 4, the whole block:
    the initial reset (every env due), three control steps with action and
    observation noise, then a chunked reset pass over 3 flagged envs
    (dr_count 1 -> 2: due again at frequency 2) and a step. The knobs are
    within one float32 ulp (``_ulp_close``) and the counters equal; physics under scaled actors starts from feet up to 13 cm in the
    ground or above it, so the steps are stiff: positions are held to 1e-3
    and observations, which carry the velocities, to 1e-2 of their scale
    (tests/test_torch_env.py's bounds for stiff steps)."""
    cfg = _dr_env_cfg()
    jenv = jparse("HumanoidAMP", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMP", copy.deepcopy(cfg), device="cpu")
    _f32(jenv)
    _f32(tenv)
    key = jax.random.PRNGKey(3)
    js = jenv.initial_state(key)
    draws = DRDraws(jenv, jax.device_get(js.aux["dr"]))
    draws.key = key
    tenv._draw_reset = draws.reset
    tenv._draw_dr_noise = draws.noise
    ts = tenv.initial_state()

    def compare(what, pos_tol, obs_rtol):
        for k, v in js.aux["dr"].items():
            _ulp_close(v, ts.aux["dr_" + k if not k.startswith("dr_") else k], f"{what} {k}",
                       _span(_dr_cfg()))
        for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
            err = float(np.abs(np.asarray(getattr(js.phys, f)) - t2n(getattr(ts.phys, f))).max())
            assert err <= pos_tol, (what, f, err)
        ref = np.asarray(js.obs)
        err = float(np.abs(ref - t2n(ts.obs)).max())
        assert err <= obs_rtol * float(np.abs(ref).max()), (what, "obs", err)

    compare("initial", 1e-6, 1e-6)
    for k in ("mass_scale", "friction_scale", "actor_scale", "restitution"):
        assert not np.allclose(np.asarray(js.aux["dr"][k]), 1.0 if k != "restitution" else 0.0)
    jstep, jreset = jax.jit(jenv.step), jax.jit(jenv.reset_done)
    rng = np.random.default_rng(4)
    for i in range(3):
        act = rng.uniform(-1, 1, size=(B, 31)).astype(np.float32)
        draws.key = js.rng
        js = jstep(js, jnp.asarray(act))
        ts = tenv.step(ts, torch.as_tensor(act))
        compare(f"step {i}", 1e-3, 1e-2)
    flags = np.zeros(B, np.int32)
    flags[[1, 4, 6]] = 1
    js = js.replace(reset_buf=jnp.asarray(flags))
    ts = ts.replace(reset_buf=torch.as_tensor(flags))
    draws.key = js.rng
    js = jreset(js)
    ts = tenv.reset_done(ts)
    compare("chunked reset", 1e-3, 1e-2)
    assert t2n(ts.aux["dr_count"]).tolist() == [1 + f for f in flags]
    act = rng.uniform(-1, 1, size=(B, 31)).astype(np.float32)
    draws.key = js.rng
    js = jstep(js, jnp.asarray(act))
    ts = tenv.step(ts, torch.as_tensor(act))
    compare("after the reset", 1e-3, 1e-2)
    assert float(ts.aux["dr_step_count"]) == 4.0


def test_randomize_trains_through_the_cli(tmp_path):
    """``--randomize`` with an env config holding the block: ``run.main``
    trains an AMP agent for two epochs on the CPU; every knob left its
    base in some env and every env has reset at least once; without
    ``--randomize`` the block is ignored."""
    from ase_tpu_torch import run
    from tests.test_torch_train_cli import _argv, _run_keep_agent

    env_cfg = make_cfg(stateInit="Default", numEnvs=4)
    env_cfg["task"] = {"randomization_params": _dr_cfg()}
    path = tmp_path / "env.yaml"
    path.write_text(yaml.safe_dump(env_cfg))
    argv = _argv(tmp_path) + ["--cfg_env", str(path), "--device", "cpu"]
    agent, env_state, record = _run_keep_agent(argv + ["--randomize"])
    assert agent.env._dr.enabled and agent.epoch == 2
    aux = env_state.aux
    for k, base in (("friction_scale", 1.0), ("mass_scale", 1.0), ("stiffness_scale", 1.0),
                    ("damping_scale", 1.0), ("gravity_scale", 1.0), ("actor_scale", 1.0),
                    ("restitution", 0.0)):
        assert bool((aux["dr_" + k] != base).any()), k
    assert int(aux["dr_count"].min()) >= 1 and float(aux["dr_step_count"]) == 8.0
    assert np.isfinite(record["metrics"]["disc_loss"])
    off, _, _ = run.build_agent(argv)
    assert not off.env._dr.enabled and not any(k.startswith("dr_") for k in
                                               off.env._initial_aux(4))
