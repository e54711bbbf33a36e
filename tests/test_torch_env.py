"""Port parity for the motion library and the HumanoidAMPGetup env.

JAX and torch random streams differ, so the port's env draws its reset
numbers through ``_draw_reset`` and the test hands it the numbers the JAX
env draws: ``JaxDraws`` replays the JAX env's key chain (the split order of
``HumanoidAMPGetup._reset_actors`` then ``HumanoidAMP._reset_actors``).
Fall states are the same numpy poses in both envs. B = 8 with a reset chunk
of 4, so an 8-env storm drains in two passes. The contact solve runs in
float32 on both sides (``matvec_bf16=False``).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ase_tpu.envs import parse_task as jparse
from ase_tpu.motion import motion_lib as jml
from ase_tpu.physics import dynamics as jd
from ase_tpu.utils import paths as jpaths
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.motion import motion_lib as tml


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs B <= 16 here: intra-op threads would only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


B = 8
MOTION = "reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"


def getup_cfg(**env):
    with open(jpaths.data_path("cfg", "humanoid_ase_sword_shield_getup.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update({"numEnvs": B, "resetChunk": 4, "motion_file": MOTION, **env})
    cfg["task"] = {"randomize": False}
    return cfg


def f32_solver(env):
    env.sim_cfg = env.sim_cfg._replace(solver=env.sim_cfg.solver._replace(matvec_bf16=False))


def to_jax_state(ts):
    return jd.State(*(jnp.asarray(x.numpy()) for x in ts))


class JaxDraws:
    """The numbers one JAX reset pass draws from ``key`` (and the key after
    it), in the port's ``_draw_reset`` format."""

    def __init__(self, jenv):
        self.jenv = jenv
        self.key = None

    def _split(self, n):
        keys = jax.random.split(self.key, n + 1)
        self.key = keys[0]
        return keys[1:]

    def __call__(self, n):
        k = self._split(3)
        d = {"u_recovery": jax.random.uniform(k[0], (n,)),
             "u_fall": jax.random.uniform(k[1], (n,)),
             "fall_idx": jax.random.randint(k[2], (n,), 0, self.jenv.num_envs)}
        k = self._split(2)
        k1, k2 = jax.random.split(k[0])
        w = self.jenv._motion_lib.weights
        d["motion_ids"] = jax.random.categorical(k1, jnp.log(jnp.maximum(w, 1e-12)), shape=(n,))
        d["motion_phase"] = jax.random.uniform(k2, (n,))
        d["u_hybrid"] = jax.random.uniform(k[1], (n,))
        out = {}
        for name, v in d.items():
            v = np.asarray(v)
            out[name] = torch.as_tensor(v.astype(np.int64 if v.dtype.kind == "i" else np.float32))
        return out


@pytest.fixture(scope="module")
def envs():
    cfg = getup_cfg()
    jenv = jparse("HumanoidAMPGetup", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMPGetup", copy.deepcopy(cfg), device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    # resting poses from the port's own 150-tick drop serve as both envs'
    # fall states (the drop itself is chaotic, see the test below)
    jenv._fall_states = to_jax_state(tenv.generate_fall_states())
    draws = JaxDraws(jenv)
    tenv._draw_reset = draws
    return jenv, tenv, draws


def close(ref, got, atol, what=""):
    ref = np.asarray(ref, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max())
    assert err <= atol, (what, err, atol)


def exact(ref, got, what=""):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref), err_msg=what)


def test_motion_state_queries_match_reference(envs):
    jenv, tenv, _ = envs
    jlib, tlib = jenv._motion_lib, tenv._motion_lib
    rng = np.random.default_rng(4)
    n = 64
    ids = rng.integers(0, tlib.num_motions, n)
    lengths = tlib.lengths.numpy()[ids]
    times = (rng.uniform(-0.1, 1.1, n) * lengths).astype(np.float32)
    times[:4] = [0.0, lengths[1], 1e-4, lengths[3] - 1e-4]
    jms = jml.get_motion_state(jlib, jnp.asarray(ids), jnp.asarray(times))
    tms = tml.get_motion_state(tlib, torch.as_tensor(ids), torch.as_tensor(times))
    assert set(jms) == set(tms)
    for k in jms:
        close(jms[k], tms[k], 2e-5, k)
    jb = jml.get_body_state(jlib, jnp.asarray(ids), jnp.asarray(times))
    tb = tml.get_body_state(tlib, torch.as_tensor(ids), torch.as_tensor(times))
    for a, b in zip(jb, tb):
        close(a, b, 2e-5)
    np.testing.assert_allclose(tlib.weights.numpy(), np.asarray(jlib.weights), rtol=1e-6)


def storm_key(jenv, term):
    """A key whose two 4-env reset passes give at least one recovery episode
    (a terminated env keeps its state) and one fall-state start."""
    for seed in range(1000):
        d = JaxDraws(jenv)
        d.key = jax.random.PRNGKey(seed)
        p = [d(4), d(4)]
        u_rec = np.concatenate([x["u_recovery"].numpy() for x in p])
        u_fall = np.concatenate([x["u_fall"].numpy() for x in p])
        rec = (u_rec < jenv._recovery_episode_prob) & (term == 1)
        fall = (u_fall < jenv._fall_init_prob) & ~rec
        if rec.any() and fall.any():
            return jax.random.PRNGKey(seed)
    raise AssertionError("no key found")


def _compare_states(js, ts, atol_phys, atol_obs, step="", rel_obs=0.0):
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
        close(getattr(js.phys, f), getattr(ts.phys, f), atol_phys, f"{step} {f}")
    for name, ref, got in (("obs", js.obs, ts.obs),
                           ("amp_obs", js.aux["amp_obs"], ts.aux["amp_obs"])):
        close(ref, got, atol_obs + rel_obs * float(np.abs(np.asarray(ref)).max()),
              f"{step} {name}")
    exact(js.progress, ts.progress, f"{step} progress")
    exact(js.aux["recovery_counter"], ts.aux["recovery_counter"], f"{step} recovery_counter")
    exact(js.aux["reset_ref_mask"], ts.aux["reset_ref_mask"], f"{step} reset_ref_mask")


def test_env_steps_and_reset_storm_match_reference(envs):
    """Initial reset, three control steps, a reset storm over all 8 envs
    (two chunk passes, recovery episodes for the terminated ones), and a
    step after it. Resets are deterministic given the draws, but a motion
    frame's joint angles come through 2 arccos(w) of a slerped quaternion:
    near zero angle one float32 ulp of w moves the angle by up to ~7e-4, so
    reset joint states are held to 1e-3, and observations, where chains of
    up to four joints carry that into body positions, to 3e-3. Stepping integrates
    contacts in float32 in another summation order; an env reset into a
    penetrating motion frame takes a stiff first step whose joint rates hit
    the 64 rad/s clamp, where the two sides differ by up to ~5e-3 of scale.
    Stepped states are held to 1e-2 and observations (which carry those
    velocities) to 1e-2 of their largest magnitude."""
    jenv, tenv, draws = envs
    key = jax.random.PRNGKey(0)
    js = jenv.initial_state(key)
    draws.key = jax.random.split(key)[1]
    ts = tenv.initial_state()
    _compare_states(js, ts, 1e-3, 3e-3, "initial")

    jstep, jreset = jax.jit(jenv.step), jax.jit(jenv.reset_done)
    rng = np.random.default_rng(1)
    for i in range(3):
        draws.key = js.rng
        ts = tenv.reset_done(ts)
        js = jreset(js)
        act = rng.uniform(-1, 1, size=(B, 31)).astype(np.float32)
        js = jstep(js, jnp.asarray(act))
        ts = tenv.step(ts, torch.as_tensor(act))
        _compare_states(js, ts, 1e-2, 0.0, f"step {i}", rel_obs=1e-2)
        exact(js.rew, ts.rew, "rew")
        exact(js.reset_buf, ts.reset_buf, "reset_buf")
        exact(js.terminate_buf, ts.terminate_buf, "terminate_buf")

    # reset storm: every env flagged, half of them terminated, from a key
    # whose two chunk passes start both recovery and fall-state episodes
    term = np.array([1, 0] * (B // 2), np.int32)
    js = js.replace(reset_buf=jnp.ones(B, jnp.int32), terminate_buf=jnp.asarray(term),
                    rng=storm_key(jenv, term))
    ts = ts.replace(reset_buf=torch.ones(B, dtype=torch.int32),
                    terminate_buf=torch.as_tensor(term))
    draws.key = js.rng
    js_r = jreset(js)
    ts_r = tenv.reset_done(ts)
    exact(js_r.reset_buf, ts_r.reset_buf, "storm reset_buf")
    assert int(ts_r.reset_buf.sum()) == 0
    assert bool((ts_r.aux["recovery_counter"] == jenv._recovery_steps).any())
    # recovery episodes keep their stepped state; the rest reset exactly
    _compare_states(js_r, ts_r, 1e-2, 0.0, "storm", rel_obs=1e-2)
    fresh = ~np.asarray(js_r.aux["recovery_counter"] > 0) | (term == 0)
    close(np.asarray(js_r.obs)[fresh], ts_r.obs[torch.as_tensor(fresh)], 3e-3, "storm fresh obs")

    act = rng.uniform(-1, 1, size=(B, 31)).astype(np.float32)
    js2 = jstep(js_r, jnp.asarray(act))
    ts2 = tenv.step(ts_r, torch.as_tensor(act))
    _compare_states(js2, ts2, 1e-2, 0.0, "after storm", rel_obs=1e-2)


def test_fall_state_generation_runs_on_the_port(envs):
    """generate_fall_states dropped every env for 150 ticks and cached the
    poses with zero velocity (the chaotic drop itself is not held against
    JAX: contacts diverge long before the end)."""
    fall = envs[1]._fall_states
    assert float(fall.u.abs().max()) == 0.0
    assert bool(torch.isfinite(fall.root_pos).all())
    assert float(fall.root_pos[:, 2].max()) < 0.5          # lying on the ground
    # domain randomization is ported (tests/test_torch_domain_rand.py):
    # --randomize without a randomization_params block leaves it off, as in
    # the reference, and with one turns it on
    cfg = getup_cfg()
    cfg["task"]["randomize"] = True
    assert not tparse("HumanoidAMPGetup", copy.deepcopy(cfg), device="cpu")._dr.enabled
    cfg["task"]["randomization_params"] = {"frequency": 2, "actions": {"range": [0.0, 0.02]}}
    assert tparse("HumanoidAMPGetup", cfg, device="cpu")._dr.enabled
    # torque control is ported: pdControl false builds a torque-control
    # engine config with the env's power scale
    cfg = getup_cfg(pdControl=False, powerScale=0.5)
    sim_cfg = tparse("HumanoidAMPGetup", cfg, device="cpu").sim_cfg
    assert sim_cfg.torque_control and sim_cfg.power_scale == 0.5
