"""The port's gym-style adapter (``ase_tpu_torch/envs/vec_env.py``) against
``ase_tpu``'s ``VecEnv`` on HumanoidAMP (tests/test_env.py's config: 4
envs, the idle clip, Random starts), float32 contact solve on both sides.

The adapter draws nothing of its own. The port's reset draws go through
``_draw_reset``, and ``AMPDraws`` replays the JAX env's key chain into it
(``HumanoidAMP._reset_actors``'s split). Step and reset are held from a
state carried over from the JAX adapter, at tests/test_torch_env.py's
tolerances: a stepped state to 1e-2 and its observations to 1e-2 of their
largest magnitude, a reset state to 1e-3 and its observations to 3e-3
(motion frames' joint angles come through 2 arccos(w) of a slerped
quaternion).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.envs import parse_task as jparse
from ase_tpu.envs.vec_env import VecEnv as JVecEnv
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.envs.vec_env import VecEnv
from tests.test_env import make_cfg
from tests.test_torch_env import close, exact, f32_solver
from tests.test_torch_train_parts import _one_torch_thread, env_state_from_jax  # noqa: F401

B = 4


class AMPDraws:
    """The numbers one JAX HumanoidAMP reset pass draws from ``key`` (and
    the key after it), in the port's ``_draw_reset`` format."""

    def __init__(self, jenv):
        self.jenv = jenv
        self.key = None

    def __call__(self, n):
        keys = jax.random.split(self.key, 3)
        self.key, k0, k1 = keys
        ka, kb = jax.random.split(k0)
        w = self.jenv._motion_lib.weights
        d = {"motion_ids": jax.random.categorical(ka, jnp.log(jnp.maximum(w, 1e-12)), shape=(n,)),
             "motion_phase": jax.random.uniform(kb, (n,)),
             "u_hybrid": jax.random.uniform(k1, (n,))}
        return {k: torch.as_tensor(np.asarray(v).astype(np.int64 if k == "motion_ids"
                                                        else np.float32))
                for k, v in d.items()}


def _compare_states(js, ts, atol_phys, atol_obs, what, rel_obs=0.0):
    """tests/test_torch_env.py's comparison, on HumanoidAMP's aux keys."""
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
        close(getattr(js.phys, f), getattr(ts.phys, f), atol_phys, f"{what} {f}")
    for name, ref, got in (("obs", js.obs, ts.obs),
                           ("amp_obs", js.aux["amp_obs"], ts.aux["amp_obs"])):
        close(ref, got, atol_obs + rel_obs * float(np.abs(np.asarray(ref)).max()),
              f"{what} {name}")
    exact(js.progress, ts.progress, f"{what} progress")
    exact(js.aux["reset_ref_mask"], ts.aux["reset_ref_mask"], f"{what} reset_ref_mask")


@pytest.fixture(scope="module")
def adapters():
    cfg = make_cfg()
    jenv = jparse("HumanoidAMP", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMP", copy.deepcopy(cfg), device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    return JVecEnv(jenv), VecEnv(tenv)


def test_vec_env_adapter(adapters):
    """tests/test_tasks.py's shapes, on the env's device."""
    _, vec = adapters
    info = vec.get_env_info()
    assert info["action_space"].shape == (31,)
    assert info["observation_space"].shape == (253,)
    assert info["amp_observation_space"].shape == (1400,)
    obs, rew, done, infos = vec.step(np.zeros((B, 31)))
    assert obs.shape == (B, 253) and rew.shape == (B,) and done.shape == (B,)
    assert infos["amp_obs"].shape == (B, 1400) and infos["terminate"].shape == (B,)
    obs = vec.reset([0, 1])
    assert obs.shape == (B, 253) and obs.device == vec.task.device
    demo = vec.fetch_amp_obs_demo(8)
    assert demo.shape == (8, 1400) and bool(torch.isfinite(demo).all())


def test_vec_env_step_and_partial_reset_match_reference(adapters):
    """One ``step`` and one ``reset([0, 1])`` from the JAX adapter's state:
    the same observations, rewards, flags, AMP observations and, after the
    reset, the reset envs' new states with the others untouched."""
    jvec, vec = adapters
    draws = AMPDraws(jvec.task)
    vec.task._draw_reset = draws
    vec.state = env_state_from_jax(jvec.state, vec.state)
    act = np.random.default_rng(3).uniform(-1, 1, (B, 31)).astype(np.float32)
    jobs, jrew, jdone, jinfo = jvec.step(jnp.asarray(act))
    obs, rew, done, info = vec.step(torch.as_tensor(act))
    _compare_states(jvec.state, vec.state, 1e-2, 0.0, "step", rel_obs=1e-2)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0,
                               atol=1e-2 * float(np.abs(np.asarray(jobs)).max()))
    np.testing.assert_allclose(rew.numpy(), np.asarray(jrew), rtol=0, atol=1e-2)
    exact(jdone, done, "done")
    exact(jinfo["terminate"], info["terminate"], "terminate")
    np.testing.assert_allclose(info["amp_obs"].numpy(), np.asarray(jinfo["amp_obs"]), rtol=0,
                               atol=1e-2 * float(np.abs(np.asarray(jinfo["amp_obs"])).max()))

    vec.state = env_state_from_jax(jvec.state, vec.state)
    before = vec.state
    draws.key = jvec.state.rng
    jobs = jvec.reset([0, 1])
    obs = vec.reset([0, 1])
    assert draws.key.tolist() == jvec.state.rng.tolist()
    _compare_states(jvec.state, vec.state, 1e-3, 3e-3, "reset")
    np.testing.assert_allclose(obs.numpy(), np.asarray(jobs), rtol=0, atol=3e-3)
    np.testing.assert_array_equal(vec.state.progress.numpy()[:2], 0)
    assert torch.equal(vec.state.phys.root_pos[2:], before.phys.root_pos[2:])
    assert not torch.equal(vec.state.phys.root_pos[:2], before.phys.root_pos[:2])


def test_vec_env_clips_actions_and_observations(adapters):
    """Actions are clipped to ``clip_actions`` before the env sees them
    (the stepped state is bit-equal to a step with pre-clipped actions);
    observations to ``clip_obs``."""
    _, vec = adapters
    clipped = VecEnv(vec.task, clip_obs=0.5, clip_actions=0.25)
    start = vec.state
    act = torch.as_tensor(np.random.default_rng(4).uniform(-2, 2, (B, 31)).astype(np.float32))
    clipped.state = start
    obs, _, _, _ = clipped.step(act)
    assert float(obs.abs().max()) <= 0.5 and float(clipped.state.obs.abs().max()) > 0.5
    torch.testing.assert_close(clipped.state.actions, act.clamp(-0.25, 0.25), rtol=0, atol=0)
    vec.state = start
    vec.step(act.clamp(-0.25, 0.25))
    for a, b in zip(clipped.state.phys, vec.state.phys):
        assert torch.equal(a, b)
