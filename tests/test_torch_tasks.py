"""Port parity for the task envs: HumanoidHeading, HumanoidLocation and
HumanoidReach against ``ase_tpu``'s, on the shipped task configs at B = 8
with a reset chunk of 4 and goal changes every 1-2 steps (so the schedule
resamples within the test).

JAX and torch random streams differ, so the port draws its goal numbers
through ``_draw_goal`` and its reset numbers through ``_draw_reset``, and
``TaskDraws`` replays the JAX env's key chain into both (the split of
``HumanoidAMP._reset_actors``, then the task's ``_resample_goal``). The
physics step itself is held elsewhere (tests/test_torch_env.py; the HRL
window in tests/test_torch_hrl.py runs it for the heading task): here the
port steps, and the JAX env's own functions run on the port's state to
give what the reference computes from it -- the goal update of
``pre_physics_step`` on the step schedule, the task observation, the
reward, and a reset of a masked subset of envs -- all within 1e-5 of
scale (float32 trigonometry in another order).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ase_tpu.envs import parse_task as jparse
from ase_tpu.physics import dynamics as jd
from ase_tpu.utils import paths as jpaths
from ase_tpu_torch.envs import parse_task as tparse
from tests.test_torch_env import f32_solver
from tests.test_torch_train_parts import _one_torch_thread, t2n  # noqa: F401

B = 8
CLIP = "reallusion_sword_shield/RL_Avatar_Idle_Ready_Motion.npy"
TASKS = {
    "HumanoidHeading": ("humanoid_sword_shield_heading.yaml",
                        {"headingChangeStepsMin": 1, "headingChangeStepsMax": 3},
                        ("tar_dir", "tar_facing_dir", "tar_speed", "heading_change_steps",
                         "prev_root_pos")),
    "HumanoidLocation": ("humanoid_sword_shield_location.yaml",
                         {"tarChangeStepsMin": 1, "tarChangeStepsMax": 3},
                         ("tar_pos", "tar_change_steps", "prev_root_pos")),
    "HumanoidReach": ("humanoid_sword_shield_reach.yaml",
                      {"tarChangeStepsMin": 1, "tarChangeStepsMax": 3},
                      ("tar_pos", "tar_change_steps")),
}


def task_cfg(task, **env):
    name, overrides, _ = TASKS[task]
    with open(jpaths.data_path("cfg", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update({"numEnvs": B, "resetChunk": 4, "motion_file": CLIP, **overrides, **env})
    cfg["task"] = {"randomize": False}
    return cfg


class TaskDraws:
    """The numbers the JAX task env draws from ``key``, in the port's
    ``_draw_reset`` / ``_draw_goal`` format, advancing ``key`` as the JAX
    env advances its state's."""

    def __init__(self, jenv):
        self.jenv = jenv
        self.key = None

    def _split(self, n):
        keys = jax.random.split(self.key, n + 1)
        self.key = keys[0]
        return keys[1:]

    def reset(self, n):
        self._split(2)            # HumanoidAMP._reset_actors (Default init draws nothing)
        return self.goal(n)

    def goal(self, n):
        j, name = self.jenv, type(self.jenv).__name__
        if name == "HumanoidHeading":
            k = self._split(3)
            zero = jnp.zeros(n)
            rand = j._enable_rand_heading
            k2a, k2b = jax.random.split(k[2])
            d = {"goal_theta": jax.random.uniform(k[0], (n,), minval=-jnp.pi, maxval=jnp.pi)
                 if rand else zero,
                 "goal_face_theta": jax.random.uniform(k[1], (n,), minval=-jnp.pi, maxval=jnp.pi)
                 if rand else zero,
                 "goal_speed": jax.random.uniform(k2a, (n,), minval=j._tar_speed_min,
                                                  maxval=j._tar_speed_max),
                 "goal_change_steps": jax.random.randint(k2b, (n,), j._heading_change_steps_min,
                                                         j._heading_change_steps_max)}
        else:
            k = self._split(2)
            steps = jax.random.randint(k[1], (n,), j._tar_change_steps_min,
                                       j._tar_change_steps_max)
            if name == "HumanoidLocation":
                d = {"goal_offset": j._tar_dist_max * (2.0 * jax.random.uniform(k[0], (n, 2)) - 1.0),
                     "goal_change_steps": steps}
            else:
                r = jax.random.uniform(k[0], (n, 3))
                xy = j._tar_dist_max * (2.0 * r[:, 0:2] - 1.0)
                z = (j._tar_height_max - j._tar_height_min) * r[:, 2:3] + j._tar_height_min
                d = {"goal_pos": jnp.concatenate([xy, z], axis=-1), "goal_change_steps": steps}
        out = {}
        for k_, v in d.items():
            v = np.asarray(v)
            out[k_] = torch.as_tensor(v.astype(np.int64 if v.dtype.kind == "i" else np.float32))
        return out


def to_jax(ts, like, rng):
    """The port's env state as a JAX EnvState shaped like ``like``."""
    def a(t, ref):
        return jnp.asarray(t2n(t).astype(np.asarray(ref).dtype))

    kw = {f: a(getattr(ts, f), getattr(like, f))
          for f in ("body_pos", "body_quat", "body_vel", "body_ang_vel", "contact_forces", "obs",
                    "rew", "reset_buf", "terminate_buf", "progress", "actions")}
    phys = jd.State(*(a(getattr(ts.phys, f), getattr(like.phys, f)) for f in like.phys._fields))
    aux = {k: a(ts.aux[k], v) for k, v in like.aux.items()}
    return like.replace(phys=phys, aux=aux, rng=rng, **kw)


def close(ref, got, rel, what):
    ref = np.asarray(ref, np.float64)
    got = t2n(got).astype(np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol, (what, err, tol)


@pytest.mark.parametrize("task", sorted(TASKS))
def test_task_env_matches_reference(task):
    """The initial reset, three port steps (goal updates on the schedule,
    task obs and rewards against the JAX functions on the port's state),
    then a reset of envs 1, 4 and 6 only."""
    cfg = task_cfg(task)
    jenv = jparse(task, copy.deepcopy(cfg))
    tenv = tparse(task, copy.deepcopy(cfg), device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    goals, ntask = TASKS[task][2], tenv.get_task_obs_size()
    assert tenv.get_obs_size() == jenv.get_obs_size() == 253 + ntask
    draws = TaskDraws(jenv)
    tenv._draw_reset, tenv._draw_goal = draws.reset, draws.goal

    # the initial reset: every env, from the same draws
    key = jax.random.PRNGKey(4)
    js = jenv.initial_state(key)
    draws.key = key
    ts = tenv.initial_state()
    for g in goals:
        close(js.aux[g], ts.aux[g], 1e-6, f"initial {g}")
    close(js.obs, ts.obs, 1e-5, "initial obs")
    assert draws.key.tolist() == js.rng.tolist()

    rng = np.random.default_rng(0)
    resampled = np.zeros(B, bool)
    change = "heading_change_steps" if task == "HumanoidHeading" else "tar_change_steps"
    for i in range(3):
        ts = tenv.reset_done(ts)
        act = torch.as_tensor(rng.uniform(-1, 1, (B, 31)).astype(np.float32))
        jprev = to_jax(ts, js, draws.key)
        ts = tenv.step(ts, act)
        # the reference's goal update on the state the port stepped from
        jpre, _ = jenv.pre_physics_step(jprev, jnp.asarray(t2n(act)))
        assert draws.key.tolist() == jpre.rng.tolist()
        for g in goals:
            close(jpre.aux[g], ts.aux[g], 1e-6, f"step {i} {g}")
        resampled |= np.asarray(jpre.aux[change]) != np.asarray(jprev.aux[change])
        # task obs and reward of the stepped state, as the reference computes them
        jnow = to_jax(ts, js, draws.key)
        close(jenv._compute_task_obs(jnow), ts.obs[:, -ntask:], 1e-5, f"step {i} task obs")
        close(jenv._compute_observations(jnow), ts.obs, 1e-5, f"step {i} obs")
        close(jenv._compute_reward(jnow), ts.rew, 1e-5, f"step {i} reward")
        assert float(ts.rew.abs().max()) > 0
    assert resampled.sum() >= B // 2, resampled

    # a masked subset: envs 1, 4 and 6 reset (two chunk passes), the rest keep their goals
    flags = np.zeros(B, np.int32)
    flags[[1, 4, 6]] = 1
    ts = ts.replace(reset_buf=torch.as_tensor(flags))
    jr = jax.jit(jenv.reset_done)(to_jax(ts, js, draws.key))
    tr = tenv.reset_done(ts)
    assert draws.key.tolist() == jr.rng.tolist()
    np.testing.assert_array_equal(t2n(tr.progress), np.asarray(jr.progress))
    np.testing.assert_array_equal(t2n(tr.progress)[flags == 1], 0)
    for g in goals:
        close(jr.aux[g], tr.aux[g], 1e-6, f"reset {g}")
        keep = torch.as_tensor(flags == 0)
        assert torch.equal(tr.aux[g][keep], ts.aux[g][keep]), g
    close(jr.obs, tr.obs, 1e-5, "reset obs")
    close(jenv._compute_task_obs(to_jax(tr, js, draws.key)), tr.obs[:, -ntask:], 1e-5,
          "reset task obs")


def test_tasks_without_a_port_raise():
    """Strike, perturb and view-motion name their ROADMAP item."""
    for task in ("HumanoidStrike", "HumanoidPerturb", "HumanoidViewMotion"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tparse(task, task_cfg("HumanoidHeading"), device="cpu")
    assert math.isclose(tparse("HumanoidHeading", task_cfg("HumanoidHeading"),
                               device="cpu").dt, 1 / 30)
