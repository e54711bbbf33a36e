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

The prop tasks the same way: HumanoidStrike (the target's placement from
replayed draws through ``_draw_target``, its task obs, reward, successes
and the target-contact termination) and HumanoidPerturb (a launch on its
schedule from replayed ``_draw_perturb`` draws); their physics with props
is held in tests/test_torch_props.py.
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
from ase_tpu_torch.ops import quat as trot
from tests.test_torch_train_parts import _one_torch_thread, env_state_from_jax, t2n  # noqa: F401

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
    """Every task of the reference is ported: view-motion builds with the
    config it forces (one tick a control step, torque control, no
    self-collision) on a copy of the caller's, and plays its clips at the
    configured control rate."""
    cfg = task_cfg("HumanoidHeading")
    env = tparse("HumanoidViewMotion", cfg, device="cpu")
    assert env.control_freq_inv == 1 and math.isclose(env.dt, 1 / 60)
    assert math.isclose(env._motion_dt, 1 / 30)
    assert env.sim_cfg.torque_control and not env.sim_cfg.enable_self_collision
    assert (cfg["env"]["controlFrequencyInv"], cfg["env"].get("pdControl", True)) == (2, True)
    assert math.isclose(tparse("HumanoidHeading", task_cfg("HumanoidHeading"),
                               device="cpu").dt, 1 / 30)


# -- the prop tasks: strike and perturb -------------------------------------------------

PROP_TASKS = {"HumanoidStrike": "humanoid_sword_shield_strike.yaml",
              "HumanoidPerturb": "humanoid_ase_sword_shield.yaml"}


def prop_cfg(task, **env):
    with open(jpaths.data_path("cfg", PROP_TASKS[task])) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update({"numEnvs": B, "resetChunk": 4, "motion_file": CLIP, **env})
    cfg["task"] = {"randomize": False}
    return cfg


class PropDraws(TaskDraws):
    """The JAX strike env's reset draws (``HumanoidAMP._reset_actors``'s
    split, then the target placement's) and the JAX perturb env's per-step
    launch draws, in the port's ``_draw_reset`` / ``_draw_target`` /
    ``_draw_perturb`` formats."""

    def reset(self, n):
        self._split(2)
        return self.target(n)

    def target(self, n):
        j = self.jenv
        k = self._split(3)
        near = jax.random.uniform(k[0], (n,)) < j._near_prob
        dist_max = jnp.where(near, j._near_dist, j._tar_dist_max)
        dist = (dist_max - j._tar_dist_min) * jax.random.uniform(k[1], (n,)) + j._tar_dist_min
        k2a, k2b = jax.random.split(k[2])
        return self._torch({"target_dist": dist,
                            "target_theta": 2 * jnp.pi * jax.random.uniform(k2a, (n,)),
                            "target_yaw": 2 * jnp.pi * jax.random.uniform(k2b, (n,))})

    def perturb(self, n):
        j = self.jenv
        k = self._split(4)
        k3a, k3b = jax.random.split(k[3])
        return self._torch({
            "theta": 2 * jnp.pi * jax.random.uniform(k[0], (n,)),
            "dist": (j._proj_dist_max - j._proj_dist_min) * jax.random.uniform(k[1], (n,))
            + j._proj_dist_min,
            "height": (j._proj_h_max - j._proj_h_min) * jax.random.uniform(k[2], (n,))
            + j._proj_h_min,
            "aim_noise": jax.random.normal(k3a, (n, 3)),
            "speed": (j._proj_speed_max - j._proj_speed_min) * jax.random.uniform(k3b, (n, 1))
            + j._proj_speed_min})

    @staticmethod
    def _torch(d):
        return {k: torch.as_tensor(np.array(v, np.float32)) for k, v in d.items()}


def _prop_envs(task, **env):
    cfg = prop_cfg(task, **env)
    jenv = jparse(task, copy.deepcopy(cfg))
    tenv = tparse(task, copy.deepcopy(cfg), device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    return jenv, tenv, PropDraws(jenv)


def _tilt(angle):
    """(x, y, z, w) of a rotation by ``angle`` about x."""
    return torch.tensor([math.sin(angle / 2), 0.0, 0.0, math.cos(angle / 2)])


def test_strike_matches_reference():
    """HumanoidStrike against ase_tpu's at B = 8 with a reset chunk of 4:
    the initial reset's target placement from the replayed draws; then,
    on the port's state after 8 settling steps with the target knocked
    over in two envs, tilted in one and moving: the 15-dim task obs
    (1e-5 of scale), the reward (1e-6; the success override where the
    target's up axis is within cos 0.2 of horizontal), ``successes`` and
    the resets of ``post_physics_step``; the target-contact termination on
    crafted contact forces, exactly; and a reset of envs 1, 4 and 6 that
    places their targets anew and leaves the others'."""
    jenv, tenv, draws = _prop_envs("HumanoidStrike")
    assert tenv.get_obs_size() == jenv.get_obs_size() == 253 + 15
    assert tenv.model.num_props == jenv.model.num_props == 1
    tenv._draw_reset = draws.reset

    key = jax.random.PRNGKey(5)
    js = jenv.initial_state(key)
    draws.key = key
    ts = tenv.initial_state()
    assert draws.key.tolist() == js.rng.tolist()
    for f in ("prop_pos", "prop_quat", "u"):
        close(getattr(js.phys, f), getattr(ts.phys, f), 1e-6, f"initial {f}")
    close(js.obs, ts.obs, 1e-5, "initial obs")
    dist = np.linalg.norm(t2n(ts.phys.prop_pos[:, 0, :2] - ts.phys.root_pos[:, :2]), axis=-1)
    assert ((dist >= 0.5) & (dist <= 10.0)).all() and np.allclose(t2n(ts.phys.prop_pos[:, 0, 2]), 0.9)

    rng = np.random.default_rng(5)
    for _ in range(8):
        ts = tenv.reset_done(ts)
        ts = tenv.step(ts, torch.as_tensor(rng.uniform(-0.3, 0.3, (B, 31)).astype(np.float32)))
    phys = ts.phys
    quat, u = phys.prop_quat.clone(), phys.u.clone()
    nu = tenv.model.nu
    for e, angle in ((0, 1.5), (1, 2.0), (2, 0.6)):
        quat[e, 0] = trot.quat_mul(_tilt(angle), quat[e, 0])
    u[3, nu:nu + 6] = torch.tensor([0.5, -0.2, 0.1, 1.0, 0.3, -2.0])
    root = ts.body_pos[:, 0, :]
    toward = phys.prop_pos[:, 0, :] - root
    toward[:, 2] = 0.0
    prev = root - 0.03 * toward / toward.norm(dim=-1, keepdim=True)
    ts = ts.replace(phys=phys._replace(prop_quat=quat, u=u),
                    aux={**ts.aux, "prev_root_pos": prev})
    jnow = to_jax(ts, js, draws.key)
    close(jenv._compute_task_obs(jnow), tenv._compute_task_obs(ts), 1e-5, "task obs")
    close(jenv._compute_reward(jnow), tenv._compute_reward(ts), 1e-6, "reward")
    jpost, tpost = jenv.post_physics_step(jnow), tenv.post_physics_step(ts)
    np.testing.assert_array_equal(t2n(tpost.aux["successes"]), np.asarray(jpost.aux["successes"]))
    assert t2n(tpost.aux["successes"])[:3].tolist() == [1.0, 1.0, 0.0]
    close(jpost.rew, tpost.rew, 1e-6, "post-step reward")
    assert float(tpost.rew[0]) == float(tpost.rew[1]) == 1.0 and float(tpost.rew[3]) < 1.0
    close(jpost.obs, tpost.obs, 1e-5, "post-step obs")
    for f in ("reset_buf", "terminate_buf", "progress"):
        np.testing.assert_array_equal(t2n(getattr(tpost, f)), np.asarray(getattr(jpost, f)), f)

    # the target-contact failure: the target pushed sideways while a body
    # other than the feet and the strike bodies touches something, after step 1
    nb = tenv.model.nb
    forces = torch.zeros_like(ts.contact_forces)
    torso, sword, foot = (tenv.model.body_index(b) for b in ("torso", "sword", "left_foot"))
    forces[2:6, nb, 0] = 5.0                      # target pushed: envs 2-5
    forces[2, torso, 1] = -3.0                    # ... and the torso touches: fails
    forces[3, sword, 0] = -5.0                    # ... only the sword: no failure
    forces[4, foot, 2] = 500.0                    # ... only a foot: no failure
    forces[5, torso, 2] = 8.0                     # ... at progress 1: no failure
    forces[6, torso, 0] = 9.0                     # torso contact, target untouched
    progress = torch.full_like(ts.progress, 5)
    progress[5] = 1
    upright = ts.replace(contact_forces=forces, progress=progress,
                         body_pos=ts.body_pos + torch.tensor([0.0, 0.0, 2.0]))
    jr, jt = jenv._compute_reset(to_jax(upright, js, draws.key))
    tr, tt = tenv._compute_reset(upright)
    np.testing.assert_array_equal(t2n(tr), np.asarray(jr))
    np.testing.assert_array_equal(t2n(tt), np.asarray(jt))
    assert t2n(tt)[2:7].tolist() == [1, 0, 0, 0, 0]

    # a masked reset: envs 1, 4 and 6 get new targets, the rest keep theirs
    flags = np.zeros(B, np.int32)
    flags[[1, 4, 6]] = 1
    ts = ts.replace(reset_buf=torch.as_tensor(flags))
    jr = jax.jit(jenv.reset_done)(to_jax(ts, js, draws.key))
    tr = tenv.reset_done(ts)
    assert draws.key.tolist() == jr.rng.tolist()
    for f in ("prop_pos", "prop_quat", "u"):
        close(getattr(jr.phys, f), getattr(tr.phys, f), 1e-5, f"reset {f}")
        keep = torch.as_tensor(flags == 0)
        assert torch.equal(getattr(tr.phys, f)[keep], getattr(ts.phys, f)[keep]), f
    close(jr.obs, tr.obs, 1e-5, "reset obs")


def test_perturb_launch_matches_reference():
    """HumanoidPerturb against ase_tpu's at B = 8: the parked projectiles
    of the default pose (and, as the reference does, the reference-state
    resets' projectiles at the default state's origin); then
    ``post_physics_step`` at progress 59 (no launch) and 60 (the first
    small projectile launches at the torso from 4-5 m at 30-40 m/s) from
    the replayed per-step draws: prop poses and velocities within 1e-5 of
    scale, the other projectiles untouched, no termination."""
    jenv, tenv, draws = _prop_envs("HumanoidPerturb")
    assert tenv.model.num_props == jenv.model.num_props == 13
    tenv._draw_perturb = draws.perturb
    jdef, tdef = jenv.default_phys_state(B), tenv.default_phys_state(B)
    for f in jdef._fields:
        np.testing.assert_array_equal(t2n(getattr(tdef, f)), np.asarray(getattr(jdef, f)), f)
    assert t2n(tdef.prop_pos)[0, :, 0].tolist() == [200.0 + i for i in range(13)]

    js = jenv.initial_state(jax.random.PRNGKey(6))
    ts = env_state_from_jax(js, tenv.initial_state())
    ts = ts.replace(progress=torch.full_like(ts.progress, 59))
    draws.key = js.rng
    jst = to_jax(ts, js, draws.key)
    nu = tenv.model.nu
    for step in (59, 60):
        jst, ts = jenv.post_physics_step(jst), tenv.post_physics_step(ts)
        assert draws.key.tolist() == jst.rng.tolist()
        for f in ("prop_pos", "prop_quat", "u"):
            close(getattr(jst.phys, f), getattr(ts.phys, f), 1e-5, f"step {step} {f}")
        close(jst.obs, ts.obs, 1e-5, f"step {step} obs")
        assert not bool(ts.reset_buf.any()) and not bool(ts.terminate_buf.any())
    launched = ts.phys.u[:, nu:nu + 3].norm(dim=-1)
    assert bool(((launched >= 29.0) & (launched <= 42.0)).all()), launched
    offset = (ts.phys.prop_pos[:, 0, :2] - ts.body_pos[:, 0, :2]).norm(dim=-1)
    assert bool(((offset >= 4.0) & (offset <= 5.0)).all())
    before = env_state_from_jax(js, ts)
    assert torch.equal(ts.phys.prop_pos[:, 1:], before.phys.prop_pos[:, 1:])
    assert torch.equal(ts.phys.u[:, nu + 6:], before.phys.u[:, nu + 6:])
