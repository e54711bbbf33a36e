"""Port parity for torque control and the view-motion task: one engine
tick under ``torque_control`` (``pdControl: false``) with a power scale
other than 1, HumanoidViewMotion stepped across its clips' ends against
``ase_tpu``'s, and ``ase_tpu_torch.run --test --task HumanoidViewMotion``
on the CPU.

Inputs are built with numpy from a seed and handed to ase_tpu and to
ase_tpu_torch on the CPU. The tick compares float32 with float32
(``matvec_bf16=False``) at tests/test_torch_physics.py's tolerances; the
view-motion envs, whose bodies are set from the motion library after each
tick, to 1e-5 m of the reference's motion frames.
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
from ase_tpu.motion import motion_lib as jml
from ase_tpu.physics import dynamics2 as jd2
from ase_tpu.physics import engine as je
from ase_tpu.physics import solver as jsol
from ase_tpu.utils import paths as jpaths
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.physics import engine as te
from ase_tpu_torch.physics.solver import SolverConfig
from tests.test_torch_physics import (  # noqa: F401  (the autouse fixture)
    B, _one_torch_thread, close, models, random_state, tables)
from tests.test_torch_train_parts import t2n

MOTION = "reallusion_sword_shield/dataset_reallusion_sword_shield.yaml"
ENVS = 4


def test_torque_control_tick_matches_reference(models, tables):
    """One tick from random state 21 with nonzero actions as torques
    (action x motor gear x power scale 0.7), plus the limit torques:
    positions to 5e-5, velocities, contact forces and the applied dof
    torques to 1e-4 of their scale."""
    jcfg = je.SimConfig(solver=jsol.SolverConfig(matvec_bf16=False), torque_control=True,
                        power_scale=0.7)
    tcfg = te.SimConfig(solver=SolverConfig(matvec_bf16=False), torque_control=True,
                        power_scale=0.7)
    js, ts = random_state(models, 21, height=(0.2, 0.6))
    act = np.random.default_rng(22).uniform(-1, 1, size=(B, 31)).astype(np.float32)
    jo = jax.jit(partial(je.step_batched, models[0], jcfg, tables[0]))(js, jnp.asarray(act))
    to = te.step_batched(models[1], tcfg, tables[1], ts, torch.as_tensor(act))
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q"):
        close(getattr(jo.state, f), getattr(to.state, f), 5e-5)
    close(jo.state.u, to.state.u, 0.0, 1e-4)
    close(jo.contact_forces, to.contact_forces, 0.0, 1e-4)
    close(jo.dof_forces, to.dof_forces, 0.0, 1e-4)
    # the torques are the scaled actions (the limit torques add where a
    # joint is past its limit)
    gear = models[1].np("motor_gear")
    assert float(np.median(np.abs(t2n(to.dof_forces) - 0.7 * gear * act))) < 1e-3 * gear.max()


def view_cfg():
    with open(jpaths.data_path("cfg", "humanoid_ase_sword_shield.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update({"numEnvs": ENVS, "motion_file": MOTION})
    cfg["task"] = {"randomize": False}
    return cfg


def test_view_motion_across_clip_ends_matches_reference():
    """HumanoidViewMotion at 4 envs on the 87-clip dataset: the initial
    reset plays clips 0-3; each env is then put 0-3 control steps before
    its clip's end and both envs step 5 times (reset pass, step): each
    reset moves its env on by num_envs clips, motion ids, progress and
    resets equal the reference's, and body positions agree to 1e-5 m with
    the reference's motion library and FK on the same frames after every
    step (to 1e-3 m with its jitted step). A reset draws no random
    numbers, in either package."""
    cfg = view_cfg()
    jenv = jparse("HumanoidViewMotion", copy.deepcopy(cfg))
    tenv = tparse("HumanoidViewMotion", copy.deepcopy(cfg), device="cpu")
    js = jenv.initial_state(jax.random.PRNGKey(0))
    ts = tenv.initial_state()
    np.testing.assert_array_equal(t2n(ts.aux["motion_ids"]), np.arange(ENVS))
    np.testing.assert_array_equal(np.asarray(js.aux["motion_ids"]), np.arange(ENVS))
    close(js.body_pos, ts.body_pos, 1e-5)

    lengths = np.asarray(jenv._motion_lib.lengths)[:ENVS]
    progress = (np.floor(lengths / (2.0 / 60.0)) - np.arange(ENVS)).astype(np.int32)
    js = js.replace(progress=jnp.asarray(progress))
    ts = ts.replace(progress=torch.as_tensor(progress))
    jstep, jreset = jax.jit(jenv.step), jax.jit(jenv.reset_done)
    act = np.random.default_rng(3).uniform(-1, 1, size=(ENVS, 31)).astype(np.float32)
    gen_state = tenv.gen.get_state()
    resets = 0
    for i in range(5):
        rng_before = js.rng
        js, ts = jreset(js), tenv.reset_done(ts)
        assert js.rng.tolist() == rng_before.tolist()                # no key split
        np.testing.assert_array_equal(t2n(ts.aux["motion_ids"]), np.asarray(js.aux["motion_ids"]))
        js, ts = jstep(js, jnp.asarray(act)), tenv.step(ts, torch.as_tensor(act))
        np.testing.assert_array_equal(t2n(ts.reset_buf), np.asarray(js.reset_buf))
        np.testing.assert_array_equal(t2n(ts.progress), np.asarray(js.progress))
        # the frames evaluated eagerly by the reference: its jitted step
        # sums slerp's dot product in another order, and near slerp's
        # small-angle threshold one ulp of it flips the branch (1.7e-4 m
        # of body position here); the port sums in the eager order
        times = js.progress.astype(jnp.float32) * jenv._motion_dt
        ref = jd2.fk_batched(jenv.model, jenv._ref_state_phys(
            jml.get_motion_state(jenv._motion_lib, js.aux["motion_ids"], times)))
        close(ref.body_pos, ts.body_pos, 1e-5)
        close(js.body_pos, ts.body_pos, 1e-3)
        assert float(ts.phys.u.abs().max()) == 0.0                   # velocities zeroed
        resets += int(t2n(ts.reset_buf).sum())
    assert resets == ENVS                                             # every clip ended once
    np.testing.assert_array_equal(t2n(ts.aux["motion_ids"]), np.arange(ENVS) + ENVS)
    assert torch.equal(tenv.gen.get_state(), gen_state)
    assert tenv._draw_reset(ENVS) == {}


def test_view_motion_runs_through_the_cli():
    """``python -m ase_tpu_torch.run --test --task HumanoidViewMotion
    --device cpu`` (``run.main``) plays 3 control steps over the shipped
    LLC checkpoint: finite stats, the task's forced config."""
    from ase_tpu_torch import run

    argv = ["--test", "--task", "HumanoidViewMotion",
            "--cfg_env", "humanoid_ase_sword_shield.yaml",
            "--cfg_train", "train/rlg/ase_humanoid.yaml", "--motion_file", MOTION,
            "--checkpoint", "data/models/ase_llc_reallusion_sword_shield.ckpt.npz",
            "--num_envs", "2", "--device", "cpu"]
    stats = run.main(argv, num_steps=3, max_chunks=1)
    assert np.isfinite(stats["running_return_mean"])
    player, _ = run.build_player(argv)
    env = player.env
    assert env.sim_cfg.torque_control and not env.sim_cfg.enable_self_collision
    assert env.control_freq_inv == 1 and env.dt == pytest.approx(1 / 60)
