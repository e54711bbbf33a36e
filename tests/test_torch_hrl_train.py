"""Port parity for HRL training: one epoch of a high-level controller (HLC)
over a frozen low-level controller (LLC) on the strike task, the HLC's
checkpoint both ways, and ``run.main`` training and resuming it.

The LLC is a tiny ASE agent of tests/test_learning.py's TRAIN_CFG (widths
32-16, latent 8) saved by ``ase_tpu``, as tests/test_hrl.py builds one;
the HLC trains with horizon 2, ``llc_steps`` 2 and minibatch 4 on B = 4
HumanoidStrike envs (one free prop each), float32 contact solve on both
sides. A file of its own, so that ``--dist loadfile`` puts its JAX
compiles on another worker.
"""

import copy

import jax
import numpy as np
import pytest
import torch
import yaml

from ase_tpu.envs import parse_task as jparse
from ase_tpu.learning import checkpoint as jckpt
from ase_tpu.learning.ase_agent import ASEAgent as JASEAgent
from ase_tpu.learning.hrl_agent import HRLAgent as JHRLAgent
from ase_tpu_torch import run
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.learning.hrl_agent import HRLAgent as THRLAgent
from tests.test_env import make_cfg
from tests.test_learning import TRAIN_CFG
from tests.test_torch_env import f32_solver
from tests.test_torch_tasks import CLIP, PropDraws, prop_cfg, to_jax
from tests.test_torch_train_epoch import _jax_epoch
from tests.test_torch_train_parts import (  # noqa: F401  (the autouse fixture)
    JaxAgentDraws, _one_torch_thread, ase_train_cfg, rel_close, t2n)

B = 4
SETTLE = 6


@pytest.fixture(scope="module")
def llc(tmp_path_factory):
    """(checkpoint path, config path) of a tiny ASE LLC saved by ase_tpu."""
    d = tmp_path_factory.mktemp("llc")
    cfg = ase_train_cfg()
    ts = JASEAgent(jparse("HumanoidAMP", make_cfg()), copy.deepcopy(cfg)).init_train_state(
        jax.random.PRNGKey(0))
    path = str(d / "llc.ckpt")
    jckpt.save(path, ts)
    cfg_path = d / "llc.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    return path + ".npz", str(cfg_path)


def hrl_cfg(llc):
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["params"]["algo"]["name"] = "hrl"
    cfg["params"]["network"]["name"] = "hrl"
    cfg["params"]["config"].update(
        llc_checkpoint=llc[0], llc_config=llc[1], llc_steps=2, task_reward_w=0.9,
        disc_reward_w=0.1, horizon_length=2, minibatch_size=4)
    return cfg


def keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def port_values(agent):
    return {k: leaf.get() for k, leaf in agent.ckpt_leaves().items()}


def llc_weights(agent):
    return [p.detach().clone() for p in agent._llc_network.parameters()] + [
        getattr(rms, f).clone() for rms in (agent._llc_obs_rms, agent._llc_amp_rms)
        for f in ("mean", "var", "count")]


def _agents(llc, tmp_path):
    """JAX and port HRL agents on strike with the same LLC, HLC train state
    (the JAX one through the port's strict resume) and settled env state;
    the port replays the JAX env's and agent's draws, the minibatch
    permutations included (the JAX update advances its key once per
    minibatch). The HLC's observation normalizer has seen the settling
    steps' observations: from a fresh one (count 1e-4) the first
    minibatch's normalizer update moves the policy so far (KL ~19 at sigma
    e^-2.9) that every ratio is clipped, the actor's gradients are rounding
    noise, and Adam turns that noise into lr-sized steps of its sign."""
    cfg = prop_cfg("HumanoidStrike", numEnvs=B, resetChunk=0)
    jenv = jparse("HumanoidStrike", copy.deepcopy(cfg))
    tenv = tparse("HumanoidStrike", copy.deepcopy(cfg), device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    jagent = JHRLAgent(jenv, hrl_cfg(llc))
    tagent = THRLAgent(tenv, hrl_cfg(llc))
    assert tagent.action_dim == jagent.action_dim == 8

    env_draws = PropDraws(jenv)
    tenv._draw_reset = env_draws.reset
    key = jax.random.PRNGKey(2)
    like = jenv.initial_state(key)
    env_draws.key = key
    tstate = tenv.initial_state()
    # settle on the port under one latent, then carry the state to JAX
    z = torch.zeros(B, 8)
    z[:, 0] = 1.0
    seen = []
    with torch.no_grad():
        for _ in range(SETTLE):
            tstate = tenv.step(tenv.reset_done(tstate), tagent._compute_llc_action(tstate.obs, z))
            seen.append(t2n(tstate.obs))
    # envs 0 and 2 end their episodes in the first window and reset in the second
    progress = tstate.progress.clone()
    progress[[0, 2]] = tenv.max_episode_length - 2
    tstate = tstate.replace(progress=progress, reset_buf=torch.zeros_like(progress))
    js = to_jax(tstate, like, env_draws.key)

    ts = jagent.init_train_state(jax.random.PRNGKey(1))
    ts = ts.replace(obs_rms=ts.obs_rms.update(jax.numpy.asarray(np.concatenate(seen))))
    path = str(tmp_path / "jax_hlc.ckpt")
    jckpt.save(path, ts)
    tagent.init_train_state()
    tagent.resume(path)
    draws = JaxAgentDraws(ts.rng, jagent)
    draws.install(tagent)
    update = tagent._update_minibatch

    def advance_then_update(mb):
        draws._split(1)     # the JAX update advances its key once per minibatch
        return update(mb)

    tagent._update_minibatch = advance_then_update
    return jagent, ts, js, tagent, tstate


def test_hrl_epoch_matches_reference(llc, tmp_path):
    """One HRL epoch (2 decisions of 2 control steps, 4 Adam steps) against
    ase_tpu's on the same weights, states and draws. The batch: dones and
    masks exactly, observations and the network outputs, windowed task and
    discriminator rewards (combined 0.9 / 0.1) and returns within 1e-4 of
    scale; the losses within 1e-5 of max(1, |loss|), the other metrics
    1e-3; the new HLC weights (sigma among them) as
    tests/test_torch_train_epoch.py holds them: all within 4·lr, all but
    0.5% of each tensor within 1e-2·lr. The LLC stays bit-equal: it gets
    no gradient and is not in the optimizer."""
    jagent, ts, js, tagent, tstate = _agents(llc, tmp_path)
    frozen = llc_weights(tagent)
    jts, jjs, jbatch, jmetrics = _jax_epoch(jagent, ts, js)

    seen = {}
    process = tagent._process_rewards

    def keep_batch(batch):
        raw = batch["rewards"].clone()
        seen["batch"] = process(batch)
        seen["raw"] = raw
        return seen["batch"]

    tagent._process_rewards = keep_batch
    tstate, record = tagent.train_epoch(tstate)
    tbatch = seen["batch"]

    for k in ("dones", "rand_action_mask"):
        np.testing.assert_array_equal(t2n(tbatch[k]), np.asarray(jbatch[k]), err_msg=k)
    assert float(tbatch["dones"][0].sum()) == 2          # envs 0 and 2
    for k in ("obs", "actions", "mu", "neglogp", "values", "rewards", "next_values", "returns",
              "disc_rewards"):
        rel_close(jbatch[k], tbatch[k], 1e-4, k)
    torch.testing.assert_close(tbatch["rewards"],
                               0.9 * seen["raw"] + 0.1 * tbatch["disc_rewards"], rtol=0, atol=0)
    rel_close(jjs.obs, tstate.obs, 1e-4, "final obs")
    rel_close(jjs.phys.prop_pos, tstate.phys.prop_pos, 1e-4, "final target poses")

    got = record["metrics"]
    assert set(got) == set(jmetrics), set(got) ^ set(jmetrics)
    for k, v in jmetrics.items():
        tol = (1e-5 if k.endswith("loss") else 1e-3) * max(1.0, abs(float(v)))
        assert abs(got[k] - float(v)) <= tol, (k, float(v), got[k])
    assert got["games_played"] == 2.0

    lr = jagent.learning_rate
    want, have = keyed(jts), port_values(tagent)
    old = keyed(ts)
    for k in want:
        if not k.startswith(".params"):
            continue
        err = np.abs(want[k].astype(np.float64) - have[k])
        assert float(err.max()) <= 4 * lr, (k, float(err.max()) / lr)
        assert float((err > 1e-2 * lr).mean()) <= 5e-3, (k, float((err > 1e-2 * lr).mean()))
        assert float(np.abs(have[k] - old[k]).max()) > 0, f"{k} did not move"
    for k in ("obs_rms", "value_rms"):
        for f in ("mean", "var", "count"):
            rel_close(want[f".{k}.{f}"], have[f".{k}.{f}"], 1e-4, f"{k}.{f}")
    assert int(have[".opt_state[0].count"]) == int(want[".opt_state[0].count"]) == 4
    assert int(have[".epoch"]) == 1

    for a, b in zip(frozen, llc_weights(tagent)):
        assert torch.equal(a, b)
    assert all(not p.requires_grad and p.grad is None for p in tagent._llc_network.parameters())
    held = {id(p) for g in tagent.optimizer.param_groups for p in g["params"]}
    assert held == {id(p) for p in tagent.network.parameters()}
    assert not held & {id(p) for p in tagent._llc_network.parameters()}


def test_hrl_checkpoint_both_ways(llc, tmp_path):
    """The port's HLC checkpoint after an epoch restores strictly into
    ase_tpu's HRL train state (every key but the JAX PRNG key, which the
    port does not keep) with the port's values exactly; ase_tpu's save
    resumes strictly into the port exactly (done in ``_agents``, checked
    here); neither file holds the LLC."""
    jagent, ts, _, tagent, tstate = _agents(llc, tmp_path)
    want, got = keyed(ts), port_values(tagent)
    assert set(got) - set(want) == {tckpt.GENERATOR_KEY} and set(want) - set(got) == {".rng"}
    for k, v in got.items():
        if k != tckpt.GENERATOR_KEY:
            np.testing.assert_array_equal(v, want[k], err_msg=k)

    tagent.train_epoch(tstate)
    path = tagent.save(str(tmp_path / "port_hlc.ckpt"))
    restored = keyed(jckpt.restore(path, jagent.init_train_state(jax.random.PRNGKey(9)),
                                   strict=True, allow_missing=(".rng",)))
    saved = dict(np.load(path))
    for k, v in port_values(tagent).items():
        np.testing.assert_array_equal(saved[k], v, err_msg=k)
        if k != tckpt.GENERATOR_KEY:
            np.testing.assert_array_equal(restored[k], v, err_msg=k)
    assert int(restored[".epoch"]) == 1
    llc_keys = set(dict(np.load(llc[0])))
    assert not any("style_net" in k or "disc" in k for k in saved), "the LLC leaked in"
    assert ".params['params']['style_net']['Dense_0']['kernel']" in llc_keys


def _cli_argv(llc, tmp_path):
    path = tmp_path / "hrl.yaml"
    path.write_text(yaml.safe_dump(hrl_cfg(llc)))
    return ["--task", "HumanoidStrike", "--cfg_env", "humanoid_sword_shield_strike.yaml",
            "--cfg_train", str(path), "--motion_file", "data/motions/" + CLIP,
            "--llc_checkpoint", llc[0], "--num_envs", str(B), "--max_iterations", "1",
            "--seed", "3", "--output_path", str(tmp_path / "out"), "--device", "cpu", "--bench"]


def test_cli_trains_and_resumes_an_hrl_agent(llc, tmp_path, capsys):
    """``run.main`` trains the HLC for one epoch on the CPU and writes its
    checkpoint; ``--resume 1`` takes it back (the LLC reloaded from
    ``--llc_checkpoint``) and trains epoch 1 only; the LLC is the same
    after both."""
    env_state, record = run.main(_cli_argv(llc, tmp_path))
    assert record["epoch"] == 0 and np.isfinite(record["metrics"]["a_loss"])
    assert np.isfinite(record["metrics"]["disc_reward_mean"])
    assert env_state.phys.prop_pos.shape == (B, 1, 3)
    path = str(tmp_path / "out" / "test.ckpt.npz")
    assert int(np.load(path)[".epoch"]) == 1
    argv = _cli_argv(llc, tmp_path) + ["--resume", "1", "--checkpoint", path,
                                        "--max_iterations", "2"]
    agent, _, _ = run.build_agent(argv)
    assert isinstance(agent, THRLAgent)
    capsys.readouterr()
    _, record = run.main(argv)
    out = capsys.readouterr().out
    assert f"resumed from {path} at epoch 1" in out and "Loaded LLC checkpoint" in out
    assert "epoch 1 fps:" in out and "epoch 0 fps:" not in out
    assert record["epoch"] == 1 and int(np.load(path)[".epoch"]) == 2
    ref = np.load(llc[0])[".params['params']['style_net']['Dense_0']['kernel']"]
    np.testing.assert_array_equal(t2n(agent._llc_network.style_net.mlp.layers[0].weight).T, ref)
