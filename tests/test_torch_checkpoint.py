"""Port parity for checkpoints: the port writes ``ase_tpu``'s path-keyed npz
and resumes from it, both ways, exactly; a resumed run continues as the
uninterrupted one; players restore across env counts; training writes the
reference's file names and TensorBoard scalar names.

Toy sizes (tests/test_learning.py's TRAIN_CFG as an ASE or AMP config,
HumanoidAMP at 4 envs, horizon 4), on the CPU with one torch thread.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.envs import parse_task as jparse
from ase_tpu.learning import checkpoint as jckpt
from ase_tpu.learning.ase_agent import ASEAgent as JASEAgent
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.learning.amp_agent import AMPAgent as TAMPAgent
from ase_tpu_torch.learning.ase_agent import ASEAgent as TASEAgent
from tests.test_env import make_cfg
from tests.test_learning import TRAIN_CFG
from tests.test_torch_train_parts import _one_torch_thread, ase_train_cfg, t2n  # noqa: F401

RMS = ("mean", "var", "count")


def port_agent(cfg_train=None, cls=TASEAgent, output_dir="output", **env):
    """A port agent on HumanoidAMP (CPU) with its train and env states."""
    agent = cls(tparse("HumanoidAMP", make_cfg(**env), device="cpu"),
                copy.deepcopy(cfg_train or ase_train_cfg()), output_dir=output_dir)
    return agent, agent.setup_training()


def jax_agent(**env):
    return JASEAgent(jparse("HumanoidAMP", make_cfg(**env)), ase_train_cfg())


def keyed(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]}


def port_values(agent):
    """The port agent's train state in the reference's keys and layout."""
    return {k: leaf.get() for k, leaf in agent.ckpt_leaves().items()}


def test_port_checkpoint_restores_into_jax(tmp_path):
    """The port's save after one epoch has every key of the JAX train state
    (less its PRNG key and the excluded buffers) at the JAX shape and
    dtype, and ``ase_tpu``'s non-strict restore reads back exactly the
    port's weights, Adam moments and count, normalizers and counters."""
    agent, env_state = port_agent()
    agent.train_epoch(env_state)
    path = agent.save(str(tmp_path / "port.ckpt"))
    template = jax_agent().init_train_state(jax.random.PRNGKey(3))
    ts = keyed(jckpt.restore(path, template, strict=False))
    saved = dict(np.load(path))
    for k, v in keyed(template).items():
        if k == ".rng" or "_buffer']" in k:
            assert k not in saved, k
            continue
        assert saved[k].shape == v.shape and saved[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ts[k], saved[k], err_msg=k)
    want = port_values(agent)
    for k in saved:
        np.testing.assert_array_equal(saved[k], want[k], err_msg=k)
    # the values above are the port's own tensors, kernels transposed
    net = agent.network
    np.testing.assert_array_equal(
        ts[".params['params']['actor_mlp']['Dense_0']['kernel']"],
        t2n(net.actor_mlp.layers[0].weight).T)
    np.testing.assert_array_equal(
        ts[".opt_state[0].nu['params']['style_net']['Dense_2']['kernel']"],
        t2n(agent.optimizer.state[net.style_net.out.weight]["exp_avg_sq"]).T)
    steps = agent.mini_epochs * agent.num_minibatches
    assert int(ts[".opt_state[0].count"]) == steps == int(agent.optimizer.state[net.mu.bias]["step"])
    for name, rms in (("obs_rms", agent.obs_rms), ("value_rms", agent.value_rms),
                      ("extra['amp_rms']", agent.amp_rms)):
        for f in RMS:
            np.testing.assert_array_equal(ts[f".{name}.{f}"], t2n(getattr(rms, f)))
    assert int(ts[".epoch"]) == 1 and int(ts[".frame"]) == agent.batch_size


def _filled(ts):
    """``ts`` with every leaf replaced by distinct values of its dtype."""
    rng = np.random.default_rng(0)

    def fill(path, x):
        x = np.asarray(x)
        if x.dtype.kind == "f":
            return jnp.asarray(rng.uniform(0.5, 2.0, x.shape).astype(x.dtype))
        if jax.tree_util.keystr(path).endswith(".perm"):
            return jnp.asarray(rng.permutation(x.shape[0]).astype(x.dtype))
        if x.dtype.kind in "iu" and jax.tree_util.keystr(path) != ".rng":
            return jnp.asarray(rng.integers(1, 60, x.shape).astype(x.dtype))
        return jnp.asarray(x)

    return jax.tree_util.tree_map_with_path(fill, ts)


def test_jax_checkpoint_resumes_into_port(tmp_path):
    """``ase_tpu``'s save of a toy train state (every leaf filled with
    distinct values, buffers included) goes through the port's strict
    resume exactly: weights, Adam moments and count, the three
    normalizers, counters, meters, latents, buffers, best reward."""
    ts = _filled(jax_agent().init_train_state(jax.random.PRNGKey(0)))
    path = str(tmp_path / "jax.ckpt")
    jckpt.save(path, ts)
    agent, _ = port_agent()
    agent.resume(path)
    want = keyed(ts)
    got = port_values(agent)
    assert set(got) - set(want) == {tckpt.GENERATOR_KEY}
    for k, v in got.items():
        if k != tckpt.GENERATOR_KEY:
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert agent.epoch == int(want[".epoch"]) and agent.frame == int(want[".frame"])
    assert float(agent.optimizer.state[agent.network.sigma]["step"]) == int(
        want[".opt_state[0].count"])
    np.testing.assert_array_equal(t2n(agent.network.critic_mlp.layers[1].weight),
                                  want[".params['params']['critic_mlp']['Dense_1']['kernel']"].T)


def test_resume_continues_identically(tmp_path):
    """2 epochs, a save_buffers save of the train state and of the env
    state, a restore into a fresh agent and env, then 2 more epochs equal 4
    uninterrupted epochs (tests/test_learning.py::test_resume_continues_identically:
    metrics to rtol 1e-4, weights to 1e-5)."""
    cfg = ase_train_cfg()
    cfg["params"]["config"]["save_buffers"] = True
    agent_a, env_a = port_agent(cfg)
    for _ in range(4):
        env_a, rec_a = agent_a.train_epoch(env_a)

    agent_b, env_b = port_agent(cfg)
    for _ in range(2):
        env_b, _ = agent_b.train_epoch(env_b)
    ts_path = agent_b.save(str(tmp_path / "ts.ckpt"))
    env_path = tckpt.save_env_state(str(tmp_path / "env.ckpt"), agent_b.env, env_b)

    agent_c, env_c = port_agent(cfg)
    agent_c.resume(ts_path)
    env_c = tckpt.restore_env_state(env_path, agent_c.env, env_c)
    assert agent_c.epoch == 2
    for _ in range(2):
        env_c, rec_c = agent_c.train_epoch(env_c)

    assert agent_c.epoch == agent_a.epoch == 4
    for k, v in rec_a["metrics"].items():
        np.testing.assert_allclose(rec_c["metrics"][k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    for (name, p), q in zip(agent_a.network.named_parameters(), agent_c.network.parameters()):
        np.testing.assert_allclose(t2n(q), t2n(p), rtol=1e-5, atol=1e-6, err_msg=name)


def test_player_restore_across_env_counts(tmp_path):
    """A checkpoint of a 4-env agent restores into an 8-env one
    (tests/test_learning.py::test_player_restore_across_env_counts): the
    player's restore takes the weights and normalizers; a non-strict
    restore of the whole train state keeps the per-env template values;
    the strict resume refuses the mismatch."""
    agent, env_state = port_agent(numEnvs=4)
    agent.train_epoch(env_state)
    path = agent.save(str(tmp_path / "trained.ckpt"))

    cfg = ase_train_cfg()
    cfg["params"]["config"]["minibatch_size"] = 16
    agent2, _ = port_agent(cfg, numEnvs=8)
    agent2.restore(path)
    for (name, p), q in zip(agent.network.named_parameters(), agent2.network.parameters()):
        np.testing.assert_array_equal(t2n(q), t2n(p), err_msg=name)
    for f in RMS:
        np.testing.assert_array_equal(t2n(getattr(agent2.amp_rms, f)), t2n(getattr(agent.amp_rms, f)))
    tckpt.restore(path, agent2.ckpt_leaves(), strict=False)
    assert agent2.epoch == 1
    assert tuple(agent2.meters["cur_rewards"].shape) == (8,)
    assert tuple(agent2.roll_state["ase_latents"].shape) == (8, 8)
    with pytest.raises(ValueError, match="shape"):
        agent2.resume(path)


class StubWriter:
    def __init__(self):
        self.scalars = []

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, float(value), int(step)))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two AMP epochs through ``train`` with a checkpoint every epoch,
    intermediate saves, the best-reward save from epoch 0 and 3-step
    episodes (so games finish), with a stub writer."""
    out = tmp_path_factory.mktemp("out")
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["params"]["config"].update(save_frequency=1, save_intermediate=True, save_best_after=0,
                                   max_epochs=2)
    agent = TAMPAgent(tparse("HumanoidAMP", make_cfg(episodeLength=3), device="cpu"), cfg,
                      output_dir=str(out))
    writer = StubWriter()
    records = []
    agent.train(writer=writer, on_epoch=records.append)
    return agent, out, writer, records


def test_training_writes_the_reference_checkpoint_names(trained):
    """``{name}.ckpt.npz`` (every save_frequency epochs and at the end),
    ``{name}_{epoch:08d}.ckpt.npz`` with the buffers (save_intermediate)
    and ``{name}_best.ckpt.npz`` (games played, after save_best_after)."""
    agent, out, _, records = trained
    names = sorted(p.name for p in out.iterdir())
    assert names == ["test.ckpt.npz", "test_00000001.ckpt.npz", "test_00000002.ckpt.npz",
                     "test_best.ckpt.npz"], names
    assert records[-1]["metrics"]["games_played"] > 0
    final = np.load(out / "test.ckpt.npz")
    assert int(final[".epoch"]) == 2
    assert not any("buffer" in k for k in final.files)
    assert ".extra['demo_buffer'].data" in np.load(out / "test_00000002.ckpt.npz").files
    best = np.load(out / "test_best.ckpt.npz")
    assert float(best[".extra['best_mean_rewards']"]) == np.float32(agent._best_mean_rewards)


def test_training_writes_the_reference_scalar_names(trained):
    """``train/<metric>`` for every epoch metric and
    ``performance/total_fps``, at the frame count after the epoch."""
    agent, _, writer, records = trained
    for i, rec in enumerate(records):
        frame = (i + 1) * agent.batch_size
        got = {tag for tag, _, step in writer.scalars if step == frame}
        assert got == {f"train/{k}" for k in rec["metrics"]} | {"performance/total_fps"}
        for tag, value, step in writer.scalars:
            if step == frame and tag.startswith("train/"):
                assert value == rec["metrics"][tag[len("train/"):]]
    assert len(writer.scalars) == sum(len(r["metrics"]) + 1 for r in records)
