"""Port parity for the training update: one minibatch's losses, every
gradient and one Adam step, and the GAE and dataset preparation of a
recorded batch, against ``ase_tpu``'s ASE agent on the same weights,
inputs and draws (TRAIN_CFG widths, B = 8 HumanoidAMPGetup envs).

Tolerances: losses and info scalars within 1e-4 of their magnitude (at
least 1), gradients within 1e-4 of each tensor's largest magnitude:
float32 products are summed in another order, the neglogp divides the
action error by sigma^2 = exp(-5.8) ~ 3e-3, which scales rounding by ~330,
and the grad penalty is second order; after one Adam step, entries whose gradient is above 1e-4 of its
tensor's largest are held to 1e-2·lr, the rest to 2·lr (Adam's first step
is lr·g/|g|, so a gradient that is only rounding noise may flip sign);
GAE and the dataset within 1e-5 of scale, indices exact.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_parts import (  # noqa: F401  (the autouse fixture)
    JaxAgentDraws, _one_torch_thread, check_buffer, j2t, make_agents, rel_close, state_from_jax,
    t2n)

N = 8   # minibatch rows, = TRAIN_CFG's minibatch and amp minibatch


@pytest.fixture(scope="module")
def agents():
    """The JAX agent and train state with 24 rows stored in the replay
    buffer (so a minibatch's replay rows come from it), and a maker of
    port agents in the same state."""
    jagent, ts, _, tagent, _, _ = make_agents(env_states=False)
    rows = np.random.default_rng(7).normal(size=(24, jagent.amp_obs_dim)).astype(np.float32)
    extra = dict(ts.extra)
    extra["replay_buffer"] = extra["replay_buffer"].store(jnp.asarray(rows))
    ts = ts.replace(extra=extra)

    def port_agent():
        t = type(tagent)(tagent.env, copy.deepcopy(tagent.cfg_train))
        t.init_train_state()
        state_from_jax(ts, t)
        return t

    return jagent, ts, port_agent


def _minibatch(jagent, ts, seed):
    """One minibatch in the JAX dataset layout (raw obs, buffer indices).
    Actions lie near the policy's mean and the old neglogp within ~0.15 of
    the new one, so the surrogate has ratios on both sides of the clip."""
    rng = np.random.default_rng(seed)
    A, L = jagent.action_dim, jagent._latent_dim
    z = rng.normal(size=(N, L)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    f = np.float32
    obs = (rng.normal(size=(N, jagent.obs_dim)) * 2 + 0.5).astype(f)
    jts, _ = jagent._preproc_minibatch(ts, {"obs_n": jnp.asarray(obs), "amp_obs": jnp.zeros(
        (N, jagent.amp_obs_dim)), "amp_obs_demo_idx": jnp.zeros(N, jnp.int32),
        "amp_obs_replay_idx": jnp.zeros(N, jnp.int32)})
    mu, log_sigma = jagent._actor_sigma(ts.params, jts.obs_rms.normalize(jnp.asarray(obs)),
                                        {"ase_latents": jnp.asarray(z)})
    actions = np.asarray(mu) + 0.05 * rng.normal(size=(N, A)).astype(f)
    neglogp = np.asarray(jagent._neglogp(jnp.asarray(actions), mu, log_sigma))
    return {
        "obs_n": obs,
        "actions": actions.astype(f),
        "neglogp": (neglogp + 0.15 * rng.normal(size=N)).astype(f),
        "values": rng.normal(size=(N, 1)).astype(f),
        "returns": rng.normal(size=(N, 1)).astype(f),
        "advantages": rng.normal(size=(N,)).astype(f),
        "mu": rng.normal(size=(N, A)).astype(f) * 0.3,
        "sigma": np.full((N, A), -2.9, f),
        "rand_action_mask": (rng.random(N) < 0.7).astype(f),
        "amp_obs": rng.normal(size=(N, jagent.amp_obs_dim)).astype(f),
        "amp_obs_demo_idx": rng.integers(0, 256, N).astype(np.int32),
        "amp_obs_replay_idx": rng.integers(0, 24, N).astype(np.int32),
        "ase_latents": z,
    }


def _port_minibatch(tagent, mb):
    dataset = {k: j2t(v) for k, v in mb.items()}
    return tagent._gather_minibatch(dataset, torch.arange(N))


def _jax_grads(jagent, ts, mb):
    ts, jmb = jagent._preproc_minibatch(ts, {k: jnp.asarray(v) for k, v in mb.items()})
    (loss, info), grads = jax.value_and_grad(jagent._loss, has_aux=True)(ts.params, ts, jmb)
    return ts, loss, info, grads


def _grad_tree(tagent):
    """The port's gradients in the reference's flax layout."""
    from ase_tpu_torch.learning import checkpoint as tckpt

    g = copy.deepcopy(tagent.network)
    for p, q in zip(g.parameters(), tagent.network.parameters()):
        p.data = q.grad.clone()
    return tckpt.export_ase(g)["params"]


def _leaves(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_leaves_with_path(tree)}


def _diversity_draw(tagent, ts):
    L = tagent._latent_dim
    tagent._draw_diversity_latents = lambda n: j2t(
        jax.random.normal(jax.random.fold_in(ts.rng, 23), (n, L)))


def test_minibatch_losses_and_gradients_match_reference(agents):
    jagent, ts, port_agent = agents
    tagent = port_agent()
    mb = _minibatch(jagent, ts, 1)
    jts, jloss, jinfo, jgrads = _jax_grads(jagent, ts, mb)
    _diversity_draw(tagent, ts)
    tmb = tagent._preproc_minibatch(_port_minibatch(tagent, mb))
    # the normalizer updates: obs over N rows, AMP over [agent | replay | demo]
    for name, j, t in (("obs_rms", jts.obs_rms, tagent.obs_rms),
                       ("amp_rms", jts.extra["amp_rms"], tagent.amp_rms)):
        for f in ("mean", "var", "count"):
            rel_close(getattr(j, f), getattr(t, f), 1e-5, f"{name}.{f}")
    loss, info = tagent._loss(tmb)
    tagent.network.zero_grad()
    loss.backward()

    names = ("a_loss", "c_loss", "b_loss", "entropy", "clip_frac", "disc_loss",
             "disc_grad_penalty", "disc_logit_loss", "disc_agent_acc", "disc_demo_acc",
             "disc_agent_logit", "disc_demo_logit", "enc_loss", "diversity_loss")
    assert set(names) <= set(info) and set(names) <= set(jinfo)
    for k in names + ("loss",):
        ref = float(jloss) if k == "loss" else float(jinfo[k])
        got = float((loss if k == "loss" else info[k]).detach())
        assert abs(ref - got) <= 1e-4 * max(1.0, abs(ref)), (k, ref, got)
    assert float(jinfo["disc_grad_penalty"]) > 0 and float(jinfo["diversity_loss"]) > 0
    assert 0 < float(jinfo["clip_frac"]) < 1
    rel_close(jinfo["mu"], info["mu"], 1e-5, "mu")

    ref, got = _leaves(jax.device_get(jgrads)["params"]), _leaves(_grad_tree(tagent))
    assert set(ref) == set(got) and len(ref) == 27
    for k in ref:
        assert float(np.abs(ref[k]).max()) > 0, k
        rel_close(ref[k], got[k], 1e-4, f"grad {k}")


def test_one_adam_step_matches_reference(agents):
    """The port's whole minibatch step (normalizer updates, loss, backward,
    Adam) against optax.adam on the JAX gradients."""
    jagent, ts, port_agent = agents
    tagent = port_agent()
    tagent.optimizer = tagent._make_optimizer()
    mb = _minibatch(jagent, ts, 2)
    _, _, jinfo, jgrads = _jax_grads(jagent, ts, mb)
    updates, _ = jagent.optimizer.update(jgrads, ts.opt_state, ts.params)
    new = jax.device_get(jax.tree_util.tree_map(lambda p, u: p + u, ts.params, updates))
    _diversity_draw(tagent, ts)
    metrics = tagent._update_minibatch(_port_minibatch(tagent, mb))
    assert float(metrics["kl"]) >= 0 and np.isfinite(float(metrics["loss"]))
    assert abs(float(metrics["a_loss"]) - float(jinfo["a_loss"])) <= 1e-4

    from ase_tpu_torch.learning import checkpoint as tckpt

    lr = jagent.learning_rate
    ref_w, got_w = _leaves(new["params"]), _leaves(tckpt.export_ase(tagent.network)["params"])
    old_w = _leaves(jax.device_get(ts.params)["params"])
    grads = _leaves(jax.device_get(jgrads)["params"])
    moved = 0
    for k in ref_w:
        g = np.abs(grads[k])
        strong = g > 1e-4 * g.max()
        err = np.abs(ref_w[k].astype(np.float64) - got_w[k])
        assert float(err[strong].max(initial=0.0)) <= 1e-2 * lr, (k, float(err[strong].max()))
        assert float(err.max()) <= 2 * lr, k
        moved += int((np.abs(got_w[k] - old_w[k]) > 0.5 * lr).sum())
    assert moved > 1000     # the step moved the weights by about lr


def _recorded_batch(jagent, seed):
    """A rollout batch (T, B, ...) in the reference's record layout, with
    dones, terminations and ε-greedy masks."""
    rng = np.random.default_rng(seed)
    T, B, A, L = jagent.horizon_length, jagent.num_actors, jagent.action_dim, jagent._latent_dim
    f = np.float32
    z = rng.normal(size=(T, B, L)).astype(f)
    return {
        "obs": rng.normal(size=(T, B, jagent.obs_dim)).astype(f),
        "actions": rng.normal(size=(T, B, A)).astype(f),
        "mu": rng.normal(size=(T, B, A)).astype(f),
        "sigma": np.full((T, B, A), -2.9, f),
        "neglogp": rng.normal(size=(T, B)).astype(f),
        "values": (rng.normal(size=(T, B, 1)) * 3).astype(f),
        "rewards": rng.random((T, B, 1)).astype(f),
        "dones": (rng.random((T, B)) < 0.25).astype(f),
        "next_values": (rng.normal(size=(T, B, 1)) * 3).astype(f),
        "rand_action_mask": (rng.random((T, B)) < 0.6).astype(f),
        "amp_obs": rng.normal(size=(T, B, jagent.amp_obs_dim)).astype(f),
        "ase_latents": z / np.linalg.norm(z, axis=-1, keepdims=True),
    }


def test_gae_and_dataset_match_reference(agents):
    """_discount_values, then _prepare_dataset: advantages before value
    normalization, the masked advantage normalization, the two value-RMS
    updates, and the AMP extras (demo refresh, cursor indices)."""
    jagent, ts, port_agent = agents
    tagent = port_agent()
    JaxAgentDraws(ts.rng, jagent).install(tagent)
    batch = _recorded_batch(jagent, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: j2t(v) for k, v in batch.items()}
    jadv = jagent._discount_values(jb["dones"], jb["values"], jb["rewards"], jb["next_values"])
    tadv = tagent._discount_values(tb["dones"], tb["values"], tb["rewards"], tb["next_values"])
    rel_close(jadv, tadv, 1e-5, "gae")
    jb["returns"] = jadv + jb["values"]
    tb["returns"] = tadv + tb["values"]
    jts, jds = jagent._prepare_dataset(ts, jb)
    with torch.no_grad():
        tds = tagent._prepare_dataset(tb)
    assert set(jds) == set(tds)
    for k in jds:
        if k.endswith("_idx"):
            np.testing.assert_array_equal(t2n(tds[k]), np.asarray(jds[k]), err_msg=k)
        else:
            rel_close(jds[k], tds[k], 1e-5, k)
    for f in ("mean", "var", "count"):
        rel_close(getattr(jts.value_rms, f), getattr(tagent.value_rms, f), 1e-5, f"value_rms.{f}")
    # the refresh's demo rows come from the two motion libraries (1e-5)
    check_buffer(jts.extra["demo_buffer"], tagent.demo_buffer, "demo buffer after refresh",
                 atol=1e-5)
    check_buffer(jts.extra["replay_buffer"], tagent.replay_buffer, "replay cursor")
