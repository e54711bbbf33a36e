"""Port parity for one whole ASE training epoch, and the training entry
point.

``test_train_epoch_matches_reference`` runs one ``train_epoch`` of the
port's ASEAgent and the JAX agent's epoch (its rollout and update phases)
from the same weights, train state, env state and draws: B = 8
HumanoidAMPGetup envs with TRAIN_CFG (horizon 4, minibatch 8, 2
mini-epochs), the contact solve in float32 on both sides. It compares the
rollout batch, the returns, the epoch's metrics and the new weights.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.learning.amp_agent import AMPAgent as JAMPAgent  # noqa: F401
from ase_tpu_torch import run
from ase_tpu_torch.learning import checkpoint as tckpt
from tests.test_torch_train_parts import (  # noqa: F401  (the autouse fixture)
    _one_torch_thread, check_buffer, close, env_state_from_jax, make_agents, rel_close, t2n)


def _jax_epoch(jagent, ts, js):
    """The JAX epoch as ``_train_epoch_impl`` runs it, with the rollout
    batch kept."""
    ts, js, roll, batch = jax.jit(jagent._rollout)(ts, js)
    ts = jagent._post_rollout(ts, roll)
    ts, batch = jagent._process_rewards(ts, batch)
    batch["returns"] = jagent._discount_values(
        batch["dones"], batch["values"], batch["rewards"], batch["next_values"]) + batch["values"]
    ts, dataset = jagent._prepare_dataset(ts, batch)
    ts, metrics = jax.jit(jagent._update_phase_impl)(ts, dataset)
    metrics["reward_mean"] = batch["rewards"].mean()
    for k in ("disc_rewards", "enc_rewards"):
        if k in batch:
            metrics[k[:-1] + "_mean"] = batch[k].mean()
    return ts, js, batch, jax.device_get(metrics)


def test_train_epoch_matches_reference():
    """Tolerances: the observations as the env test holds stepped
    observations (1e-2 of their largest magnitude); the network outputs,
    rewards and returns within 1e-3 of scale; masks and dones exact,
    latents 1e-6; metrics within 1e-3 of their magnitude (at least 1).
    New weights: all but 0.5% of each tensor within 1e-2·lr of the
    reference and every entry within 4·lr. The exceptions are entries
    whose gradient is rounding noise (e.g. discriminator inputs that are
    constant over the batch): Adam normalizes each step to about lr with
    the noise's sign, and this epoch takes 8 steps.

    The epoch starts after 8 settling control steps of the initial state
    (carried across from JAX): a reset into a penetrating motion frame
    makes a stiff first step (joint rates at the 64 rad/s clamp) in which
    the contact dynamics amplify float32 rounding ~20x per control step --
    perturbing the port's own velocities by 1e-6 of themselves moves such an
    env's observations by 0.3 after two steps -- so a rollout from there
    compares rounding, not the port. Resets inside the epoch still happen:
    envs 0 and 5 end their episodes at the first step."""
    jagent, ts, js, tagent, tstate, _ = make_agents(settle=8)
    # envs 0 and 5 end their episodes at the first step and reset at the next
    js = js.replace(progress=js.progress.at[jnp.array([0, 5])].set(298))
    tstate = env_state_from_jax(js, tstate)
    jts, jjs, jbatch, jmetrics = _jax_epoch(jagent, ts, js)

    seen = {}
    process = tagent._process_rewards

    def keep_batch(batch):
        seen["batch"] = process(batch)
        return seen["batch"]

    tagent._process_rewards = keep_batch
    tstate, record = tagent.train_epoch(tstate)
    tbatch = seen["batch"]

    for k in ("dones", "rand_action_mask"):
        np.testing.assert_array_equal(t2n(tbatch[k]), np.asarray(jbatch[k]), err_msg=k)
    assert float(tbatch["dones"][0].sum()) == 2      # envs 0 and 5
    close(jbatch["ase_latents"], tbatch["ase_latents"], 1e-6, "ase_latents")
    for k in ("obs", "amp_obs"):
        rel_close(jbatch[k], tbatch[k], 1e-2, k)
    for k in ("actions", "mu", "neglogp", "values", "rewards", "next_values", "returns",
              "disc_rewards", "enc_rewards"):
        rel_close(jbatch[k], tbatch[k], 1e-3, k)
    close(jjs.obs, tstate.obs, 1e-2 * float(np.abs(np.asarray(jjs.obs)).max()), "final obs")
    close(jts.extra["ase_latents"], tagent.roll_state["ase_latents"], 1e-6, "kept latents")

    got = record["metrics"]
    assert set(got) == set(jmetrics), set(got) ^ set(jmetrics)
    for k, v in jmetrics.items():
        assert abs(got[k] - float(v)) <= 1e-3 * max(1.0, abs(float(v))), (k, float(v), got[k])
    assert got["games_played"] == 2.0
    assert record["wall_s"] >= record["rollout_s"] > 0 and record["env_steps_per_s"] > 0

    lr = jagent.learning_rate
    new_ref = jax.device_get(jts.params)["params"]
    new_got = tckpt.export_ase(tagent.network)["params"]
    old = jax.device_get(ts.params)["params"]
    moved = 0
    for (path, ref), g, o in zip(jax.tree_util.tree_leaves_with_path(new_ref),
                                 jax.tree_util.tree_leaves(new_got),
                                 jax.tree_util.tree_leaves(old)):
        err = np.abs(np.asarray(ref, np.float64) - g)
        what = jax.tree_util.keystr(path)
        assert float(err.max()) <= 4 * lr, (what, float(err.max()) / lr)
        assert float((err > 1e-2 * lr).mean()) <= 5e-3, (what, float((err > 1e-2 * lr).mean()))
        moved += int((np.abs(g - o) > lr).sum())
    assert moved > 10000    # the update moved the weights
    for f in ("mean", "var", "count"):
        rel_close(getattr(jts.obs_rms, f), getattr(tagent.obs_rms, f), 1e-4, f"obs_rms.{f}")
        rel_close(getattr(jts.value_rms, f), getattr(tagent.value_rms, f), 1e-3,
                  f"value_rms.{f}")
        rel_close(getattr(jts.extra["amp_rms"], f), getattr(tagent.amp_rms, f), 1e-4,
                  f"amp_rms.{f}")
    check_buffer(jts.extra["replay_buffer"], tagent.replay_buffer, "replay", atol=1e-2 * 64)
