"""Port parity for ASE's separate encoder (``network.enc.separate: true``):
the network's forward with the weights carried across from flax, the
encoder loss and its weight-decay gradients in one minibatch, and npz
checkpoints written by each package and read by the other.

Toy sizes: tests/test_learning.py's TRAIN_CFG as an ASE config (widths
32-16, latent 8) with an encoder MLP of its own, 24-12, so that no shape
of it matches the discriminator trunk's. Forward outputs are held to 1e-5
of their scale; the loss and gradients to tests/test_torch_train_loss.py's
tolerances (1e-4 of max(1, |loss|); 1e-4 of each gradient's largest
magnitude).
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
from ase_tpu.models import networks as jnets
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.models import networks as tnets
from tests.test_env import make_cfg
from tests.test_torch_checkpoint import _filled, keyed, port_agent, port_values
from tests.test_torch_train_loss import (
    _diversity_draw, _grad_tree, _jax_grads, _leaves, _minibatch, _port_minibatch)
from tests.test_torch_train_parts import (  # noqa: F401  (the autouse fixture)
    _one_torch_thread, ase_train_cfg, make_agents, rel_close, state_from_jax, t2n)

ENC_UNITS = [24, 12]


def separate_cfg(weight_decay=0.0):
    cfg = ase_train_cfg()
    cfg["params"]["network"]["enc"].update({"separate": True, "units": ENC_UNITS})
    cfg["params"]["config"]["enc_weight_decay"] = weight_decay
    return cfg


def test_separate_encoder_forward_matches_reference():
    """A flax init carried into the port (``load_ase``): the encoder runs
    on its own MLP (``enc_mlp/Dense_i`` of 24 and 12 units, the head on
    12), and every head agrees with flax's on random inputs."""
    cfg = separate_cfg()
    jnet = jnets.build_network("ase", cfg["params"], 253, 31, amp_obs_dim=1400, latent_dim=8)
    params = jnet.init(jax.random.PRNGKey(5), jnp.zeros((1, 253)), jnp.zeros((1, 8)),
                       jnp.zeros((1, 1400)))
    assert set(params["params"]["enc_mlp"]) == {"Dense_0", "Dense_1"}
    tnet = tnets.build_ase_network(cfg["params"], 253, 31, 1400, 8)
    assert [layer.out_features for layer in tnet.enc_mlp.layers] == ENC_UNITS
    assert tnet.enc_head.in_features == 12
    tckpt.load_ase({"params": jax.device_get(params)["params"]}, tnet)
    rng = np.random.default_rng(6)
    obs = rng.normal(size=(16, 253)).astype(np.float32)
    z = rng.normal(size=(16, 8)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    amp = rng.normal(size=(16, 1400)).astype(np.float32)
    ref = jnet.apply(params, jnp.asarray(obs), jnp.asarray(z), jnp.asarray(amp))
    with torch.no_grad():
        t = [torch.as_tensor(x) for x in (obs, z, amp)]
        mu, sigma = tnet.eval_actor(t[0], t[1])
        got = (mu, sigma, tnet.eval_critic(t[0], t[1]), tnet.eval_disc(t[2]), tnet.eval_enc(t[2]))
    for name, r, g in zip(("mu", "sigma", "value", "disc", "enc"), ref, got):
        rel_close(r, g, 1e-5, name)
    # the encoder does not read the discriminator trunk
    with torch.no_grad():
        before = tnet.eval_enc(t[2])
        tnet.disc_mlp.layers[0].weight.mul_(2.0)
        assert torch.equal(tnet.eval_enc(t[2]), before)


@pytest.fixture(scope="module")
def agents():
    jagent, ts, _, tagent, _, _ = make_agents(separate_cfg(weight_decay=0.01), env_states=False)
    state_from_jax(ts, tagent)
    return jagent, ts, tagent


def test_enc_loss_and_weight_decay_gradients_match_reference(agents):
    """One minibatch's loss with the encoder's weight decay (0.01) on its
    own kernels: the encoder loss and the total to 1e-4 of max(1, |loss|),
    every gradient (the encoder MLP's included) to 1e-4 of its largest
    magnitude. The decay's share of an encoder kernel's gradient, 2 x 5 x
    0.01 x W, is far above that tolerance, so a decay on the wrong trunk
    fails."""
    jagent, ts, tagent = agents
    assert tagent._enc_kernels()[0] is tagent.network.enc_mlp.layers[0].weight
    mb = _minibatch(jagent, ts, 1)
    _, jloss, jinfo, jgrads = _jax_grads(jagent, ts, mb)
    _diversity_draw(tagent, ts)
    tmb = tagent._preproc_minibatch(_port_minibatch(tagent, mb))
    loss, info = tagent._loss(tmb)
    tagent.network.zero_grad()
    loss.backward()
    for k, ref, got in (("enc_loss", float(jinfo["enc_loss"]), float(info["enc_loss"])),
                        ("loss", float(jloss), float(loss.detach()))):
        assert abs(ref - got) <= 1e-4 * max(1.0, abs(ref)), (k, ref, got)
    ref, got = _leaves(jax.device_get(jgrads)["params"]), _leaves(_grad_tree(tagent))
    enc = [k for k in ref if "enc_mlp" in k]
    assert set(ref) == set(got) and len(enc) == 4
    for k in ref:
        rel_close(ref[k], got[k], 1e-4, f"grad {k}")


def _jax_agent(cfg):
    return JASEAgent(jparse("HumanoidAMP", make_cfg()), copy.deepcopy(cfg))


def test_port_checkpoint_with_separate_encoder_restores_into_jax(tmp_path):
    """The port's npz has the four ``enc_mlp`` leaves of the JAX train
    state (weights and both Adam moments) at its shapes, and ``ase_tpu``'s
    restore reads back the port's values."""
    cfg = separate_cfg()
    agent, _ = port_agent(cfg)
    path = agent.save(str(tmp_path / "port.ckpt"))
    template = _jax_agent(cfg).init_train_state(jax.random.PRNGKey(3))
    ts = keyed(jckpt.restore(path, template, strict=False))
    saved = dict(np.load(path))
    enc = [k for k in keyed(template) if "enc_mlp" in k]
    assert len(enc) == 12                                 # params, mu, nu x 4 leaves
    for k in enc:
        assert saved[k].shape == ts[k].shape, k
        np.testing.assert_array_equal(ts[k], saved[k], err_msg=k)
    np.testing.assert_array_equal(
        ts[".params['params']['enc_mlp']['Dense_1']['kernel']"],
        t2n(agent.network.enc_mlp.layers[1].weight).T)


def test_jax_checkpoint_with_separate_encoder_resumes_into_port(tmp_path):
    """``ase_tpu``'s save of a train state with the separate encoder (every
    leaf filled with distinct values) goes through the port's strict
    resume exactly, the encoder MLP's weights and Adam moments included."""
    cfg = separate_cfg()
    ts = _filled(_jax_agent(cfg).init_train_state(jax.random.PRNGKey(0)))
    path = str(tmp_path / "jax.ckpt")
    jckpt.save(path, ts)
    agent, _ = port_agent(cfg)
    agent.resume(path)
    want, got = keyed(ts), port_values(agent)
    assert set(got) - set(want) == {tckpt.GENERATOR_KEY}
    assert sum("enc_mlp" in k for k in got) == 12
    for k, v in got.items():
        if k != tckpt.GENERATOR_KEY:
            np.testing.assert_array_equal(v, want[k], err_msg=k)
    np.testing.assert_array_equal(t2n(agent.network.enc_mlp.layers[0].weight),
                                  want[".params['params']['enc_mlp']['Dense_0']['kernel']"].T)
