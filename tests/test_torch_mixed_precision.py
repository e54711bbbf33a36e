"""Port parity for mixed precision (``config.mixed_precision``: bfloat16
matmuls, float32 master weights and heads) against ``ase_tpu`` with bf16
on both sides, on the CPU.

Rounding argument behind the bounds. bfloat16 keeps 8 significant bits:
one rounding is within half an ulp, 2^-9 of the value, and two values one
ulp apart differ by 2^-8 to 2^-7 of their magnitude. Both packages round
at the same places (each dense layer's product, accumulated in float32,
then its bias add; relu and tanh; the heads cast back to float32), but
XLA:CPU and torch sum the float32 products in different orders, so an
output within a float32 rounding of a bf16 rounding boundary can land on
the neighbouring bf16 value. So:

* forwards (``FWD_RTOL``): a head output may differ by a bf16 ulp or two,
  2^-6 of the head's largest magnitude;
* losses (``LOSS_RTOL``): float32 means over the rows of head outputs of
  which a few may move by an ulp, 2^-8 of max(1, |loss|);
* weight gradients (``GRAD_RTOL``): the gradient GEMM's own rounding, and
  XLA:CPU evaluates tanh's derivative 1 - y^2 and its product with the
  cotangent in bfloat16, three roundings where torch rounds once: four
  bf16 ulps, 2^-5 of the tensor's largest magnitude;
* bias gradients add XLA:CPU's summation of the bias cotangent over the
  n rows of a call in bfloat16 (the transpose of the bias broadcast is a
  bfloat16 reduce), where torch accumulates in float32 and rounds once:
  recursive summation in bf16 is within (n - 1) 2^-9 of the sum of
  |cotangent|, which ``_CotangentL1`` measures per layer on the port.

The float64 witness of ``chip_smoke.check_minibatch`` holds float32 only;
the card-vs-CPU bf16 check is ``chip_smoke.check_minibatch_bf16``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.models import networks as jnets
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.models import networks as tnets
from tests.test_torch_train_loss import (_diversity_draw, _grad_tree, _jax_grads, _leaves,
                                         _minibatch, _port_minibatch)
from tests.test_torch_train_parts import (  # noqa: F401  (the autouse fixture)
    _one_torch_thread, ase_train_cfg, j2t, make_agents, state_from_jax, t2n)

FWD_RTOL = 2.0 ** -6
LOSS_RTOL = 2.0 ** -8
GRAD_RTOL = 2.0 ** -5
BF16_HALF_ULP = 2.0 ** -9


def bf16_cfg(algo="ase"):
    cfg = ase_train_cfg()
    cfg["params"]["algo"]["name"] = algo
    cfg["params"]["network"]["name"] = algo
    cfg["params"]["config"]["mixed_precision"] = True
    return cfg


def rel_err(ref, got):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(ref - t2n(got).astype(np.float64)).max()) / max(
        float(np.abs(ref).max()), 1e-30)


@pytest.mark.parametrize("algo", ["amp", "ase", "hrl"])
def test_bf16_network_forwards_match_reference(algo):
    """The AMP, ASE and HRL networks under mixed precision, from the JAX
    init carried over by ``load_ase``: every head within FWD_RTOL of the
    reference's, float32 out; the activations inside are bfloat16 and the
    parameters float32."""
    params = bf16_cfg(algo)["params"]
    obs_dim, act_dim, amp_dim, lat = 253, 31, 1400, 8
    if algo == "hrl":
        obs_dim, act_dim = 258, 64
    jnet = jnets.build_network(algo, params, obs_dim, act_dim, amp_obs_dim=amp_dim,
                               latent_dim=lat)
    tnet = tnets.build_network(algo, params, obs_dim, act_dim, amp_obs_dim=amp_dim,
                               latent_dim=lat)
    rng = np.random.default_rng(3)
    n = 64
    obs = (rng.normal(size=(n, obs_dim)) * 2).astype(np.float32)
    amp = rng.normal(size=(n, amp_dim)).astype(np.float32)
    z = rng.normal(size=(n, lat)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    args = {"amp": (obs, amp), "ase": (obs, z, amp), "hrl": (obs,)}[algo]
    jp = jnet.init(jax.random.PRNGKey(1), *[jnp.asarray(a) for a in args])
    tckpt.load_ase({"params": jax.device_get(jp)["params"]}, tnet)
    assert all(p.dtype == torch.float32 for p in tnet.parameters())
    acts = []
    tnet.actor_mlp.register_forward_hook(lambda m, i, o: acts.append(o.dtype))

    def j(method, *a):
        return np.asarray(jnet.apply(jp, *[jnp.asarray(x) for x in a], method=method))

    pol = (obs, z) if algo == "ase" else (obs,)
    jmu = jnet.apply(jp, *[jnp.asarray(x) for x in pol], method=jnet.eval_actor)[0]
    with torch.no_grad():
        heads = {"mu": (np.asarray(jmu), tnet.eval_actor(*[j2t(x) for x in pol])[0]),
                 "value": (j(jnet.eval_critic, *pol), tnet.eval_critic(*[j2t(x) for x in pol]))}
        if algo != "hrl":
            heads["disc"] = (j(jnet.eval_disc, amp), tnet.eval_disc(j2t(amp)))
        if algo == "ase":
            heads["enc"] = (j(jnet.eval_enc, amp), tnet.eval_enc(j2t(amp)))
    for name, (ref, got) in heads.items():
        assert got.dtype == torch.float32, name
        assert rel_err(ref, got) <= FWD_RTOL, (name, rel_err(ref, got))
    assert acts and set(acts) == {torch.bfloat16}


class _CotangentL1:
    """Per dense layer of the port: sum over its calls of (rows - 1) x the
    sum over rows of |cotangent at its output| (float32), the bound of a
    bfloat16 recursive summation of the bias gradient, in units of 2^-9."""

    def __enter__(self):
        self.acc = {}
        self._orig = tnets.Dense.forward
        acc, orig = self.acc, self._orig

        def forward(layer, x):
            y = orig(layer, x)
            if y.requires_grad:
                def hook(g, layer=layer):
                    n = g.reshape(-1, g.shape[-1]).shape[0]
                    s = (n - 1) * g.detach().float().abs().reshape(-1, g.shape[-1]).sum(0)
                    acc[id(layer)] = acc.get(id(layer), 0) + s
                y.register_hook(hook)
            return y

        tnets.Dense.forward = forward
        return self

    def __exit__(self, *exc):
        tnets.Dense.forward = self._orig


@pytest.fixture(scope="module")
def agents():
    """The bf16 JAX agent and train state and a port agent in that state."""
    jagent, ts, _, tagent, _, _ = make_agents(bf16_cfg(), env_states=False)
    assert tagent.network.actor_mlp.layers[0].compute_dtype == torch.bfloat16

    def port_agent():
        t = type(tagent)(tagent.env, copy.deepcopy(tagent.cfg_train))
        t.init_train_state()
        state_from_jax(ts, t)
        return t

    return jagent, ts, port_agent


def _check_grads(jgrads, tagent, l1, only=""):
    """Every gradient (whose key contains ``only``) against the
    reference's: within GRAD_RTOL of its tensor's largest magnitude, and a
    bias gradient also within the bf16 summation bound of its layer's
    ``_CotangentL1``. Returns the number of tensors held."""
    ref, got = _leaves(jax.device_get(jgrads)["params"]), _leaves(_grad_tree(tagent))
    bias_bound = {tckpt._path_key(path + ("bias",)): t2n(l1[id(layer)]) * BF16_HALF_ULP
                  for path, layer in tckpt._linears(tagent.network) if id(layer) in l1}
    held = 0
    for k in ref:
        if only not in k:
            continue
        err = np.abs(ref[k].astype(np.float64) - got[k])
        tol = GRAD_RTOL * float(np.abs(ref[k]).max()) + bias_bound.get(k, 0.0)
        assert bool((err <= tol).all()), (k, float(err.max()), float(np.max(tol)))
        held += 1
    return held


def test_bf16_disc_loss_and_gradients_match_reference(agents):
    """The AMP discriminator loss under bf16: BCE on agent and demo logits,
    the logit regulariser and weight decay on the float32 kernels, and the
    gradient penalty, whose input gradient (float32, through the bf16
    layers) is part of the graph; its value within LOSS_RTOL and every
    gradient of the discriminator as ``_check_grads`` holds them."""
    jagent, ts, port_agent = agents
    tagent = port_agent()
    rng = np.random.default_rng(2)
    a = rng.normal(size=(16, jagent.amp_obs_dim)).astype(np.float32)
    d = rng.normal(size=(8, jagent.amp_obs_dim)).astype(np.float32)

    def jloss(params):
        agent_logits = jagent._eval_disc(params, jnp.asarray(a))
        loss, info = jagent._disc_loss(params, agent_logits,
                                       lambda x: jagent._eval_disc(params, x), jnp.asarray(d))
        return loss, info

    (jl, jinfo), jgrads = jax.value_and_grad(jloss, has_aux=True)(ts.params)
    with _CotangentL1() as l1:
        tagent.network.zero_grad()
        loss, info = tagent._disc_loss(tagent.network.eval_disc(j2t(a)), j2t(d))
        loss.backward()
    assert loss.dtype == torch.float32 and info["disc_grad_penalty"].dtype == torch.float32
    for k in ("disc_loss", "disc_grad_penalty", "disc_logit_loss"):
        ref, got = float(jinfo[k]), float(info[k])
        assert abs(ref - got) <= LOSS_RTOL * max(1.0, abs(ref)), (k, ref, got)
    assert float(jinfo["disc_grad_penalty"]) > 0
    for p in tagent.network.parameters():      # no gradient reaches the other heads
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    # the discriminator's six tensors (disc_mlp's two layers, disc_logits)
    assert _check_grads(jgrads, tagent, l1.acc, only="disc") == 6


def test_bf16_minibatch_update_matches_reference(agents):
    """One ASE minibatch (normalizer updates, PPO + discriminator + encoder
    + diversity losses) under bf16 on both sides from the same weights,
    batch and draws: losses within LOSS_RTOL of max(1, |loss|), the policy
    mean within FWD_RTOL, every gradient as ``_check_grads`` holds it."""
    jagent, ts, port_agent = agents
    tagent = port_agent()
    mb = _minibatch(jagent, ts, 1)
    _, jloss, jinfo, jgrads = _jax_grads(jagent, ts, mb)
    _diversity_draw(tagent, ts)
    tmb = tagent._preproc_minibatch(_port_minibatch(tagent, mb))
    with _CotangentL1() as l1:
        loss, info = tagent._loss(tmb)
        tagent.network.zero_grad()
        loss.backward()
    for k in ("loss", "a_loss", "c_loss", "b_loss", "disc_loss", "disc_grad_penalty",
              "enc_loss", "diversity_loss"):
        ref = float(jloss) if k == "loss" else float(jinfo[k])
        got = float((loss if k == "loss" else info[k]).detach())
        assert abs(ref - got) <= LOSS_RTOL * max(1.0, abs(ref)), (k, ref, got)
    assert rel_err(jinfo["mu"], info["mu"]) <= FWD_RTOL
    assert _check_grads(jgrads, tagent, l1.acc) == 27


def test_compute_dtype_reads_the_config_then_the_environment(monkeypatch):
    """``config.mixed_precision`` wins; without the key, ASE_TPU_BF16=1
    turns bf16 on, as in the reference."""
    cases = [({"mixed_precision": True}, "0", True), ({"mixed_precision": False}, "1", False),
             ({}, "1", True), ({}, "0", False)]
    for config, env, want in cases:
        monkeypatch.setenv("ASE_TPU_BF16", env)
        params = {"config": config}
        assert (jnets._compute_dtype(params) == jnp.bfloat16) is want
        assert tnets._compute_dtype(params) == (torch.bfloat16 if want else None)
    monkeypatch.setenv("ASE_TPU_BF16", "1")
    params = copy.deepcopy(bf16_cfg()["params"])
    del params["config"]["mixed_precision"]
    net = tnets.build_ase_network(params, 253, 31, 1400, 8)
    assert {m.compute_dtype for m in net.modules() if isinstance(m, tnets.Dense)} == \
        {torch.bfloat16}


def test_bf16_training_checkpoint_round_trips(tmp_path):
    """Two AMP epochs under mixed precision through ``run.main`` on the
    CPU: finite losses, the checkpoint holds float32 weights, and a new
    bf16 agent resumed from it holds the same weights, Adam state and
    normalizers bit for bit, and trains its third epoch."""
    from ase_tpu_torch import run
    from tests.test_torch_train_cli import _argv, _run_keep_agent

    argv = _argv(tmp_path, mixed_precision=True) + ["--device", "cpu"]
    agent, _, record = _run_keep_agent(argv)
    assert agent.network.mu.compute_dtype == torch.bfloat16
    assert all(np.isfinite(record["metrics"][k]) for k in ("a_loss", "c_loss", "disc_loss"))
    path = tmp_path / "out" / "test.ckpt.npz"
    saved = np.load(path)
    kernels = [k for k in saved.files if k.startswith(".params") and k.endswith("['kernel']")]
    assert kernels and all(saved[k].dtype == np.float32 for k in kernels)
    resumed, _, _ = run.build_agent(argv + ["--resume", "1", "--checkpoint", str(path),
                                            "--max_iterations", "3"])
    resumed.setup_training()
    resumed.resume(str(path))
    for (name, p), q in zip(agent.network.named_parameters(), resumed.network.parameters()):
        assert torch.equal(p, q), name
        sp, sq = agent.optimizer.state[p], resumed.optimizer.state[q]
        assert torch.equal(sp["exp_avg"], sq["exp_avg"]) and torch.equal(
            sp["exp_avg_sq"], sq["exp_avg_sq"]), name
    for f in ("mean", "var", "count"):
        assert torch.equal(getattr(agent.amp_rms, f), getattr(resumed.amp_rms, f))
    assert resumed.epoch == 2
