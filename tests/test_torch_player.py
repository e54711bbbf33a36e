"""Port parity for the ASE networks, the weight-carrying loader and the
player.

The shipped LLC checkpoint is loaded into both packages -- into the JAX
network by ase_tpu's own checkpoint.restore, into the port's modules by
ase_tpu_torch.learning.checkpoint -- and eval_actor / eval_critic /
eval_disc / eval_enc are compared on the same numpy inputs (float32 on
both sides; 1e-4 of the largest output magnitude for the 1024-wide float32
products summed in another order).

The player test runs the port's player loop on the CPU (B = 8) and holds
every action it takes against the JAX agent's policy on the same
observation: the JAX ``ASEAgent._pre_rollout_step`` latent schedule, fed
the same random numbers (``JaxLatentDraws`` replays its key chain), then
the restored JAX network.
"""

import copy
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.envs import parse_task as jparse
from ase_tpu.learning import checkpoint as jckpt
from ase_tpu.learning.ase_agent import ASEAgent as JASEAgent
from ase_tpu.learning.common_agent import TrainState
from ase_tpu.learning.running_mean_std import RunningMeanStd as JRMS
from ase_tpu.models import networks as jnets
from ase_tpu.utils import config as jcfg
from ase_tpu.utils import paths
from ase_tpu_torch import run
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.learning.running_mean_std import RunningMeanStd as TRMS
from ase_tpu_torch.models import networks as tnets


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs B <= 16 here: intra-op threads would only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CKPT = "data/models/ase_llc_reallusion_sword_shield.ckpt.npz"
ARGV = [
    "--test", "--task", "HumanoidAMPGetup",
    "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
    "--cfg_train", "train/rlg/ase_humanoid.yaml",
    "--motion_file", "reallusion_sword_shield/dataset_reallusion_sword_shield.yaml",
    "--checkpoint", CKPT, "--num_envs", "8", "--seed", "5",
]
OBS, AMP, ACT, LAT = 253, 1400, 31, 64


@pytest.fixture(scope="module")
def cfgs():
    return jcfg.load_cfg(jcfg.get_args(ARGV))


@pytest.fixture(scope="module")
def jax_net(cfgs):
    """The JAX ASENetwork with the shipped weights and normalizers."""
    net = jnets.build_network("ase", cfgs[1]["params"], OBS, ACT, amp_obs_dim=AMP,
                              latent_dim=LAT)
    template = net.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)), jnp.zeros((1, LAT)),
                        jnp.zeros((1, AMP)))
    path = os.path.join(paths.repo_root(), CKPT)
    params = jckpt.restore_subtree(path, template, ".params")
    obs_rms = jckpt.restore_subtree(path, JRMS.create((OBS,)), ".obs_rms")
    amp_rms = jckpt.restore_subtree(path, JRMS.create((AMP,)), ".extra['amp_rms']")
    return net, params, obs_rms, amp_rms


def _inputs(seed, n=16):
    rng = np.random.default_rng(seed)
    z = rng.normal(size=(n, LAT)).astype(np.float32)
    return (rng.normal(size=(n, OBS)).astype(np.float32),
            z / np.linalg.norm(z, axis=-1, keepdims=True),
            rng.normal(size=(n, AMP)).astype(np.float32))


def close(ref, got, rel=1e-4):
    ref = np.asarray(ref, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert ref.shape == got.shape
    tol = rel * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(ref - got).max()) <= tol


def _compare_heads(net, params, tnet, obs, z, amp):
    o, zz, a = (torch.as_tensor(x) for x in (obs, z, amp))
    with torch.no_grad():
        mu, sigma = tnet.eval_actor(o, zz)
        jmu, jsigma = net.apply(params, obs, z, method=net.eval_actor)
        close(jmu, mu)
        close(jsigma, sigma)
        close(net.apply(params, obs, z, method=net.eval_critic), tnet.eval_critic(o, zz))
        close(net.apply(params, amp, method=net.eval_disc), tnet.eval_disc(a))
        close(net.apply(params, amp, method=net.eval_enc), tnet.eval_enc(a))


def test_shipped_llc_heads_match_reference(cfgs, jax_net):
    net, params, obs_rms, amp_rms = jax_net
    tnet = tnets.build_ase_network(cfgs[1]["params"], OBS, ACT, AMP, LAT)
    t_obs, t_amp = TRMS((OBS,)), TRMS((AMP,))
    tckpt.load_ase(tckpt.read_npz_tree(CKPT), tnet, t_obs, t_amp)
    assert tuple(tnet.actor_mlp.layers[0].weight.shape) == (1024, OBS + LAT)   # 317 in
    assert tuple(tnet.disc_mlp.layers[0].weight.shape) == (1024, AMP)
    obs, z, amp = _inputs(0)
    close(obs_rms.normalize(obs), t_obs.normalize(torch.as_tensor(obs)))
    close(amp_rms.normalize(amp), t_amp.normalize(torch.as_tensor(amp)))
    _compare_heads(net, params, tnet, np.asarray(obs_rms.normalize(obs)), z,
                   np.asarray(amp_rms.normalize(amp)))


def test_loader_takes_a_numpy_params_tree(cfgs):
    """A freshly initialized JAX params tree, turned into numpy, carried
    into the port through the same function."""
    net = jnets.build_network("ase", cfgs[1]["params"], OBS, ACT, amp_obs_dim=AMP,
                              latent_dim=LAT)
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, OBS)), jnp.zeros((1, LAT)),
                      jnp.zeros((1, AMP)))
    tnet = tnets.build_ase_network(cfgs[1]["params"], OBS, ACT, AMP, LAT)
    tckpt.load_ase({"params": jax.device_get(params)["params"]}, tnet)
    _compare_heads(net, params, tnet, *_inputs(1))


class JaxLatentDraws:
    """The random numbers JAX ``ASEAgent._pre_rollout_step`` draws from
    ``key`` (``ase_agent.py:87-117``), in the port's format."""

    def __init__(self, key, lo, hi):
        self.key, self.lo, self.hi = key, lo, hi

    def __call__(self, n):
        self.key, k1, k2, k3, k4 = jax.random.split(self.key, 5)
        d = {"z_reset": jax.random.normal(k1, (n, LAT)),
             "steps_reset": jax.random.randint(k2, (n,), self.lo, self.hi),
             "z_resample": jax.random.normal(k3, (n, LAT)),
             "steps_inc": jax.random.randint(k4, (n,), self.lo, self.hi)}
        return {k: torch.as_tensor(np.array(v)).to(torch.long if k.startswith("steps")
                                                   else torch.float32)
                for k, v in d.items()}


def test_player_actions_match_reference(cfgs, jax_net):
    net, params, obs_rms, _ = jax_net
    player, cfg = run.build_player(ARGV + ["--device", "cpu"])
    env, agent = player.env, player.agent
    env._fall_states = env.default_phys_state(env.num_envs)   # skip the 150-tick drop
    B = env.num_envs

    # the same initial latents and schedule draws on both sides
    _, z0, _ = _inputs(2, B)
    steps0 = np.random.default_rng(2).integers(1, 150, B)
    agent._init_rollout_carry = lambda: {
        "ase_latents": torch.as_tensor(z0), "latent_reset_steps": torch.as_tensor(steps0)}
    key0 = jax.random.PRNGKey(11)
    agent._draw_latents = JaxLatentDraws(key0, agent._latent_steps_min, agent._latent_steps_max)

    seen = []
    env_step = agent._env_step

    def record(env_state, actions):
        seen.append((env_state.obs.clone(), env_state.progress.clone(), actions.clone()))
        return env_step(env_state, actions)

    agent._env_step = record
    stats = player.run(num_steps=6, max_chunks=1)
    assert len(seen) == 6 and np.isfinite(stats["running_return_mean"])

    jcfg_train = copy.deepcopy(cfgs[1])
    jcfg_train["params"]["config"]["minibatch_size"] = 256
    jenv_cfg = copy.deepcopy(cfgs[0])
    jagent = JASEAgent(jparse("HumanoidAMPGetup", jenv_cfg), jcfg_train)
    ts = TrainState(params=params, opt_state=None, obs_rms=obs_rms, value_rms=None,
                    rng=key0, epoch=0, frame=0, extra={})
    roll = {"ase_latents": jnp.asarray(z0), "latent_reset_steps": jnp.asarray(steps0, jnp.int32)}
    for obs, progress, actions in seen:
        ts, _, roll = jagent._pre_rollout_step(
            ts, types.SimpleNamespace(progress=jnp.asarray(progress.numpy())), roll)
        mu, _ = jagent._actor_sigma(ts.params, ts.obs_rms.normalize(jnp.asarray(obs.numpy())), roll)
        close(mu, actions)
    assert float(torch.stack([a for _, _, a in seen]).abs().max()) > 0.1


def test_network_refuses_mixed_precision_until_ported(cfgs):
    """The reference runs bf16 matmuls when ``config.mixed_precision`` is
    true (``_compute_dtype``). The port, which once refused the switch,
    now follows it: the shipped config builds a float32 network, and with
    the switch every dense layer computes in bfloat16 over float32
    parameters while the heads come out float32
    (tests/test_torch_mixed_precision.py holds the values)."""
    params = copy.deepcopy(cfgs[1]["params"])
    assert params["config"]["mixed_precision"] is False   # the shipped config
    net = tnets.build_ase_network(params, OBS, ACT, AMP, LAT)
    assert {m.compute_dtype for m in net.modules() if isinstance(m, tnets.Dense)} == {None}
    params["config"]["mixed_precision"] = True
    net = tnets.build_ase_network(params, OBS, ACT, AMP, LAT)
    assert {m.compute_dtype for m in net.modules() if isinstance(m, tnets.Dense)} == \
        {torch.bfloat16}
    assert all(p.dtype == torch.float32 for p in net.parameters())
    with torch.no_grad():
        mu, sigma = net.eval_actor(torch.zeros(2, OBS), torch.ones(2, LAT) / LAT ** 0.5)
    assert mu.dtype == sigma.dtype == torch.float32
