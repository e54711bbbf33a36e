"""Port parity for the parts of the training epoch: the running
mean/std update, the replay buffer, the demo fetch, the network's initial
weights and the weight export. The shared helpers of the other
``test_torch_train_*`` files live here too.

JAX and torch random streams differ, so every draw the port's training
side consumes goes through a ``_draw_*`` method, and ``JaxAgentDraws``
replays the JAX agent's key chain in that format: the tests hand both
packages the same numbers.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.envs import parse_task as jparse
from ase_tpu.learning.ase_agent import ASEAgent as JASEAgent
from ase_tpu.learning.replay_buffer import ReplayBuffer as JBuf
from ase_tpu.learning.running_mean_std import RunningMeanStd as JRMS
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.learning.ase_agent import ASEAgent as TASEAgent
from ase_tpu_torch.learning.replay_buffer import ReplayBuffer as TBuf
from ase_tpu_torch.learning.running_mean_std import RunningMeanStd as TRMS
from ase_tpu_torch.models import networks as tnets
from tests.test_learning import TRAIN_CFG
from tests.test_torch_env import JaxDraws, f32_solver, getup_cfg, to_jax_state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port runs B <= 16 here: intra-op threads would only contend with
    the other test workers for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- shared helpers -------------------------------------------------------------------

def ase_train_cfg():
    """tests/test_learning.py's TRAIN_CFG as an ASE config: widths 32-16,
    horizon 4, minibatch 8, 2 mini-epochs, buffers of 256, latent_dim 8."""
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["params"]["algo"]["name"] = "ase"
    cfg["params"]["network"]["name"] = "ase"
    return cfg


def t2n(x):
    return x.detach().cpu().numpy()


def j2t(x, dtype=None):
    v = np.asarray(x)
    if dtype is None:
        dtype = torch.long if v.dtype.kind in "iu" else (torch.bool if v.dtype == bool
                                                          else torch.float32)
    return torch.as_tensor(v.copy()).to(dtype)


def close(ref, got, atol, what=""):
    ref = np.asarray(ref, np.float64)
    got = t2n(got).astype(np.float64) if torch.is_tensor(got) else np.asarray(got, np.float64)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    err = float(np.abs(ref - got).max()) if ref.size else 0.0
    assert err <= atol, (what, err, atol)


def rel_close(ref, got, rel, what=""):
    """Within ``rel`` of the reference's largest magnitude (at least 1e-30)."""
    ref = np.asarray(ref, np.float64)
    close(ref, got, rel * max(float(np.abs(ref).max()) if ref.size else 0.0, 1e-30), what)


class JaxAgentDraws:
    """The numbers the JAX ASE/AMP agent draws from its train-state key, in
    the order its epoch consumes them, in the port's ``_draw_*`` formats.
    Install with ``install(agent)``; ``key`` is the JAX ``ts.rng``."""

    def __init__(self, key, jagent):
        self.key, self.j = key, jagent
        self.pending = []

    def _split(self, n):
        keys = jax.random.split(self.key, n + 1)
        self.key = keys[0]
        return keys[1:]

    def latents(self, n):
        k = self._split(4)
        lo, hi, L = self.j._latent_steps_min, self.j._latent_steps_max, self.j._latent_dim
        return {"z_reset": j2t(jax.random.normal(k[0], (n, L))),
                "steps_reset": j2t(jax.random.randint(k[1], (n,), lo, hi)),
                "z_resample": j2t(jax.random.normal(k[2], (n, L))),
                "steps_inc": j2t(jax.random.randint(k[3], (n,), lo, hi))}

    def actions(self, n):
        k = self._split(2)
        return {"noise": j2t(jax.random.normal(k[0], (n, self.j.action_dim))),
                "u_mask": j2t(jax.random.uniform(k[1], (n,)))}

    def demo(self, n):
        """The epoch's demo refresh: one 4-way split whose last two keys
        feed the two cursor draws that follow."""
        k = self._split(3)
        self.pending = [k[1], k[2]]
        return demo_draws(k[0], self.j.env, n)

    def cursor(self, buf, n):
        return cursor_draws(self.pending.pop(0), buf, n)

    def minibatch_perm(self):
        (k,) = self._split(1)
        return j2t(jax.random.permutation(k, self.j.batch_size))

    def diversity(self, n):
        self._split(1)
        return j2t(jax.random.normal(jax.random.fold_in(self.key, 23), (n, self.j._latent_dim)))

    def replay_keep(self, n):
        (k,) = self._split(1)
        return j2t(jax.random.uniform(k, (n,)))

    def install(self, agent):
        agent._draw_latents = self.latents
        agent._draw_actions = self.actions
        agent.env._draw_demo = self.demo
        agent._draw_cursor = self.cursor
        agent._draw_minibatch_perm = self.minibatch_perm
        agent._draw_diversity_latents = self.diversity
        agent._draw_replay_keep = self.replay_keep


def demo_draws(key, jenv, n):
    """What JAX ``fetch_amp_obs_demo(key, n)`` draws."""
    k1, k2 = jax.random.split(key)
    w = jenv._motion_lib.weights
    return {"motion_ids": j2t(jax.random.categorical(k1, jnp.log(jnp.maximum(w, 1e-12)),
                                                     shape=(n,))),
            "motion_phase": j2t(jax.random.uniform(k2, (n,)))}


def cursor_draws(key, buf, n):
    """What JAX ``sample_cursor_idx(key, n)`` draws, for the port buffer
    ``buf`` in the same state."""
    rng, k_uniform = jax.random.split(key)
    limit = jnp.clip(jnp.asarray(int(buf.total_count), jnp.int32), 1, buf.capacity)
    return {"uniform_idx": j2t(jax.random.randint(k_uniform, (n,), 0, limit)),
            "new_perm": j2t(jax.random.permutation(rng, buf.capacity))}


def buffer_from_jax(jbuf, tbuf):
    tbuf.data = j2t(jbuf.data)
    tbuf.head, tbuf.total_count, tbuf.cursor = (j2t(x) for x in
                                                (jbuf.head, jbuf.total_count, jbuf.cursor))
    tbuf.perm = j2t(jbuf.perm)


def check_buffer(jbuf, tbuf, what="", atol=0.0):
    """Counters and permutation exact; data exact or within ``atol``."""
    close(jbuf.data, tbuf.data, atol, what)
    for f in ("head", "total_count", "cursor", "perm"):
        np.testing.assert_array_equal(t2n(getattr(tbuf, f)), np.asarray(getattr(jbuf, f)),
                                      err_msg=f"{what} {f}")


def state_from_jax(ts, tagent):
    """Carry a JAX ASE/AMP train state into the port agent (after its own
    ``init_train_state``): weights, normalizers, buffers, meters, latents."""
    extra = jax.device_get(ts.extra)
    tree = {"params": jax.device_get(ts.params)["params"],
            "obs_rms": {f: np.asarray(getattr(ts.obs_rms, f)) for f in ("mean", "var", "count")},
            "value_rms": {f: np.asarray(getattr(ts.value_rms, f)) for f in ("mean", "var", "count")},
            "amp_rms": {f: np.asarray(getattr(extra["amp_rms"], f))
                        for f in ("mean", "var", "count")}}
    tckpt.load_ase(tree, tagent.network, tagent.obs_rms, tagent.amp_rms, tagent.value_rms)
    buffer_from_jax(extra["demo_buffer"], tagent.demo_buffer)
    buffer_from_jax(extra["replay_buffer"], tagent.replay_buffer)
    for k in tagent.meters:
        tagent.meters[k] = j2t(extra[k], tagent.meters[k].dtype)
    if "ase_latents" in extra:
        tagent.roll_state = {"ase_latents": j2t(extra["ase_latents"]),
                             "latent_reset_steps": j2t(extra["latent_reset_steps"])}


def env_state_from_jax(js, like):
    """The JAX env state ``js`` as a port EnvState (the port's aux keys)."""
    kw = {f: j2t(getattr(js, f), getattr(like, f).dtype)
          for f in ("body_pos", "body_quat", "body_vel", "body_ang_vel", "contact_forces", "obs",
                    "rew", "reset_buf", "terminate_buf", "progress", "actions")}
    phys = type(like.phys)(*(j2t(getattr(js.phys, f), getattr(like.phys, f).dtype)
                             for f in like.phys._fields))
    aux = {k: j2t(js.aux[k], v.dtype) for k, v in like.aux.items()}
    return like.replace(phys=phys, aux=aux, **kw)


def make_agents(cfg_train=None, env_states=True, settle=0):
    """A JAX and a port ASE agent on B = 8 HumanoidAMPGetup envs (reset
    chunk 4, float32 contact solve on both sides) with the same fall
    states, weights and train state; returns (jagent, ts, js, tagent,
    tstate, draws) with the port env's reset draws and the agent's draws
    replaying the JAX key chains. Without ``env_states`` no env is reset
    (js and tstate are None) and the fall states are default poses. The
    port's initial env state is the JAX one carried across (its own initial
    reset agrees only to ~4e-4, the motion frames' arccos; contacts would
    amplify that over a rollout). ``settle`` control steps of the JAX env
    under zero actions come first."""
    cfg_train = cfg_train or ase_train_cfg()
    cfg = getup_cfg()
    jenv = jparse("HumanoidAMPGetup", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMPGetup", copy.deepcopy(cfg), device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    fall_states = tenv.generate_fall_states() if env_states else tenv.default_phys_state(8)
    tenv._fall_states = fall_states
    jenv._fall_states = to_jax_state(fall_states)
    jagent = JASEAgent(jenv, copy.deepcopy(cfg_train))
    tagent = TASEAgent(tenv, copy.deepcopy(cfg_train))
    ts = jagent.init_train_state(jax.random.PRNGKey(0))
    js = tstate = None
    if env_states:
        key = jax.random.PRNGKey(1)
        js = jenv.initial_state(key)
        step, reset = jax.jit(jenv.step), jax.jit(jenv.reset_done)
        for _ in range(settle):
            js = step(reset(js), jnp.zeros((jenv.num_envs, jenv.get_action_size())))
        env_draws = JaxDraws(jenv)
        env_draws.key = jax.random.split(key)[1]
        tenv._draw_reset = env_draws
        tstate = env_state_from_jax(js, tenv.initial_state())
        env_draws.key = js.rng
    tagent.init_train_state()
    state_from_jax(ts, tagent)
    draws = JaxAgentDraws(ts.rng, jagent)
    draws.install(tagent)
    return jagent, ts, js, tagent, tstate, draws


# -- RMS and replay buffer ------------------------------------------------------------

def test_running_mean_std_update_matches_reference():
    """Two Chan merges and a denormalize, 1e-6 of scale (float32 sums in
    another order)."""
    rng = np.random.default_rng(0)
    data = (rng.normal(size=(60, 5)) * 3 + 2).astype(np.float32)
    j, t = JRMS.create((5,)), TRMS((5,))
    assert float(t.count) == pytest.approx(1e-4)
    for part in (data[:25], data[25:]):
        j = j.update(jnp.asarray(part))
        assert t.update(torch.as_tensor(part)) is t
    for f in ("mean", "var", "count"):
        rel_close(getattr(j, f), getattr(t, f), 1e-6, f)
    y = rng.normal(size=(7, 5)).astype(np.float32)
    rel_close(j.denormalize(jnp.asarray(y)), t.denormalize(torch.as_tensor(y)), 1e-6)
    rel_close(j.normalize(jnp.asarray(data), clip=jnp.inf),
              t.normalize(torch.as_tensor(data), clip=float("inf")), 1e-6)


def test_replay_buffer_matches_reference():
    """store, masked store, store_compact and the cursor over a partly
    filled, a full and an exhausted buffer, with the JAX draws: indices
    exact, data exact (pure copies)."""
    rng = np.random.default_rng(1)
    cap, dim = 16, 3
    j, t = JBuf.create(cap, dim), TBuf(cap, dim, device="cpu")
    key = jax.random.PRNGKey(2)

    def rows(n):
        return rng.normal(size=(n, dim)).astype(np.float32)

    def cursor(j, n, what):
        nonlocal key
        key, k = jax.random.split(key)
        d = cursor_draws(k, t, n)
        j, jidx = j.sample_cursor_idx(k, n)
        np.testing.assert_array_equal(t2n(t.sample_cursor_idx(n, **d)), np.asarray(jidx),
                                      err_msg=what)
        check_buffer(j, t, what)
        return j

    x = rows(6)
    j, _ = j.store(jnp.asarray(x)), t.store(torch.as_tensor(x))
    check_buffer(j, t, "store")
    j = cursor(j, 5, "partly filled")            # uniform over the 6 stored rows
    np.testing.assert_array_equal(t2n(t.sample(torch.arange(3))), np.asarray(j.data[:3]))
    x, mask = rows(9), rng.random(9) < 0.5
    j = j.store(jnp.asarray(x), mask=jnp.asarray(mask))
    t.store(torch.as_tensor(x), mask=torch.as_tensor(mask))
    check_buffer(j, t, "masked store")
    x, mask = rows(12), rng.random(12) < 0.7
    j = j.store_compact(jnp.asarray(x), jnp.asarray(mask), 4)   # more than k_max kept
    t.store_compact(torch.as_tensor(x), torch.as_tensor(mask), 4)
    check_buffer(j, t, "store_compact")
    x = rows(cap)
    j, _ = j.store(jnp.asarray(x)), t.store(torch.as_tensor(x))   # full, head wraps
    assert int(t.total_count) >= cap
    assert int(t.cursor) == 5
    j = cursor(j, 7, "full")                     # the stored permutation, cursor 5 -> 12
    j = cursor(j, 7, "exhausted")                # 12 + 7 > 16: new permutation, cursor 0
    assert int(t.cursor) == 0
    j = cursor(j, 5, "after the reshuffle")


def test_demo_fetch_matches_reference():
    """fetch_amp_obs_demo / build_amp_obs_demo with the JAX draws (motion
    ids, phases), within 1e-5; build_amp_obs_demo's window ends at times0."""
    cfg = getup_cfg()
    jenv = jparse("HumanoidAMPGetup", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMPGetup", copy.deepcopy(cfg), device="cpu")
    key = jax.random.PRNGKey(3)
    tenv._draw_demo = lambda n: demo_draws(key, jenv, n)
    n = 24
    close(jenv.fetch_amp_obs_demo(key, n), tenv.fetch_amp_obs_demo(n), 1e-5, "fetch")
    d = demo_draws(key, jenv, n)
    times0 = t2n(d["motion_phase"]) * 2.0
    ref = jenv.build_amp_obs_demo(jnp.asarray(t2n(d["motion_ids"])), jnp.asarray(times0))
    got = tenv.build_amp_obs_demo(d["motion_ids"], torch.as_tensor(times0))
    close(ref, got, 1e-5, "build")
    # step 0 of a demo window is the reference frame itself, unlike the
    # reset history, which starts one control step back
    hist = tenv._history_amp_obs(d["motion_ids"], torch.as_tensor(times0), 1)
    close(t2n(got[:, 1]), hist[:, 0], 1e-5, "history offset")


# -- networks and weights -------------------------------------------------------------

@pytest.mark.parametrize("algo", ["amp", "ase", "hrl"])
def test_network_initialisation_matches_reference_distribution(algo):
    """Random streams differ, so the distributions are compared: every bias
    0, every weight within its bound (1/sqrt(fan_in); 1.0 for the logit
    layer and the style output, 0.1 for the encoder head), each weight
    tensor's std within 10% of bound/sqrt(3), and sigma the config's
    constant. Full widths."""
    from ase_tpu.utils import config as jcfg

    _, cfg_train = jcfg.load_cfg(jcfg.get_args([
        "--cfg_env", "humanoid_ase_sword_shield_getup.yaml",
        "--cfg_train", f"train/rlg/{'hrl' if algo == 'hrl' else 'ase'}_humanoid.yaml"]))
    params = dict(cfg_train["params"], seed=11)
    if algo == "amp":
        net = tnets.build_amp_network(params, 253, 31, 1400)
    elif algo == "ase":
        net = tnets.build_ase_network(params, 253, 31, 1400, 64)
    else:
        net = tnets.build_network("hrl", params, 258, 64)
    special = {"disc_logits": 1.0, "enc_head": 0.1, "style_net.out": 1.0}
    n_checked = 0
    for name, mod in net.named_modules():
        if not isinstance(mod, torch.nn.Linear):
            continue
        bound = special.get(name, 1.0 / np.sqrt(mod.in_features))
        w = t2n(mod.weight)
        assert float(np.abs(t2n(mod.bias)).max()) == 0.0, name
        # the float32 draw may round to one ulp past the float32 bound
        assert np.abs(w).max() <= np.nextafter(np.float32(bound), np.float32(np.inf)), name
        want = bound / np.sqrt(3.0)
        assert abs(float(w.std()) - want) <= 0.1 * want, (name, float(w.std()), want)
        n_checked += 1
    assert n_checked == {"amp": 12, "ase": 16, "hrl": 6}[algo]
    sigma = (64, -2.3) if algo == "hrl" else (31, -2.9)
    np.testing.assert_array_equal(t2n(net.sigma), np.full(sigma[0], sigma[1], np.float32))
    assert net.sigma.requires_grad


def test_export_is_the_inverse_of_load():
    """A JAX init carried into the port by load_ase comes back unchanged
    from export_ase, with the three normalizers."""
    cfg = ase_train_cfg()
    jagent_net = jparse_net(cfg)
    net, params = jagent_net
    tnet = tnets.build_ase_network(cfg["params"], 253, 31, 1400, 8)
    rms = {k: TRMS(s) for k, s in (("obs_rms", (253,)), ("amp_rms", (1400,)), ("value_rms", (1,)))}
    rng = np.random.default_rng(4)
    tree = {"params": jax.device_get(params)["params"]}
    for k, r in rms.items():
        shape = tuple(r.mean.shape)
        tree[k] = {"mean": rng.normal(size=shape).astype(np.float32),
                   "var": rng.random(shape).astype(np.float32),
                   "count": np.float32(rng.random())}
    tckpt.load_ase(tree, tnet, **rms)
    out = tckpt.export_ase(tnet, **rms)
    flat_ref = jax.tree_util.tree_leaves_with_path(tree)
    flat_out = dict(jax.tree_util.tree_leaves_with_path(out))
    assert len(flat_ref) == len(flat_out)
    for path, v in flat_ref:
        np.testing.assert_array_equal(flat_out[path], np.asarray(v), err_msg=str(path))


def jparse_net(cfg):
    from ase_tpu.models import networks as jnets

    net = jnets.build_network("ase", cfg["params"], 253, 31, amp_obs_dim=1400, latent_dim=8)
    params = net.init(jax.random.PRNGKey(5), jnp.zeros((1, 253)), jnp.zeros((1, 8)),
                      jnp.zeros((1, 1400)))
    return net, params
