"""Port parity for the HRL player and the players' probes, on the shipped
controllers: the heading, location and reach high-level controllers
(HLCs) over the sword-and-shield low-level controller (LLC).

Both packages load the same npz files (``ase_tpu`` through its checkpoint
restore, the port through ``learning.checkpoint``) and see the same
numpy inputs; the port's env replays the JAX env's goal and reset draws
(``TaskDraws``). Products of the 1024-wide float32 layers are summed in
another order, so network outputs are held to 1e-4 of their scale. Env
steps run in float32 on both sides (``matvec_bf16=False``) from the JAX
env state after settling steps, as tests/test_torch_train_epoch.py starts.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ase_tpu.envs import parse_task as jparse
from ase_tpu.learning import checkpoint as jckpt
from ase_tpu.learning.ase_agent import ASEAgent as JASEAgent
from ase_tpu.learning.hrl_agent import HRLAgent as JHRLAgent
from ase_tpu.learning.players import AMPPlayer as JAMPPlayer
from ase_tpu.learning.players import ASEPlayer as JASEPlayer
from ase_tpu.learning.players import HRLPlayer as JHRLPlayer
from ase_tpu.models import networks as jnets
from ase_tpu.utils import paths as jpaths
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.learning.ase_agent import ASEAgent as TASEAgent
from ase_tpu_torch.learning.hrl_agent import HRLAgent as THRLAgent
from ase_tpu_torch.learning.players import AMPPlayer as TAMPPlayer
from ase_tpu_torch.learning.players import ASEPlayer as TASEPlayer
from ase_tpu_torch.learning.players import HRLPlayer as THRLPlayer
from ase_tpu_torch.models import networks as tnets
from tests.test_torch_env import f32_solver
from tests.test_torch_tasks import TaskDraws, task_cfg
from tests.test_torch_train_parts import _one_torch_thread, env_state_from_jax, t2n  # noqa: F401

LLC = "data/models/ase_llc_reallusion_sword_shield.ckpt.npz"
HLC = "data/models/ase_hlc_{}_reallusion_sword_shield.ckpt.npz"
TASK_OBS = {"heading": ("HumanoidHeading", 5), "location": ("HumanoidLocation", 2),
            "reach": ("HumanoidReach", 3)}
B = 4
SETTLE = 8


def cfg_train(name):
    with open(jpaths.data_path("cfg", "train", "rlg", name)) as f:
        cfg = yaml.safe_load(f)
    cfg["params"]["seed"] = 0
    c = cfg["params"]["config"]
    c.update(minibatch_size=B * c["horizon_length"], llc_checkpoint=LLC,
             amp_obs_demo_buffer_size=256, amp_replay_buffer_size=256)
    return cfg


def close(ref, got, rel, what):
    ref = np.asarray(ref, np.float64)
    got = t2n(got).astype(np.float64) if isinstance(got, torch.Tensor) else np.asarray(got)
    assert ref.shape == got.shape, (what, ref.shape, got.shape)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol, (what, err, tol)
    return err


@pytest.mark.parametrize("task", sorted(TASK_OBS))
def test_shipped_hlc_heads_match_reference(task):
    """An HRLNetwork restored from each shipped HLC (and, the same, through
    ``load_ase``) gives the JAX network's mu, sigma and value on the same
    observations."""
    path = HLC.format(task)
    params = cfg_train("hrl_humanoid.yaml")["params"]
    obs_dim = 253 + TASK_OBS[task][1]
    jnet = jnets.build_network("hrl", params, obs_dim, 64)
    jp = jckpt.restore(path, jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim))),
                       prefix=".params")
    tnet = tnets.build_hrl_network(params, obs_dim, 64)
    tckpt.restore_subtree(path, tckpt.network_leaves(tnet), ".params")
    tnet2 = tnets.build_hrl_network(params, obs_dim, 64)
    tckpt.load_ase(tckpt.read_npz_tree(path), tnet2)
    obs = np.random.default_rng(1).normal(size=(16, obs_dim)).astype(np.float32)
    mu, sigma = jnet.apply(jp, jnp.asarray(obs), method=jnet.eval_actor)
    value = jnet.apply(jp, jnp.asarray(obs), method=jnet.eval_critic)
    with torch.no_grad():
        for net in (tnet, tnet2):
            tmu, tsigma = net.eval_actor(torch.as_tensor(obs))
            close(mu, tmu, 1e-4, "mu")
            close(sigma, tsigma, 0.0, "sigma")
            close(value, net.eval_critic(torch.as_tensor(obs)), 1e-4, "value")


def _agents(**env):
    """JAX and port HRL agents on the heading task (B envs, no reset
    chunks, float32 contact solve) with the shipped LLC and heading HLC,
    the port env replaying the JAX draws, and a port state to carry JAX
    states into."""
    cfg = task_cfg("HumanoidHeading", numEnvs=B, resetChunk=0, **env)
    jenv = jparse("HumanoidHeading", copy.deepcopy(cfg))
    tenv = tparse("HumanoidHeading", copy.deepcopy(cfg), device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    jagent = JHRLAgent(jenv, cfg_train("hrl_humanoid.yaml"))
    tagent = THRLAgent(tenv, cfg_train("hrl_humanoid.yaml"))
    ts = jckpt.restore(HLC.format("heading"), jagent.init_train_state(jax.random.PRNGKey(0)),
                       strict=False)
    tagent.restore(HLC.format("heading"))
    draws = TaskDraws(jenv)
    tenv._draw_reset, tenv._draw_goal = draws.reset, draws.goal
    draws.key = jax.random.PRNGKey(2)
    like = tenv.initial_state()
    return jenv, tenv, jagent, tagent, ts, draws, like


def _jax_state(jenv, jagent, steps, key=2):
    """The JAX env state after ``steps`` control steps of the LLC under
    latent (1, 0, ..., 0)."""
    js = jenv.initial_state(jax.random.PRNGKey(key))
    z = jnp.zeros((jenv.num_envs, 64)).at[:, 0].set(1.0)
    for _ in range(steps):
        js = jenv.step(js, jagent._compute_llc_action(js.obs, z))
    return js


def test_env_step_window_matches_reference():
    """One high-level step: the HLC's mu, then llc_steps = 5 control steps
    of the LLC's clipped mean under it. Every LLC step's actions,
    observations, AMP observations and rewards, and the averaged task and
    discriminator rewards, agree to 1e-4 of scale (measured: at most 7e-6,
    the float32 contact solve summed in another order); done and terminate
    ORed over the window agree exactly."""
    jenv, tenv, jagent, tagent, ts, draws, like = _agents()
    jstep = jax.jit(jenv.step)
    jenv.step = jstep
    js = _jax_state(jenv, jagent, SETTLE)
    tstate = env_state_from_jax(js, like)
    draws.key = js.rng

    obs_n = ts.obs_rms.normalize(js.obs)
    mu, _ = jagent._actor_sigma(ts.params, obs_n, {})
    with torch.no_grad():
        tmu, _ = tagent._actor_sigma(tagent.obs_rms.normalize(tstate.obs), {})
    close(mu, tmu, 1e-4, "HLC mu")

    seen = {"jax": [], "port": []}
    tstep = tenv.step

    def jrec(s, a):
        out = jstep(s, a)
        seen["jax"].append((a, out))
        return out

    def trec(s, a):
        out = tstep(s, a)
        seen["port"].append((a, out))
        return out

    jenv.step, tenv.step = jrec, trec
    _, js2, rew, infos, _ = jagent._env_step(ts, js, mu, {})
    ts2, trew, tinfos = tagent._env_step(tstate, torch.as_tensor(np.array(mu)))
    assert len(seen["jax"]) == len(seen["port"]) == tagent._llc_steps == 5
    for i, ((ja, jo), (ta, to)) in enumerate(zip(seen["jax"], seen["port"])):
        close(ja, ta, 1e-4, f"LLC actions {i}")
        close(jo.obs, to.obs, 1e-4, f"obs {i}")
        close(jo.rew, to.rew, 1e-4, f"reward {i}")
        close(jenv.amp_obs_flat(jo), tenv.amp_obs_flat(to), 1e-4, f"amp obs {i}")
    assert float(np.abs(np.asarray(seen["jax"][0][0])).max()) > 0.1
    close(rew, trew, 1e-4, "averaged task reward")
    close(infos["disc_rewards"], tinfos["disc_rewards"], 1e-4, "averaged disc reward")
    np.testing.assert_array_equal(t2n(ts2.reset_buf), np.asarray(js2.reset_buf))
    np.testing.assert_array_equal(t2n(ts2.terminate_buf), np.asarray(js2.terminate_buf))
    np.testing.assert_array_equal(t2n(ts2.progress), np.asarray(js2.progress))

    # the OR: a done / terminate raised by one inner step stays raised
    flags = torch.tensor([0, 1, 0, 1], dtype=torch.int32)
    ends = iter([flags, torch.zeros(B, dtype=torch.int32)] * 3)

    def flagged(s, a):
        out = tstep(s, a)
        f = next(ends)
        return out.replace(reset_buf=f, terminate_buf=f)

    tenv.step = flagged
    tagent._llc_steps = 2
    ts3, _, _ = tagent._env_step(tstate, torch.as_tensor(np.array(mu)))
    assert ts3.reset_buf.tolist() == ts3.terminate_buf.tolist() == flags.tolist()


def test_hrl_player_matches_reference():
    """HRLPlayer.run for 3 high-level decisions of 2 LLC steps each, with
    4-step episodes (every env finishes one), a success indicator (root
    above 0.8 m) and the LLC discriminator probe, against ase_tpu's
    HRLPlayer from the same state, weights and draws: episode counts,
    lengths and success meters exactly, returns and the probe to 1e-4
    (measured: equal to float32 printing)."""
    jenv, tenv, jagent, tagent, ts, draws, like = _agents(episodeLength=4)
    jagent._llc_steps = tagent._llc_steps = 2
    js = jax.jit(lambda k: jenv.initial_state(k))(jax.random.PRNGKey(2))
    tstate = env_state_from_jax(js, like)
    draws.key = js.rng
    jplayer = JHRLPlayer(jagent, debug_probes=True)
    tplayer = THRLPlayer(tagent, debug_probes=True)
    jstats = jplayer.run(num_steps=3, ts=ts, env_state=js, max_chunks=1,
                         success_fn=lambda s: s.body_pos[:, 0, 2] > 0.8)
    tstats = tplayer.run(num_steps=3, env_state=tstate, max_chunks=1,
                         success_fn=lambda s: s.body_pos[:, 0, 2] > 0.8)
    assert jstats["episodes"] == tstats["episodes"] == B
    assert set(jstats) == set(tstats)
    for k in ("mean_length", "success_rate", "success_time_frac"):
        assert tstats[k] == pytest.approx(jstats[k], abs=1e-6), k
    for k in ("mean_return", "running_return_mean", "llc_disc_reward"):
        assert tstats[k] == pytest.approx(jstats[k], rel=1e-4, abs=1e-6), k
    assert tstats["success_time_frac"] > 0


def test_amp_and_ase_player_probes_match_reference():
    """The AMP player's disc_pred / disc_reward and the ASE player's
    enc_reward probes, and their whole-batch disc and enc rewards, on the
    shipped LLC and the same env state and latents."""
    with open(jpaths.data_path("cfg", "humanoid_sword_shield.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["env"].update(numEnvs=B, motion_file=task_cfg("HumanoidHeading")["env"]["motion_file"])
    cfg["task"] = {"randomize": False}
    jenv = jparse("HumanoidAMP", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMP", copy.deepcopy(cfg), device="cpu")
    jagent = JASEAgent(jenv, cfg_train("ase_humanoid.yaml"))
    tagent = TASEAgent(tenv, cfg_train("ase_humanoid.yaml"))
    ts = jckpt.restore(LLC, jagent.init_train_state(jax.random.PRNGKey(0)), strict=False)
    tagent.restore(LLC)
    js = jenv.initial_state(jax.random.PRNGKey(3))
    tstate = env_state_from_jax(js, tenv.initial_state())
    z = np.random.default_rng(2).normal(size=(B, 64)).astype(np.float32)
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    jroll, troll = {"ase_latents": jnp.asarray(z)}, {"ase_latents": torch.as_tensor(z)}
    with torch.no_grad():
        for jcls, tcls in ((JAMPPlayer, TAMPPlayer), (JASEPlayer, TASEPlayer)):
            want = jcls(jagent)._probe(ts, js, jroll)
            got = tcls(tagent)._probe(tstate, troll)
            assert set(want) == set(got)
            for k, v in want.items():
                close(v, got[k], 1e-4, k)
        close(JAMPPlayer(jagent).disc_reward(ts, js), TAMPPlayer(tagent).disc_reward(tstate),
              1e-4, "disc_reward")
        close(JASEPlayer(jagent).enc_reward(ts, js, jroll["ase_latents"]),
              TASEPlayer(tagent).enc_reward(tstate, troll["ase_latents"]), 1e-4, "enc_reward")


@pytest.mark.parametrize("task", sorted(TASK_OBS))
def test_cli_plays_each_shipped_hlc(task):
    """``python -m ase_tpu_torch.run --test`` plays each shipped HLC over the
    shipped LLC (here 2 decisions at 4 envs on the CPU); without
    ``--device cpu`` it wants the card."""
    from ase_tpu_torch import run

    name, ntask = TASK_OBS[task]
    argv = ["--test", "--task", name, "--cfg_env", f"humanoid_sword_shield_{task}.yaml",
            "--cfg_train", "train/rlg/hrl_humanoid.yaml", "--motion_file", task_cfg(name)["env"]
            ["motion_file"], "--llc_checkpoint", LLC, "--checkpoint", HLC.format(task),
            "--num_envs", str(B)]
    stats = run.main(argv + ["--device", "cpu"], num_steps=2, max_chunks=1)
    assert np.isfinite(stats["running_return_mean"]) and stats["running_return_mean"] > 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.build_player(argv)
