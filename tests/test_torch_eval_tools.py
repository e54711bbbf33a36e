"""The port's evaluation tools (``ase_tpu_torch/tools``: the skill sweep,
the acceptance drive, the learning validations) against the reference's
``scripts/``, and the one-env helpers they share with the package
(``obs.compute_humanoid_observations``, ``checkpoint.load_dict``).

- The fixed-latent rollout's accumulators against
  ``scripts/eval_llc_skills.py:63``'s at 4 envs x 3 steps, from the JAX
  env's state carried over, with the shipped LLC on both sides and the
  JAX reset draws handed over (float32 contact solve on both sides), at
  tests/test_torch_env.py's stepped-state tolerance (1e-2).
- The success functions against ``scripts/accept_drive.py:30-58``'s, and
  the stats summaries against the script's formulas, on the same arrays.
- Each tool's ``main`` end to end at 2-4 envs with ``--device cpu`` into
  ``tmp_path``, with the reference's output keys (as
  tests/test_eval_scripts.py runs the reference's). The shipped configs'
  200,000-row AMP buffers are cut to 256 rows and the training horizon to
  4 steps there (a test-side edit of the loaded configs).
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.envs import obs as jobs
from ase_tpu.learning import checkpoint as jckpt
from ase_tpu.models import networks as jnet
from ase_tpu_torch import tools
from ase_tpu_torch.envs import obs as tobs
from ase_tpu_torch.learning import checkpoint as tckpt
from ase_tpu_torch.physics import dynamics as td
from ase_tpu_torch.physics import mjcf as tm
from ase_tpu_torch.tools import accept_drive, eval_llc_skills, validate_ase, validate_learning
from tests.test_torch_env import f32_solver
from tests.test_torch_train_parts import _one_torch_thread, env_state_from_jax  # noqa: F401
from tests.test_torch_vec_env import AMPDraws

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(_ROOT, "scripts"))
LLC = os.path.join(_ROOT, "data/models/ase_llc_reallusion_sword_shield.ckpt.npz")
B = 4


def _rel_close(ref, got, rel, what):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    tol = rel * max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(ref - got).max())
    assert err <= tol, (what, err, tol)


# -- the fixed-latent rollout ---------------------------------------------------------

def test_fixed_latent_rollout_matches_reference():
    """3 deterministic steps of 4 envs pinned to the same latents on
    HumanoidAMP (the sweep's env), from the JAX env's initial state carried
    over, the reset passes fed the JAX key chain's draws: every accumulator
    to 1e-2 of its scale, the fall counts equal."""
    import eval_llc_skills as ref

    jenv, jagent = ref.build("HumanoidAMP", "humanoid_ase_sword_shield.yaml", B)
    tenv, tagent = eval_llc_skills.build("HumanoidAMP", "humanoid_ase_sword_shield.yaml", B,
                                         device="cpu")
    f32_solver(jenv)
    f32_solver(tenv)
    ts = jckpt.restore(LLC, jagent.init_train_state(jax.random.PRNGKey(0)), strict=False)
    tagent.restore(LLC)
    z = jnet.sample_latents(jax.random.PRNGKey(7), B, jagent._latent_dim)
    js = jenv.initial_state(jax.random.PRNGKey(1))
    tstate = env_state_from_jax(js, tenv.initial_state())
    draws = AMPDraws(jenv)
    draws.key = js.rng
    tenv._draw_reset = draws
    jout = ref.fixed_latent_rollout(jenv, jagent, ts, z, 3, None, env_state=js)
    _, tout = eval_llc_skills.fixed_latent_rollout(
        tenv, tagent, torch.as_tensor(np.asarray(z)), 3, env_state=tstate)
    assert set(jout) == set(tout)
    for k in jout:
        if k == "fall_count":
            np.testing.assert_array_equal(tout[k], np.asarray(jout[k]))
        else:
            _rel_close(jout[k], tout[k], 1e-2, k)
    assert float(np.abs(jout["disc_reward"]).max()) > 0


# -- the success functions and the summaries ---------------------------------------------

def test_success_functions_match_reference():
    """heading, location and reach on the same env-state arrays (about
    half of the envs within each threshold); strike defers to the env."""
    import accept_drive as ref

    rng = np.random.default_rng(0)
    n, nb = 64, 17
    arr = dict(rew=rng.uniform(0.4, 1.0, n), root_pos=rng.normal(scale=0.4, size=(n, 3)),
               body_pos=rng.normal(scale=0.25, size=(n, nb, 3)),
               tar_xy=rng.normal(scale=0.1, size=(n, 2)), tar=rng.normal(scale=0.1, size=(n, 3)))
    arr = {k: v.astype(np.float32) for k, v in arr.items()}

    def state(conv, task):
        tar = arr["tar_xy"] if task == "location" else arr["tar"]
        return types.SimpleNamespace(
            rew=conv(arr["rew"]), phys=types.SimpleNamespace(root_pos=conv(arr["root_pos"])),
            body_pos=conv(arr["body_pos"]), aux={"tar_pos": conv(tar)})

    env = types.SimpleNamespace(_reach_body_id=7)
    jf, tf = ref._success_fns(), accept_drive.success_fns()
    assert set(jf) == set(tf)
    for task in ("heading", "location", "reach"):
        want = np.asarray(jf[task](env)(state(jnp.asarray, task)))
        got = tf[task](env)(state(torch.as_tensor, task)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=task)
        assert 0 < want.sum() < n, task
    assert jf["strike"](env) is None and tf["strike"](env) is None


def _script_sweep_stats(disc, enc, vel, falls, envs, steps):
    """``scripts/eval_llc_skills.py:136-177``, on numpy arrays."""
    speed = np.linalg.norm(vel, axis=-1)
    d = vel[:, None, :] - vel[None, :, :]
    pair = np.sqrt((d ** 2).sum(-1))
    iu = np.triu_indices(envs, 1)

    def q(x):
        return {"mean": float(np.mean(x)), "p10": float(np.percentile(x, 10)),
                "p50": float(np.percentile(x, 50)), "p90": float(np.percentile(x, 90))}

    stable = speed < 5.0
    vs, ps = vel[stable], pair[np.ix_(stable, stable)]
    ius = np.triu_indices(int(stable.sum()), 1)
    return {
        "n_latents": envs, "steps": steps,
        "disc_reward": q(disc), "enc_reward": q(enc), "speed": q(speed),
        "vel_std_over_latents": [float(s) for s in vel.std(axis=0)],
        "mean_pairwise_vel_dist": float(pair[iu].mean()),
        "n_unstable_latents_speed_gt_5": int((~stable).sum()),
        "stable_vel_std_over_latents": [float(s) for s in vs.std(axis=0)],
        "stable_mean_pairwise_vel_dist": float(ps[ius].mean()),
        "fall_frac": float((falls > 0).mean()),
    }


def test_skill_stats_match_script_formulas():
    rng = np.random.default_rng(1)
    n = 32
    sweep = {"disc_reward": rng.uniform(0, 2, n).astype(np.float32),
             "enc_reward": rng.uniform(0, 1, n).astype(np.float32),
             "mean_vel": rng.normal(scale=3.0, size=(n, 2)).astype(np.float32),
             "fall_count": rng.integers(0, 2, n).astype(np.float32)}
    got = eval_llc_skills.sweep_stats(sweep, 16)
    assert 0 < got["n_unstable_latents_speed_gt_5"] < n
    assert got == _script_sweep_stats(sweep["disc_reward"], sweep["enc_reward"],
                                      sweep["mean_vel"], sweep["fall_count"], n, 16)
    start_z = rng.uniform(0.1, 0.9, n).astype(np.float32)
    tail = rng.uniform(0.2, 0.9, n).astype(np.float32)
    fallen0 = start_z < 0.5
    want = {"n_fall_states": int(fallen0.sum()), "recovery_steps": 16,
            "success_rate_tail_root_z_gt_0.65": float((tail > 0.65)[fallen0].mean()),
            "median_start_root_z": float(np.median(start_z[fallen0])),
            "median_tail_max_root_z": float(np.median(tail[fallen0]))}
    assert eval_llc_skills.getup_stats(start_z, {"tail_max_root_z": tail}, 16) == want


# -- the one-env helpers -------------------------------------------------------------------

def test_compute_humanoid_observations_matches_reference():
    rng = np.random.default_rng(2)
    n = 8
    q = rng.normal(size=(n, 4))
    args = [rng.normal(size=(n, 3)), q / np.linalg.norm(q, axis=-1, keepdims=True),
            rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), rng.normal(scale=0.5, size=(n, 31)),
            rng.normal(size=(n, 31)), rng.normal(size=(n, 6, 3))]
    args = [a.astype(np.float32) for a in args]
    offsets = (0, 3, 6, 9, 10, 13, 16, 17, 20, 21, 24, 27, 28, 31)
    for local, height in ((True, True), (False, False)):
        ref = jobs.compute_humanoid_observations(*map(jnp.asarray, args), local, height, offsets)
        got = tobs.compute_humanoid_observations(*map(torch.as_tensor, args), local, height,
                                                 offsets)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_load_dict_matches_reference(tmp_path):
    path = str(tmp_path / "ck.npz")
    np.savez(path, **{".a": np.arange(3.0), ".b['c']": np.ones((2, 2), np.float32)})
    for p in (path, path[:-4]):
        ref, got = jckpt.load_dict(p), tckpt.load_dict(p)
        assert sorted(ref) == sorted(got)
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k])


# -- each tool's main, end to end ------------------------------------------------------------

@pytest.fixture
def small_cfgs(monkeypatch):
    """The tools' configs with the AMP buffers cut to 256 rows and the
    training horizon to 4 steps."""
    load = tools.load_cfg

    def small(rel):
        cfg = load(rel)
        c = cfg.get("params", {}).get("config")
        if c is not None:
            for k in ("amp_obs_demo_buffer_size", "amp_replay_buffer_size"):
                if k in c:
                    c[k] = 256
            c["horizon_length"] = 4
        return cfg

    for mod in (eval_llc_skills, accept_drive, validate_learning, validate_ase):
        monkeypatch.setattr(mod, "load_cfg", small)


def _lying(n):
    """Fall poses for the getup env: the default pose on its back at
    0.25 m (in place of the env's 150-tick drop)."""
    m = tm.load_mjcf(tm.find_asset("", "mjcf/amp_humanoid_sword_shield.xml"), device="cpu")
    st = td.default_state(m, n)
    pos = st.root_pos.clone()
    pos[:, 2] = 0.25
    quat = torch.tensor([[np.sin(np.pi / 4), 0.0, 0.0, np.cos(np.pi / 4)]],
                        dtype=torch.float32).expand(n, 4)
    return st._replace(root_pos=pos, root_quat=quat.contiguous())


def test_eval_llc_skills_main(tmp_path, small_cfgs):
    out = str(tmp_path / "skills.json")
    stats = eval_llc_skills.main(["--envs", "4", "--steps", "3", "--getup-envs", "4",
                                  "--getup-steps", "3", "--out", out, "--device", "cpu"],
                                 fall_states=_lying(4))
    for k in ("disc_reward", "enc_reward", "speed", "mean_pairwise_vel_dist",
              "stable_mean_pairwise_vel_dist", "n_unstable_latents_speed_gt_5", "fall_frac",
              "getup"):
        assert k in stats, k
    assert stats["n_latents"] == 4
    g = stats["getup"]
    assert g["recovery_steps"] == 3 and g["n_fall_states"] == 4
    assert np.isfinite(g["median_tail_max_root_z"])
    with open(out) as f:
        doc = json.load(f)
    assert len(doc["per_latent"]["disc_reward"]) == 4
    assert len(doc["per_latent"]["mean_vel"]) == 4


def test_accept_drive_main(tmp_path, small_cfgs):
    out = str(tmp_path / "acc.json")
    summary = accept_drive.main(["--skip-bench", "--llc-steps", "2", "--hlc-steps", "1",
                                 "--num-envs", "2", "--max-chunks", "1", "--device", "cpu",
                                 "--out", out])
    assert set(summary) == {"bench_steps_per_sec", "vs_baseline", "llc_mean_return",
                            "llc_mean_length", "llc_episodes", "hlc"}
    assert set(summary["hlc"]) == {"heading", "location", "reach", "strike"}
    for short, s in summary["hlc"].items():
        assert set(s) == {"mean_return", "mean_length", "episodes", "success_rate",
                          "success_time_frac"}, short
    with open(out) as f:
        assert json.loads(f.readline()) == summary


def test_validate_learning_main(tmp_path, small_cfgs):
    out = str(tmp_path / "VALIDATION.md")
    history = validate_learning.main(["--epochs", "2", "--num-envs", "4", "--device", "cpu",
                                      "--out", out])
    assert [h["epoch"] for h in history] == [0, 1]
    for k in ("reward_mean", "disc_agent_acc", "disc_demo_acc", "game_length_mean", "kl"):
        assert np.isfinite(history[-1][k]), k
    text = open(out).read()
    assert "| 0 |" in text and "| 1 |" in text
    assert len(json.load(open(tmp_path / "validation_history.json"))) == 2


@pytest.mark.parametrize("mode", ["ase", "hrl"])
def test_validate_ase_main(tmp_path, small_cfgs, monkeypatch, mode):
    argv = ["--mode", mode, "--epochs", "1", "--num-envs", "4", "--horizon", "2",
            "--device", "cpu", "--out-dir", str(tmp_path)]
    if mode == "ase":
        # the getup env's fall states: poses on the ground, not the drop
        from ase_tpu_torch.envs.humanoid_amp_getup import HumanoidAMPGetup

        monkeypatch.setattr(HumanoidAMPGetup, "generate_fall_states",
                            lambda self: setattr(self, "_fall_states", _lying(4)))
    history = validate_ase.main(argv)
    assert len(history) == 1
    keys = (["disc_reward_mean", "enc_reward_mean", "game_length_mean", "reward_mean"]
            if mode == "ase" else ["reward_mean", "game_reward_mean", "game_length_mean"])
    for k in keys:
        assert k in history[0], k
    tag = "ase" if mode == "ase" else "hrl_heading"
    assert len(json.load(open(tmp_path / f"validation_{tag}_history.json"))) == 1
    assert "| 0 |" in open(tmp_path / "VALIDATION.md").read()
    if mode == "ase":
        saved = np.load(tmp_path / "validate_ase" / "llc.ckpt.npz")
        assert ".params['params']['mu']['kernel']" in saved.files
