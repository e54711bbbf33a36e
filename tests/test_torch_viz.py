"""The port's visualization (``ase_tpu_torch/viz/plotter.py``) and the
player's ``--save_video`` under the headless Agg backend: the four cases of
tests/test_viz.py, on the port. The plotter is the reference's numpy and
matplotlib code, so where both packages draw the same inputs their frames
are held equal pixel for pixel.
"""

import glob
import os

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ase_tpu.viz import plotter as jplotter  # noqa: E402
from ase_tpu_torch.viz import plotter as tplotter  # noqa: E402
from tests.test_env import MOTION, make_cfg  # noqa: E402
from tests.test_torch_train_parts import _one_torch_thread  # noqa: E402,F401

LLC = "data/models/ase_llc_reallusion_sword_shield.ckpt.npz"
HLC = "data/models/ase_hlc_heading_reallusion_sword_shield.ckpt.npz"
CLIP = "reallusion_sword_shield/RL_Avatar_Idle_Ready_Motion.npy"


def _gif_frames(path):
    from PIL import Image, ImageSequence

    with Image.open(path) as im:
        return [np.asarray(f.convert("RGB")) for f in ImageSequence.Iterator(im)]


def test_plot_skeleton_state_and_motion(tmp_path):
    from ase_tpu_torch.motion import motion_lib as ml

    tree, lr, rt, fps, _, _ = ml.load_motion_npy(MOTION)
    tplotter.plot_skeleton_state(tree, lr[0], rt[0], show=False)
    for name, plotter in (("ref", jplotter), ("port", tplotter)):
        plotter.plot_skeleton_motion(tree, lr[:5], rt[:5], fps=fps,
                                     save_path=str(tmp_path / f"{name}.gif"))
    out = tmp_path / "port.gif"
    assert out.exists() and out.stat().st_size > 0
    ref, got = _gif_frames(tmp_path / "ref.gif"), _gif_frames(out)
    assert len(got) == len(ref) == 5
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_plot_env_state_with_task_markers():
    """The heading task's markers on the port's env state (CPU tensors)."""
    from ase_tpu_torch.envs import parse_task

    cfg = make_cfg(tarSpeedMin=1.5, tarSpeedMax=1.6, headingChangeStepsMin=10,
                   headingChangeStepsMax=20, enableRandHeading=True,
                   enableTaskObs=True, stateInit="Default")
    env = parse_task("HumanoidHeading", cfg, device="cpu")
    state = env.initial_state()
    assert "tar_dir" in state.aux
    ax = tplotter.plot_env_state(env, state, env_id=0, show=False)
    # the marker layers were drawn: legend exists and quiver collections added
    assert ax.get_legend() is not None


def test_render_rollout_writes_video(tmp_path, monkeypatch):
    """Synthetic 4-frame rollout → mp4 (cv2) with marker overlays; the
    frames handed to the encoder are the reference's."""
    parents = [-1, 0, 1, 0]
    rng = np.random.default_rng(0)
    body_pos = rng.normal(size=(4, 4, 3)).astype(np.float32)
    body_pos[..., 2] += 1.0
    markers = {
        "tar_dir": np.tile(np.array([1.0, 0.0]), (4, 1)),
        "tar_pos": np.tile(np.array([0.5, 0.5, 0.9]), (4, 1)),
    }
    frames = {}
    for name, plotter in (("ref", jplotter), ("port", tplotter)):
        def keep(fr, fps, save_path, name=name):
            frames[name] = fr
            return save_path

        with monkeypatch.context() as m:
            m.setattr(plotter, "_write_video", keep)
            plotter.render_rollout(parents, body_pos, markers=markers, fps=10,
                                   save_path=str(tmp_path / "x.mp4"), title="test")
    assert len(frames["port"]) == len(frames["ref"]) == 4
    for a, b in zip(frames["ref"], frames["port"]):
        np.testing.assert_array_equal(a, b)
    out = str(tmp_path / "roll.mp4")
    written = tplotter.render_rollout(parents, body_pos, markers=markers, fps=10,
                                      save_path=out, title="test")
    assert os.path.exists(written) and os.path.getsize(written) > 0


def test_player_save_video_end_to_end(tmp_path, monkeypatch):
    """``python -m ase_tpu_torch.run --test --save_video`` on the shipped
    heading controller over the shipped LLC at 2 envs: the player keeps env
    0's body positions and heading markers after every decision and writes
    a video of them. The frames handed to the renderer are the player's own
    states, the last one its final state, bit for bit."""
    from ase_tpu_torch import run
    from ase_tpu_torch.viz import plotter

    seen, states = {}, []
    build = run.build_player

    def build_and_watch(argv, edit_cfg=None):
        player, cfg = build(argv, edit_cfg)
        step = player._policy_step

        def watched(env_state, roll):
            out = step(env_state, roll)
            states.append(out[0].body_pos[0].clone())
            return out

        player._policy_step = watched
        seen["player"] = player
        return player, cfg

    render = plotter.render_rollout

    def record(parents, body_pos, **kw):
        seen.update(parents=parents, body_pos=body_pos, **kw)
        return render(parents, body_pos, **kw)

    monkeypatch.setattr(run, "build_player", build_and_watch)
    monkeypatch.setattr(plotter, "render_rollout", record)
    out = str(tmp_path / "rollout.mp4")
    argv = ["--test", "--task", "HumanoidHeading", "--cfg_env", "humanoid_sword_shield_heading.yaml",
            "--cfg_train", "train/rlg/hrl_humanoid.yaml", "--motion_file", CLIP,
            "--llc_checkpoint", LLC, "--checkpoint", HLC, "--num_envs", "2",
            "--save_video", out, "--device", "cpu"]
    run.main(argv, num_steps=2, max_chunks=2)

    player = seen["player"]
    assert len(states) == 4 and seen["body_pos"].shape == (4, player.env.model.nb, 3)
    np.testing.assert_array_equal(seen["body_pos"], torch.stack(states).numpy())
    np.testing.assert_array_equal(seen["body_pos"][-1], player.env_state.body_pos[0].numpy())
    assert set(seen["markers"]) == {"tar_dir", "tar_facing_dir"}
    np.testing.assert_array_equal(seen["markers"]["tar_dir"][-1],
                                  player.env_state.aux["tar_dir"][0].numpy())
    assert seen["parents"] == player.env.model.parents
    assert seen["fps"] == pytest.approx(1.0 / player.env.dt)
    assert seen["title"] == player.agent.config["name"]
    produced = glob.glob(str(tmp_path / "rollout.*"))
    assert produced and os.path.getsize(produced[0]) > 0
