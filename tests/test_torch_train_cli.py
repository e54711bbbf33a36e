"""The port's training entry point on the CPU: ``python -m
ase_tpu_torch.run`` without ``--test`` trains (here an AMP agent on
HumanoidAMP, as tests/test_learning.py::test_amp_agent_trains does for the
reference), writes its checkpoint, resumes from it, and refuses what it
has not ported yet (HRL training: tests/test_torch_hrl_train.py; mixed
precision: tests/test_torch_mixed_precision.py)."""

import copy

import numpy as np
import pytest
import torch
import yaml

from ase_tpu_torch import run
from tests.test_learning import TRAIN_CFG
from tests.test_torch_train_parts import _one_torch_thread  # noqa: F401  (autouse)

CLIP = "data/motions/reallusion_sword_shield/RL_Avatar_Idle_Ready_Motion.npy"


def _argv(tmp_path, algo="amp", **config):
    cfg = copy.deepcopy(TRAIN_CFG)
    cfg["params"]["algo"]["name"] = algo
    cfg["params"]["config"].update(config)
    path = tmp_path / "train.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return ["--task", "HumanoidAMP", "--cfg_env", "humanoid_sword_shield.yaml",
            "--cfg_train", str(path), "--motion_file", CLIP, "--num_envs", "4",
            "--max_iterations", "2", "--seed", "3", "--output_path", str(tmp_path / "out")]


def _run_keep_agent(argv):
    """run.main(argv), and the agent it built."""
    seen = []
    build = run.build_agent

    def keep(argv):
        out = build(argv)
        seen.append(out[0])
        return out

    run.build_agent = keep
    try:
        env_state, record = run.main(argv)
    finally:
        run.build_agent = build
    return seen[0], env_state, record


def test_amp_agent_trains_through_the_cli(tmp_path, capsys):
    """Two AMP epochs through run.main on the CPU: finite losses and
    weights, a filled demo buffer, the epoch lines and the final
    checkpoint under --output_path."""
    agent, env_state, record = _run_keep_agent(_argv(tmp_path) + ["--device", "cpu"])
    assert type(agent).__name__ == "AMPAgent" and agent.epoch == 2
    for k in ("a_loss", "c_loss", "disc_loss", "kl", "disc_reward_mean"):
        assert np.isfinite(record["metrics"][k]), k
    assert all(bool(torch.isfinite(p).all()) for p in agent.network.parameters())
    assert int(agent.demo_buffer.total_count) >= 256
    assert int(agent.replay_buffer.total_count) == 2 * 16     # two epochs of 4 x 4 rows
    assert bool(torch.isfinite(env_state.obs).all())
    out = capsys.readouterr().out
    assert "epoch 1 fps:" in out
    saved = np.load(tmp_path / "out" / "test.ckpt.npz")
    assert int(saved[".epoch"]) == 2 and ".params['params']['mu']['kernel']" in saved.files
    assert (tmp_path / "out" / "summaries").is_dir()


def test_cli_resumes_a_run(tmp_path, capsys):
    """--resume 1 --checkpoint <the run's checkpoint> --max_iterations 3
    takes the whole train state back and trains epoch 2 only."""
    first, _, _ = _run_keep_agent(_argv(tmp_path) + ["--device", "cpu"])
    path = str(tmp_path / "out" / "test.ckpt.npz")
    argv = _argv(tmp_path) + ["--device", "cpu", "--resume", "1", "--checkpoint", path,
                              "--max_iterations", "3", "--bench"]
    capsys.readouterr()
    agent, _, record = _run_keep_agent(argv)
    out = capsys.readouterr().out
    assert f"resumed from {path} at epoch 2" in out
    assert "epoch 2 fps:" in out and "epoch 1 fps:" not in out
    assert agent.epoch == 3 and record["epoch"] == 2
    assert int(agent.replay_buffer.total_count) == 16     # the buffers are not checkpointed
    assert int(np.load(path)[".epoch"]) == 3              # --bench: no writer, the final save


def test_cli_refuses_what_is_not_ported(tmp_path):
    argv = _argv(tmp_path)
    # --save_video is ported: the player renders with it (tests/test_torch_viz.py),
    # and training ignores it, as the reference's run.py does
    _, args, _ = run.build_agent(argv + ["--save_video", "x.mp4", "--device", "cpu"])
    assert args.save_video == "x.mp4" and not args.test
    # data-parallel training is ported: outside torchrun its flags name it
    for flag in ("--multi_gpu", "--horovod", "--multi_host"):
        with pytest.raises(RuntimeError, match="torchrun"):
            run.build_agent(argv + [flag, "--device", "cpu"])
    # an HRL agent trains over a low-level controller, which it must be given
    with pytest.raises(ValueError, match="--llc_checkpoint"):
        run.build_agent(["--task", "HumanoidStrike", "--cfg_env", "humanoid_sword_shield_strike.yaml",
                         "--cfg_train", "train/rlg/hrl_humanoid.yaml"] + argv[6:] + ["--device", "cpu"])
    # mixed precision is ported: the agent builds with a bf16 network
    # (tests/test_torch_mixed_precision.py trains and resumes one)
    agent, _, _ = run.build_agent(_argv(tmp_path, mixed_precision=True) + ["--device", "cpu"])
    assert agent.network.mu.compute_dtype == torch.bfloat16
    if not torch.cuda.is_available():     # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.build_agent(argv)
