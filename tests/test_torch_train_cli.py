"""The port's training entry point on the CPU: ``python -m
ase_tpu_torch.run`` without ``--test`` trains (here an AMP agent on
HumanoidAMP, as tests/test_learning.py::test_amp_agent_trains does for the
reference), and refuses what it has not ported yet."""

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
            "--max_iterations", "2", "--seed", "3"]


def test_amp_agent_trains_through_the_cli(tmp_path, capsys):
    """Two AMP epochs through run.main on the CPU: finite losses and
    weights, a filled demo buffer, and the epoch lines."""
    seen = []
    build = run.build_agent

    def keep(argv):
        out = build(argv)
        seen.append(out[0])
        return out

    run.build_agent = keep
    try:
        env_state, record = run.main(_argv(tmp_path) + ["--device", "cpu"])
    finally:
        run.build_agent = build
    agent = seen[0]
    assert type(agent).__name__ == "AMPAgent" and agent.epoch == 2
    for k in ("a_loss", "c_loss", "disc_loss", "kl", "disc_reward_mean"):
        assert np.isfinite(record["metrics"][k]), k
    assert all(bool(torch.isfinite(p).all()) for p in agent.network.parameters())
    assert int(agent.demo_buffer.total_count) >= 256
    assert int(agent.replay_buffer.total_count) == 2 * 16     # two epochs of 4 x 4 rows
    assert bool(torch.isfinite(env_state.obs).all())
    out = capsys.readouterr().out
    assert "no checkpoint is written" in out and "epoch 1 fps:" in out


def test_cli_refuses_what_is_not_ported(tmp_path):
    argv = _argv(tmp_path)
    for flag in (["--resume", "1"], ["--multi_gpu"], ["--horovod"]):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            run.build_agent(argv + flag + ["--device", "cpu"])
    with pytest.raises(NotImplementedError, match="mixed_precision"):
        run.build_agent(_argv(tmp_path, mixed_precision=True) + ["--device", "cpu"])
    if not torch.cuda.is_available():     # the card is the default device
        with pytest.raises(RuntimeError, match="no CUDA device"):
            run.build_agent(argv)
