"""Settings of the benchmark's own tests (``python3 -m pytest h100_bench/tests``).

The ``cuda`` marker names tests that need the card; they decide inside the
test whether there is one and skip without. ``tiny`` gives the overrides
that shrink a cell to a size the CPU runs in seconds (8 envs, horizon 4,
small AMP buffers, a 2-tick fall drop, the window's first step checked, so
a window of one step on a busy CPU still holds it); the widths stay the
configuration's.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {
    "traffic": {"envs": 8, "check_steps": 1, "check_among": 1, "warmup_control_steps": 1},
    "env_cfg": {"env": {"resetChunk": 4}},
    "train_cfg": {"params": {"config": {
        "horizon_length": 4, "minibatch_size": 8, "mini_epochs": 1,
        "amp_obs_demo_buffer_size": 64, "amp_replay_buffer_size": 64,
        "amp_batch_size": 8, "amp_minibatch_size": 8}}},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (CUDA kernels); skips without one")


@pytest.fixture
def tiny(monkeypatch):
    """The small-size overrides, with the getup task's fall drop cut to 2 ticks."""
    import ase_tpu_torch.envs.humanoid_amp_getup as getup

    monkeypatch.setattr(getup, "FALL_TICKS", 2)
    return TINY
