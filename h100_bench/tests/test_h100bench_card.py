"""On the card: the control (the program with TF32 products on, the
precision below the configuration's float32) comes out not correct at a
size a test run holds. Skips without a card."""

import pytest
import torch

from h100_bench import run


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ase_llc.train", "hrl_heading.play", "ase_llc.play"])
def test_tf32_control_fails(cell, tiny):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control's TF32 products exist only there")
    small = dict(tiny, traffic=dict(tiny["traffic"], envs=256))
    r = run.run_cell(cell, 2 ** 31 + 7, 0.0 if cell.endswith("train") else 2.0, False,
                     device="cuda", overrides=small, control="tf32")
    assert not r["correct"], r["check"]
