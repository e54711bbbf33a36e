"""A run driven end to end at a small size on the CPU (the look for a card
skipped) comes out correct on the program as it is, and not correct with
the timed path broken underneath: a step that returns its state
unchanged, half of the batch left out, an answer altered where it is
produced. (One card: no exchange between chips to leave out.)"""

import pytest

from h100_bench import faults, run

CELLS = ("ase_llc.train", "hrl_heading.play", "ase_llc.play")


def _run(cell, tiny, fault=None):
    seconds = 0.0 if cell.endswith("train") else 4.0
    return run.run_cell(cell, 2 ** 31 + 99, seconds, False, device="cpu", overrides=tiny,
                        need_card=False, fault=fault)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    r = _run(cell, tiny)
    assert r["correct"], r["check"]
    assert list(r)[-1] == "check"
    assert all(v["limit"] is not None for v in r["check"].values())


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, tiny):
    r = _run(cell, tiny, fault)
    assert not r["correct"], r["check"]
    assert r["failed"] >= 1


def test_the_witness_run_with_the_plain_cholesky_is_correct(tiny):
    """The tail's witness (the program's plain Cholesky in place of the
    kernels, the reference's float64 step beside it) runs and, with the
    program's code otherwise unchanged, compares correct."""
    from ase_tpu_torch.ops import chol

    kernel = chol.chol_forward
    r = run.run_cell("ase_llc.play", 2 ** 31 + 5, 4.0, False, device="cpu", overrides=tiny,
                     need_card=False, control="plain_chol", witness=True)
    assert r["correct"], r["check"]
    assert chol.chol_forward is kernel
