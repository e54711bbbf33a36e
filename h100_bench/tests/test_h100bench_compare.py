"""The comparison: numbers within their limits pass, a lower precision
than the configuration's (float32 rounded as TF32 or bfloat16 round it)
fails, and a gap in a minority of the envs shows in the tail readings."""

import math

import pytest
import torch

from h100_bench import cells, check


def _round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x`` rounded to ``bits`` explicit mantissa bits (TF32: 10)."""
    m, e = torch.frexp(x)
    scale = 2.0 ** (bits + 1)
    return torch.ldexp(torch.round(m * scale) / scale, e)


@pytest.fixture
def actions():
    g = torch.Generator().manual_seed(3)
    return torch.tanh(torch.randn(4096, 31, generator=g))


@pytest.mark.parametrize("cell", ["ase_llc.train", "hrl_heading.play", "ase_llc.play"])
@pytest.mark.parametrize("lower", ["tf32", "bf16"])
def test_lower_precision_fails(cell, lower, actions):
    limits = cells.limits(cell)
    low = _round_mantissa(actions, 10) if lower == "tf32" else actions.bfloat16().float()
    gap = check.act_gap(low, actions)
    assert gap > 0
    readings = {k: 0.0 for k in limits}
    readings["act_gap"] = gap
    _, ok, failed = check.judge(readings, limits)
    assert not ok and failed == ["act_gap"]


def test_equal_outputs_pass_and_missing_limits_fail(actions):
    assert check.act_gap(actions, actions.clone()) == 0.0
    assert check.judge({"act_gap": 0.0}, {"act_gap": 1e-6}) == ({"act_gap": 0.0}, True, [])
    assert check.judge({"obs_gap": 0.0}, {"act_gap": 1.0})[1:] == (False, ["act_gap"])
    assert check.judge({"act_gap": math.nan}, {"act_gap": 1.0})[1:] == (False, ["act_gap"])
    # a reading that no limit names is not compared
    assert check.judge({"act_gap": 0.0, "rew_gap": 5.0}, {"act_gap": 1.0})[0] == {"act_gap": 0.0}


def test_obs_gaps_are_quantiles_over_envs():
    ref = torch.zeros(100, 5)
    prog = ref.clone()
    prog[:10, 0] = 1.0          # a tail of 10% of the envs
    g = check.obs_gaps(prog, ref)
    assert g["p50"] == 0.0 and g["p99"] == 1.0 and g["p100"] == 1.0
    assert g["over_0.1"] == pytest.approx(10.0) and g["over_1"] == 0.0
    prog[:50, 1] = 2.0          # half of the envs
    g = check.obs_gaps(prog, ref)
    assert g["p50"] == pytest.approx(1.0) and g["over_0.1"] == pytest.approx(50.0)


@pytest.mark.parametrize("cell", ["ase_llc.train", "hrl_heading.play", "ase_llc.play"])
@pytest.mark.parametrize("share", [0.1, 0.5])
def test_a_gap_in_a_minority_of_the_envs_fails(cell, share):
    """A tenth (or a half) of 4096 envs off by 3 fails the cell's limits,
    where the median over the envs alone would pass a tenth."""
    ref = torch.zeros(4096, 223, dtype=torch.float64)
    prog = ref.clone()
    prog[:int(share * 4096), 7] = 3.0
    g = check.obs_gaps(prog, ref)
    readings = {"act_gap": 0.0, "done_mismatch": 0, "rew_gap": 0.0, "rew_p50": 0.0,
                "rew_p99": 0.0, "loss_gap": 0.0, "grad_gap": 0.0, "step_gap": 0.0,
                **check._worst([g], "obs")}
    _, ok, failed = check.judge(readings, cells.limits(cell))
    assert not ok
    assert any(k.startswith("obs_") and k != "obs_gap" for k in failed) or share == 0.5


def test_float64_cholesky_witness_solves_in_float64():
    """The witness's reference engine factors and solves in float64 and hands
    float32 back; outside the block the plain float32 versions return."""
    from h100_bench.reference.ase_ref.ops import chol

    g = torch.Generator().manual_seed(5)
    n, B = 6, 3
    A = torch.randn(B, n, n, generator=g, dtype=torch.float64)
    M64 = A @ A.mT + n * torch.eye(n, dtype=torch.float64)
    b64 = torch.randn(B, n, 1, generator=g, dtype=torch.float64)
    M = M64.permute(1, 2, 0).float().contiguous()
    b = b64.permute(1, 2, 0).float().contiguous()
    plain = chol.chol_forward
    with check.follow.float64_cholesky():
        L, y = chol.chol_forward(M, b)
        x = chol.back_solve(L, y)
    assert chol.chol_forward is plain and x.dtype == torch.float32
    exact = torch.linalg.solve(M.permute(2, 0, 1).double(), b.permute(2, 0, 1).double())
    assert torch.allclose(x.permute(2, 0, 1).double(), exact, atol=1e-6, rtol=1e-6)
