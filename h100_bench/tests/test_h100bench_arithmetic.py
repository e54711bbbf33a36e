"""The FLOP and byte arithmetic of ``mfu`` and the rooflines, held to
counts made by hand."""

import pytest

from h100_bench import cells, flops

DIMS = {"obs": 253, "amp_obs": 1400, "actions": 31, "latent": 64}
WIDTHS = {"mlp": [1024, 1024, 512], "disc": [1024, 1024, 512], "style": [512, 256]}


def test_mlp_macs_by_hand():
    assert flops.mlp_macs(10, [4, 3], 2) == 10 * 4 + 4 * 3 + 3 * 2
    assert flops.mlp_macs(10, [4]) == 40


def test_ase_parts_by_hand():
    p = flops.ase_parts(DIMS, WIDTHS)
    style = 64 * 512 + 512 * 256 + 256 * 64
    trunk = (253 + 64) * 1024 + 1024 * 1024 + 1024 * 512
    assert p["actor"] == style + trunk + 512 * 31
    assert p["critic"] == trunk + 512
    disc_trunk = 1400 * 1024 + 1024 * 1024 + 1024 * 512
    assert p["disc"] == disc_trunk + 512
    assert p["enc"] == disc_trunk + 512 * 64


def test_train_epoch_flops_by_hand():
    p = flops.ase_parts(DIMS, WIDTHS)
    T, B, n, na, M = 32, 4096, 16384, 4096, 48
    want = 2 * (T * B * (p["actor"] + 2 * p["critic"]) + T * B * (p["disc"] + p["enc"])
                + M * (3 * n * (2 * p["actor"] + p["critic"]) + 3 * 2 * na * p["disc"]
                       + 6 * na * p["disc"] + 3 * na * p["enc"]))
    got = flops.train_epoch_flops(DIMS, WIDTHS, {"horizon": T, "envs": B, "minibatch": n,
                                                 "amp_minibatch": na, "minibatches": M})
    assert got == pytest.approx(want)


def test_hrl_decision_flops_by_hand():
    dims = dict(DIMS, hlc_obs=258)
    p = flops.ase_parts(dims, WIDTHS)
    hlc = 258 * 1024 + 1024 * 512 + 512 * 64
    got = flops.hrl_decision_flops(dims, WIDTHS, [1024, 512], 4096, 5)
    assert got == pytest.approx(2 * 4096 * (hlc + 5 * (p["actor"] + p["disc"])))


def test_chol_work_by_hand():
    n, m, m2, B = 37, 72, 1, 4096
    b, f = flops.chol_work("chol_forward2", n, m, m2, B)
    assert b == 4 * B * (703 + 1369 + 2 * 37 * 73)
    assert f == pytest.approx(B * (37 ** 3 / 3 + 1369 * 73))
    b, f = flops.chol_work("back_solve", n, 1, 0, B)
    assert b == 4 * B * (703 + 2 * 37) and f == B * 1369
    # memory-bound at these shapes: the bound is bytes over 3.35 TB/s
    assert flops.chol_bound_s("chol_forward2", n, m, m2, B) == pytest.approx(
        4 * B * (703 + 1369 + 2 * 37 * 73) / 3.35e12)


def test_roofline_and_mfu_readers():
    calls = [("chol_forward2", 37, 72, 1, 4096)] * 4 + [("back_solve", 37, 1, 0, 4096)] * 4
    bound = flops.chol_bound_s("chol_forward2", 37, 72, 1, 4096)
    rec = {"mode": "play", "trace": {
        "chol_calls": calls,
        "kernel_s": {"void chol_forward_kernel<37>(...)": 4 * 2 * bound,
                     "void back_solve_kernel(...)": 1e-5},
        "kernel_n": {"void chol_forward_kernel<37>(...)": 4, "void back_solve_kernel(...)": 3}}}
    assert cells.metric_reader("chol_forward2_roofline.play")(rec) == pytest.approx(50.0)
    bs = cells.metric_reader("back_solve_roofline.play")(rec)
    assert bs == pytest.approx(100 * 4 * flops.chol_bound_s("back_solve", 37, 1, 0, 4096)
                               / (1e-5 * 4 / 3))
    mfu = cells.metric_reader("mfu.play")
    assert mfu({"mode": "play", "flops": {"per_control_step": 67e12},
                "window": {"control_steps": 3, "wall_s": 300.0}}) == pytest.approx(1.0)
    assert cells.metric_reader("idle_share.play")(
        {"mode": "play", "trace": {"busy_s": 0.25, "window_s": 1.0}}) == pytest.approx(75.0)


@pytest.mark.parametrize("name,mode", [("env_steps_per_s.train", "train"),
                                       ("env_steps_per_s.play", "play")])
def test_rate_readers(name, mode):
    read = cells.metric_reader(name)
    window = {"control_steps": 64, "wall_s": 20.0}
    assert read({"mode": mode, "envs": 4096, "window": window}) == pytest.approx(4096 * 64 / 20)
    other = "play" if mode == "train" else "train"
    assert read({"mode": other, "envs": 4096, "window": window}) is None
    assert read({"mode": mode, "envs": 4096, "window": dict(window, wall_s=0.0)}) is None
