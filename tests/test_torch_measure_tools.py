"""The port's measurement tools on the CPU: ``tools.trace_summary`` on a
synthetic Chrome trace (exact sums) and on a CPU profile (no device time),
``tools.profile_epoch``'s window and whole-epoch trace at toy size, the
``ASE_TPU_PROFILE`` hook of the training loop, ``tools.profile_tick``'s
stage timing, and ``tools.contact_stats``: its per-env count of active
contacts held exactly against the reference's expression
(``scripts/contact_stats.py``, over ``engine._fk`` and
``engine._detect_contacts``) on states carried over from ``ase_tpu``'s
getup env, and its ``main`` at 4 envs x 3 steps."""

import copy
import glob
import gzip
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ase_tpu.envs import parse_task as jparse
from ase_tpu.physics import engine as jengine
from ase_tpu_torch.envs import parse_task as tparse
from ase_tpu_torch.tools import contact_stats, profile_epoch, profile_tick, trace_summary
from tests.test_torch_env import getup_cfg, to_jax_state
from tests.test_torch_train_cli import _argv, _run_keep_agent
from tests.test_torch_train_parts import _one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_train_parts import ase_train_cfg, env_state_from_jax

CLIP = "data/motions/reallusion_sword_shield/RL_Avatar_Idle_Ready_Motion.npy"


# -- trace_summary ------------------------------------------------------------------------

def _x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


KERNELS = [   # (name, bucket, ts, dur) in us
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize64x64x8", "matmul", 100.0, 30.0),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather/scatter", 140.0, 10.0),
    ("void at::cuda::cub::DeviceRadixSortOnesweepKernel", "sort", 160.0, 5.0),
    ("void chol_forward_kernel<37>(float const*, ...)", "custom", 170.0, 80.0),
    ("void back_solve_kernel<37>(float const*, ...)", "custom", 260.0, 6.0),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>", "elementwise", 270.0, 2.0),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>", "elementwise", 280.0, 2.0),
    ("void at::native::reduce_kernel<512, 1>", "reduce", 290.0, 4.0),
    ("void at::native::CatArrayBatchedCopy<float>", "copies", 300.0, 3.0),
    ("my_unnamed_kernel", "other", 310.0, 1.0),
]


def _synthetic_trace():
    ev = [{"ph": "M", "name": "process_name", "pid": 1, "args": {"name": "python"}},
          _x("aten::add", "cpu_op", 10.0, 500.0),              # host ops are not device time
          _x("cudaLaunchKernel", "cuda_runtime", 50.0, 4.0),
          _x("cudaLaunchKernel", "cuda_runtime", 60.0, 4.0),
          _x("cudaMemcpyAsync", "cuda_runtime", 70.0, 4.0),    # not a launch call
          _x("cuLaunchKernel", "cuda_driver", 80.0, 4.0),
          _x("Optimizer.step#Adam.step", "gpu_user_annotation", 0.0, 900.0),   # a range, no work
          _x("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 320.0, 8.0)]
    ev += [_x(n, "kernel", ts, dur) for n, _, ts, dur in KERNELS]
    return {"traceEvents": ev}


def _write(path, data):
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "wt") as f:
        json.dump(data, f)
    return str(path)


@pytest.mark.parametrize("name", ["t.pt.trace.json", "t.pt.trace.json.gz"])
def test_trace_summary_sums_a_synthetic_trace_exactly(tmp_path, name):
    path = _write(tmp_path / name, _synthetic_trace())
    s = trace_summary.summarize(path)
    busy_us = sum(d for *_, d in KERNELS) + 8.0
    assert s["device_time"] == "recorded"
    assert s["busy_ms"] == pytest.approx(busy_us / 1e3, abs=1e-12)
    # the span runs from the first launch call (50) to the memcpy's end (328)
    assert s["span_ms"] == pytest.approx((328.0 - 50.0) / 1e3, abs=1e-12)
    assert s["busy_share"] == pytest.approx(busy_us / (328.0 - 50.0), abs=1e-12)
    assert s["launches"] == len(KERNELS) and s["launch_calls"] == 3
    want = {}
    for _, b, _, d in KERNELS:
        want[b] = want.get(b, 0.0) + d / 1e3
    want["copies"] += 8.0 / 1e3
    assert s["buckets"].keys() == want.keys()
    for b, ms in want.items():
        assert s["buckets"][b] == pytest.approx(ms, abs=1e-12), b
    assert s["top"][0] == {"name": KERNELS[3][0], "ms": pytest.approx(0.08), "count": 1}
    add = [t for t in s["top"] if "AddFunctor" in t["name"]]
    assert add == [{"name": KERNELS[5][0], "ms": pytest.approx(0.004), "count": 2}]
    assert s["distinct"] == len(KERNELS)     # the two AddFunctor launches share a name
    # --like keeps the matching device names only; the newest trace of a directory is read
    chol = trace_summary.summarize(path, like="chol|back_solve")
    assert chol["launches"] == 2 and chol["buckets"] == {"custom": pytest.approx(0.086)}
    out = trace_summary.main([str(tmp_path), "--top", "3"])
    assert out["trace"] == path and len(out["top"]) == 3 and out["busy_ms"] == s["busy_ms"]
    assert trace_summary.bucket_of("Memcpy HtoD (Pageable -> Device)") == "copies"


def test_trace_summary_reports_no_device_time_on_a_cpu_profile(tmp_path, capsys):
    from torch.profiler import ProfilerActivity, profile

    def cpu_profile():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            x = torch.randn(64, 64)
            (x @ x + 1).sum()
        return prof

    path = str(tmp_path / "cpu.pt.trace.json")
    cpu_profile().export_chrome_trace(path)    # a profiler writes its trace once
    for s in (trace_summary.summarize(cpu_profile()), trace_summary.summarize(path)):
        assert s == {"launch_calls": 0, "device_time": trace_summary.NO_DEVICE_TIME}
    trace_summary.main([path])
    assert "no device time recorded" in capsys.readouterr().out


# -- profile_epoch and the ASE_TPU_PROFILE hook -------------------------------------------

def test_profile_epoch_window_on_the_cpu(tmp_path, monkeypatch):
    """bench.py's workload at 4 envs x horizon 2, narrow widths and one
    clip: the untraced epoch's numbers, then the window's two traces."""
    cfg = tmp_path / "ase.yaml"
    cfg.write_text(yaml.safe_dump(ase_train_cfg()))
    argv = list(profile_epoch.BENCH_ARGV)
    argv[argv.index("--cfg_train") + 1] = str(cfg)
    argv[argv.index("--motion_file") + 1] = CLIP
    monkeypatch.setattr(profile_epoch, "BENCH_ARGV", argv)
    out = profile_epoch.main(["--num_envs", "4", "--horizon", "2", "--float32",
                              "--control-steps", "2", "--minibatches", "1",
                              "--out-dir", str(tmp_path / "traces"), "--device", "cpu"])
    assert out["device"] == "cpu" and out["precision"] == "float32"
    for k in ("epoch_wall_s", "rollout_s", "update_s", "env_steps_per_s"):
        assert math.isfinite(out[k]) and out[k] > 0, k
    assert out["traced"].keys() == {"rollout", "update"}
    for part, s in out["traced"].items():
        assert s["device_time"] == trace_summary.NO_DEVICE_TIME and "busy_share" not in s
        assert math.isfinite(s["wall_ms"]) and s["wall_ms"] > 0
        assert s["trace"].endswith(f"_{part}.pt.trace.json.gz")
        with gzip.open(s["trace"], "rt") as f:
            assert json.load(f)["traceEvents"]


def test_profile_hook_traces_the_one_epoch_asked_for(tmp_path, monkeypatch):
    """ASE_TPU_PROFILE=0 traces epoch 0 of a two-epoch CLI run into
    <output>/profile/; unset, no profiler runs and nothing is written.
    ``profile_epoch.trace_epoch`` traces one more whole epoch."""
    monkeypatch.setenv("ASE_TPU_PROFILE", "0")
    for side in ("on", "off"):
        (tmp_path / side).mkdir()
    short = ["--device", "cpu", "--bench", "--horizon_length", "2"]
    agent, env_state, _ = _run_keep_agent(_argv(tmp_path / "on") + short)
    traces = glob.glob(str(tmp_path / "on" / "out" / "profile" / "*.json*"))
    assert [p.rsplit("/", 1)[1] for p in traces] == ["epoch0_rank0.pt.trace.json.gz"]
    with gzip.open(traces[0], "rt") as f:
        assert json.load(f)["traceEvents"]

    _, out = profile_epoch.trace_epoch(agent, env_state, str(tmp_path / "whole"))
    s = out["epoch"]
    assert s["device_time"] == trace_summary.NO_DEVICE_TIME and agent.epoch == 3
    assert glob.glob(str(tmp_path / "whole" / "*_epoch.pt.trace.json.gz")) == [s["trace"]]

    monkeypatch.delenv("ASE_TPU_PROFILE")
    _run_keep_agent(_argv(tmp_path / "off") + short + ["--max_iterations", "1"])
    assert (tmp_path / "off" / "out").is_dir()
    assert not (tmp_path / "off" / "out" / "profile").exists()


# -- profile_tick ------------------------------------------------------------------------

def test_profile_tick_times_the_parts_on_the_cpu():
    out = profile_tick.main(["--envs", "4", "--reps", "1", "--device", "cpu"])
    assert out["device"] == "cpu" and out["envs"] == 4
    assert out["parts"].keys() == {"fk", "collision", "dynamics", "contact_solve"}
    assert [p["calls_per_tick"] for p in out["parts"].values()] == [3, 1, 2, 2]
    for r in list(out["parts"].values()) + [out[k] for k in ("tick", "control_step",
                                                            "reset_done")]:
        assert math.isfinite(r["ms"]) and r["ms"] > 0 and r["launches"] is None
    assert math.isfinite(out["parts_over_tick"]) and out["parts_over_tick"] > 0


# -- contact_stats -----------------------------------------------------------------------

def test_contact_count_matches_the_reference(monkeypatch):
    """The port's ``active_contacts`` equals the reference's expression env
    by env at maxContacts 64: on ase_tpu's initial getup state carried into
    the port, then on the port env's states after each of four control
    steps of random actions, carried back (ase_tpu's eager step takes ~25 s
    on the CPU; its jitted one a compile per test run)."""
    monkeypatch.delenv("ASE_TPU_MAX_CONTACTS", raising=False)
    cfg = getup_cfg(maxContacts=64)
    jenv = jparse("HumanoidAMPGetup", copy.deepcopy(cfg))
    tenv = tparse("HumanoidAMPGetup", copy.deepcopy(cfg), device="cpu")
    assert jenv.sim_cfg.max_contacts == tenv.sim_cfg.max_contacts == 64
    fall = tenv.default_phys_state(tenv.num_envs)
    tenv._fall_states, jenv._fall_states = fall, to_jax_state(fall)
    margin = jenv.sim_cfg.solver.contact_offset

    def reference(phys):
        kin = jengine._fk(jenv.model, phys)
        c = jengine._detect_contacts(jenv.model, jenv.sim_cfg, jenv._tables, phys, kin,
                                     jnp.ones(jenv.num_envs))
        n_ok = jnp.abs(jnp.sum(jnp.square(c.normal), axis=-1) - 1.0) < 0.1
        return np.asarray(jnp.sum((c.depth > -margin) & n_ok, axis=1))

    js = jenv.initial_state(jax.random.PRNGKey(0))
    ts = env_state_from_jax(js, tenv.initial_state())
    gen = torch.Generator().manual_seed(0)
    seen = []
    for step in range(5):
        if step:
            a = torch.rand(tenv.num_envs, tenv.get_action_size(), generator=gen) * 2 - 1
            ts = tenv.step(tenv.reset_done(ts), a)
        ref = reference(to_jax_state(ts.phys))
        np.testing.assert_array_equal(contact_stats.active_contacts(tenv, ts.phys).numpy(), ref)
        seen.append(ref)
    assert np.concatenate(seen).max() > 0          # some contacts were counted


def test_contact_stats_main_on_the_cpu():
    out = contact_stats.main(["--envs", "4", "--steps", "3", "--device", "cpu"])
    assert out["samples"] == 12 and out["max_contacts"] == 64
    q = [out["quantiles"][f"p{p:g}"] for p in contact_stats.QUANTILES] + [out["max"]]
    assert all(math.isfinite(v) for v in q) and q == sorted(q) and q[-1] <= 64
    p = [out["overflow"][str(k)] for k in contact_stats.BUDGETS]
    assert p == sorted(p, reverse=True) and all(0.0 <= v <= 1.0 for v in p)
    s = contact_stats.stats(np.array([0, 1, 13, 13, 17, 25, 40]))
    assert s["quantiles"]["p50"] == 13.0 and s["max"] == 40
    assert s["overflow"] == {"12": 5 / 7, "16": 3 / 7, "20": 2 / 7, "24": 2 / 7, "32": 1 / 7}
