"""Run one cell of the benchmark once and print its result line.

    python3 -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's program objects through ``ase_tpu_torch.run``,
times each stage after a sync (build, fall-state drop, train state,
initial reset, warm-up), snapshots what the correctness check follows, and
warms up every shape the window uses. The window then measures for
``--seconds``; ``nvidia-smi`` reads the card's clocks and power just before
and just after it. With ``--trace 0`` the line's metrics are the cell's end-to-end ones;
with ``--trace 1`` the window also counts reset passes and times each
player step with CUDA events, a short traced window follows under
``torch.profiler``, and the line's metrics are the per-layer ones, each
read from the run's record by ``metrics/<metric>.py``.

After the window the program's objects are freed and the plain reference
(``reference/``) redoes every checked point; each number compared is
printed beside its limit as the last lines of standard error and under
``check``, the result line's last key. The run exits non-zero and prints no
result when the card is missing, when ``jax``, ``jaxlib``, ``flax`` or
``ase_tpu`` is loaded in the process, or when the cell cannot run.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from typing import Any, Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "ase_tpu")


class NoResult(Exception):
    """The run cannot give a result; the message says why."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> List[str]:
    """The loaded modules whose whole top-level name is forbidden."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def smi_sample() -> List[str]:
    """One ``nvidia-smi`` reading of the card's clocks, power and limit
    (taken just before and just after the window, so that no second
    process runs beside it)."""
    query = "name,clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [line for line in out.splitlines() if line.strip()]


def power_limit_w(lines: List[str]) -> Optional[float]:
    for line in lines:
        try:
            return float(line.split(",")[4].strip().split()[0])
        except (IndexError, ValueError):
            continue
    return None


def _timed(stages: Dict[str, float], name: str, device, fn):
    from h100_bench.program import sync

    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    stages[name] = time.perf_counter() - t0
    return out


def _dims(built) -> Dict[str, int]:
    env, agent = built.env, built.agent
    dims = {"obs": env.get_obs_size(), "amp_obs": env.amp_obs_size(),
            "actions": env.get_action_size(),
            "latent": int(getattr(agent, "_latent_dim", 0))}
    if hasattr(agent, "_llc_obs_dim"):
        dims["hlc_obs"] = dims["obs"]
        dims["obs"] = int(agent._llc_obs_dim)
    return dims


def _widths(built, conf) -> Dict[str, Any]:
    import yaml

    net = built.cfg_train["params"]["network"]
    sizes = conf.get("sizes", {})
    if "llc_config" in built.cfg_train["params"]["config"]:
        from h100_bench.program import _repo_path

        with open(_repo_path(built.cfg_train["params"]["config"]["llc_config"])) as f:
            llc = yaml.safe_load(f)["params"]["network"]
        return {"mlp": llc["mlp"]["units"], "disc": llc["disc"]["units"],
                "style": sizes.get("llc_style_units", [512, 256]),
                "hlc": net["mlp"]["units"]}
    return {"mlp": net["mlp"]["units"], "disc": net["disc"]["units"],
            "style": sizes.get("style_units", [512, 256])}


def _flops(built, conf, mode: str) -> Dict[str, float]:
    from h100_bench import flops

    dims, widths = _dims(built), _widths(built, conf)
    B = built.env.num_envs
    if mode == "train":
        a = built.agent
        return {"per_epoch": flops.train_epoch_flops(dims, widths, {
            "horizon": a.horizon_length, "envs": B, "minibatch": a.minibatch_size,
            "amp_minibatch": a._amp_minibatch_size,
            "minibatches": a.mini_epochs * a.num_minibatches})}
    if "hlc" in widths:
        k = int(built.agent._llc_steps)
        return {"per_control_step": flops.hrl_decision_flops(dims, widths, widths["hlc"], B, k) / k}
    return {"per_control_step": flops.play_step_flops(dims, widths, B)}


def _traced_window(built, traffic, state, roll, device):
    """A short window under torch.profiler with the layer spans on: a few
    player steps, or the last control steps of one epoch and its update.
    Returns (state, roll, the timeline, the Cholesky calls, the control
    steps traced)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from h100_bench import program
    from h100_bench.tracing import spans, timeline

    K = int(traffic.get("trace_steps", 1))
    patches = spans.Patches()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    agent, env = built.agent, built.env
    with spans.layer_spans(env, agent):
        calls = program.record_chol_calls(patches)
        try:
            if traffic["mode"] == "play":
                program.sync(device)
                prof.start()
                for _ in range(K):
                    with record_function("player.step"):
                        state, roll, _, _ = built.player._policy_step(state, roll)
                program.sync(device)
                prof.stop()
                steps = K * program.llc_steps(agent)
            else:
                step_span = spans.OpenSpan("rollout.step")
                seen = {"n": 0}
                T = agent.horizon_length

                def on_reset(fn):
                    def wrapper(s):
                        if seen["n"] == T - K:
                            program.sync(device)
                            prof.start()
                        if seen["n"] >= T - K:
                            step_span.restart()
                        seen["n"] += 1
                        return fn(s)
                    return wrapper

                def on_post(fn):
                    def wrapper(r):
                        step_span.close()
                        return fn(r)
                    return wrapper

                patches.wrap(env, "reset_done", on_reset)
                patches.wrap(agent, "_post_rollout", on_post)
                state, _ = agent.train_epoch(state)
                program.sync(device)
                prof.stop()
                steps = K
        finally:
            patches.undo()
    path = os.path.join(tempfile.gettempdir(), f"h100_bench_trace_{os.getpid()}.json")
    try:
        prof.export_chrome_trace(path)
        tl = timeline.read(path)
    finally:
        if os.path.exists(path):
            os.remove(path)
    return state, roll, tl, calls, steps


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             overrides: Optional[Dict[str, Any]] = None, control: Optional[str] = None,
             fault: Optional[str] = None, t_start: Optional[float] = None,
             need_card: bool = True, witness: bool = False) -> Dict[str, Any]:
    """One run of cell ``name``; returns the result line's object (and
    logs set-up, the card's samples and the numbers compared to standard
    error). ``control`` "tf32" runs the program with TF32 products on, the
    precision below the configuration's, and "plain_chol" with its plain
    Cholesky in place of the kernels; ``fault`` plants one of
    ``faults.FAULTS``; ``overrides`` lays config values over the cell's (the
    tests' small sizes); ``need_card`` False skips the look for a card;
    ``witness`` adds the play cells' float64 witness to the diagnostics.
    Every reading, compared or not, comes back under ``readings``."""
    import torch

    from h100_bench import cells, check, faults, program
    from h100_bench.program import to_host
    from h100_bench.tracing.spans import Patches

    t_start = T_START if t_start is None else t_start
    cell = cells.cell(name)
    conf = cell.config
    traffic = cells.merged(cell.traffic, (overrides or {}).get("traffic", {}))
    if need_card:
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: torch.cuda.is_available() is false")
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"{name} needs {cell.chips} cards, "
                           f"{torch.cuda.device_count()} visible")
    mode = traffic["mode"]
    stages: Dict[str, float] = {}
    dev = torch.device(device)
    built = _timed(stages, "build_s", dev, lambda: program.build(conf, traffic, seed, device,
                                                                 overrides))
    agent, env, dev = built.agent, built.env, built.device
    patches = Patches()
    if fault:
        faults.plant(fault, patches, agent, mode)
    if control == "tf32":
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    elif control == "plain_chol":
        from ase_tpu_torch.ops import chol

        patches.set(chol, "chol_forward", chol.chol_forward_plain)
        patches.set(chol, "back_solve", chol.back_solve_plain)
    elif control:
        raise ValueError(f"unknown control {control!r}")

    cap = program.Capture()
    if hasattr(env, "generate_fall_states"):
        _timed(stages, "fall_states_s", dev, env.generate_fall_states)
        cap.fall_states = program.snap(env._fall_states)
    if mode == "train":
        cap.demo_gens = program.gen_states(env, agent)
        _timed(stages, "train_state_s", dev, agent.init_train_state)
    cap.start_gens = program.gen_states(env, agent)
    state = _timed(stages, "initial_state_s", dev, env.initial_state)
    cap.start_state = program.outcome(state)
    if traffic.get("clock") == "stagger":
        state = program.stagger_clocks(env, state, seed)
    roll = None
    minibatches = int(traffic.get("check_minibatches", 3))
    if mode == "train":
        hooks = Patches()
        program.capture_epoch(hooks, agent, cap, minibatches)
        try:     # the first set-up epoch is the one the reference follows
            state, _ = _timed(stages, "warmup_s", dev, lambda: agent.train_epoch(state))
        finally:
            hooks.undo()
        for _ in range(int(traffic.get("warmup_epochs", 1)) - 1):
            state, _ = agent.train_epoch(state)
        cap.steps = to_host(cap.steps)
        cap.update = to_host(cap.update)
    else:
        roll = agent._init_rollout_carry()

        def warm():
            nonlocal state, roll
            steps = -(-int(traffic.get("warmup_control_steps", 8)) // program.llc_steps(agent))
            for _ in range(steps):
                state, roll, _, _ = built.player._policy_step(state, roll)
        _timed(stages, "warmup_s", dev, warm)
    program.sync(dev)
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    stages["setup_s"] = time.perf_counter() - t_start
    log("setup " + json.dumps({k: round(v, 4) for k, v in stages.items()}))

    # -- the window --------------------------------------------------------------
    counters = Patches()
    resets = program.count_resets(counters, env) if trace else None
    events = program.StepEvents(dev) if trace and mode == "play" else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    smi_lines = smi_sample() if dev.type == "cuda" else []
    k_steps = program.llc_steps(agent)
    try:
        if mode == "train":
            state, epochs, wall = program.train_window(agent, state, seconds, dev)
            env_steps = sum(agent.batch_size for _ in epochs)
            window = {"wall_s": wall, "epochs": len(epochs),
                      "control_steps": len(epochs) * agent.horizon_length}
        else:
            epochs = []
            rng = random.Random(int(seed))
            among = int(traffic.get("check_among", 8))
            chosen = set(rng.sample(range(among), min(int(traffic.get("check_steps", 2)), among)))

            def on_step(phase, i, st, rl, rewards=None, actions=None):
                if i not in chosen:
                    return
                if phase == "pre":
                    first = Patches()
                    cap.steps.append({"index": i, "state": program.snap(st),
                                      "roll": program.snap(rl),
                                      "gens": program.gen_states(env, agent),
                                      "out": program.first_step_outcome(first, env),
                                      "patch": first})
                else:
                    cap.steps[-1].pop("patch").undo()
                    cap.steps[-1].update(rewards=program.snap(rewards),
                                         actions=program.snap(actions))

            state, roll, steps, games, wall = program.play_window(
                built.player, state, roll, seconds, int(traffic.get("chunk", 16)), dev,
                on_step=on_step, events=events)
            env_steps = steps * k_steps * env.num_envs
            window = {"wall_s": wall, "player_steps": steps, "control_steps": steps * k_steps,
                      "games": games}
            if len(cap.steps) < len(chosen) or "actions" not in cap.steps[-1]:
                raise NoResult(f"the window ran {steps} steps, fewer than the checked ones")
    finally:
        counters.undo()
    smi_lines += smi_sample() if dev.type == "cuda" else []
    window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    memory_peak = max(setup_peak, window_peak)
    for line in smi_lines:
        log("nvidia-smi " + line)
    log("window " + json.dumps(window))

    e2e = {"setup_s": {"value": stages["setup_s"], "unit": "s"},
           "peak_mem_gib": {"value": window_peak / 2 ** 30, "unit": "GiB"}}
    rate = env_steps / window["wall_s"] if window["wall_s"] > 0 else 0.0
    e2e["train_env_steps_per_s" if mode == "train" else "play_env_steps_per_s"] = {
        "value": rate, "unit": "env-steps/s"}

    result: Dict[str, Any] = {}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    if trace:
        state, roll, tl, chol_calls, traced_steps = _traced_window(built, traffic, state, roll,
                                                                   dev)
        record = {
            "mode": mode, "envs": env.num_envs, "llc_steps": k_steps, "window": window,
            "epochs": epochs, "step_ms": [m / k_steps for m in events.ms()] if events else [],
            "resets": resets, "fall_states_s": stages.get("fall_states_s"),
            "trace": dict(tl, control_steps=traced_steps, chol_calls=chol_calls),
            "flops": _flops(built, conf, mode), "power_limit_w": power_limit_w(smi_lines),
        }
        log("resets " + json.dumps({"calls": len(resets["passes"]),
                                    "passes": resets["passes"], "flagged": resets["flagged"]}))
        log("step_ms " + json.dumps([round(m, 3) for m in record["step_ms"]]))
        metrics = {}
        for m in cell.per_layer:
            value = cells.metric_reader(m["name"])(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result_metrics = metrics
        device_info.update(busy_s=tl.get("busy_s", 0.0), window_s=tl.get("window_s", 0.0))
        breakdown = {"device_ops": [[n[:64], v] for n, v in tl.get("top", [])[:10]],
                     "idle_gaps": tl.get("idle_gaps", [])[:10]}
    else:
        result_metrics = {m["name"]: e2e[m["name"]] for m in cell.end_to_end if m["name"] in e2e}
        breakdown = None

    bad = forbidden_modules()
    if bad:
        raise NoResult(f"forbidden modules loaded: {', '.join(bad)}")

    # -- the comparison ----------------------------------------------------------------
    patches.undo()
    cfg, cfg_train, task = built.cfg, built.cfg_train, conf["task"]
    del built, agent, env, state, roll, patches
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from h100_bench.reference.follow import Reference

    t_check = time.perf_counter()
    ref = Reference(cfg, cfg_train, task, dev,
                    checkpoint=program._repo_path(conf["checkpoint"]) if mode == "play" else None)
    if mode == "train":
        readings, diag = check.train_numbers(ref, cap, minibatches, dev)
    else:
        readings, diag = check.play_numbers(ref, cap, dev, witness=witness)
    numbers, correct, failed = check.judge(readings, cell.limits)
    log("check_detail " + json.dumps(diag))
    log("check_readings " + json.dumps(readings))
    log(f"check took {time.perf_counter() - t_check:.2f} s")
    result.update(correct=correct, attempted=len(numbers), failed=len(failed),
                  metrics=result_metrics, device=device_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["readings"] = readings
    result["check"] = {k: {"value": v, "limit": cell.limits.get(k)} for k, v in numbers.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Run one cell of the H100 benchmark once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", default=None, help="tf32: the control run (not a benchmark run)")
    p.add_argument("--fault", default=None, help="plant a fault (not a benchmark run)")
    args = p.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          control=args.control, fault=args.fault)
    except NoResult as e:
        log(f"no result: {e}")
        return 2
    result.pop("readings")
    for k, v in result["check"].items():
        log(f"check {k} {v['value']!r} limit {v['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
