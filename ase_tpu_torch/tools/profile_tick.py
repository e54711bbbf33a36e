"""Time the sim tick by part, the control step, the epoch's phases (port of scripts/profile_tick.py).

Tick mode (the default): HumanoidAMP on the getup config
(``humanoid_ase_sword_shield_getup.yaml``, the default clip,
self-collision on) at ``--envs`` (default ``PROF_NUM_ENVS`` or 4096) from
its initial state under zero actions. Timed, each after a warm-up call:

- the engine's stage functions, called in sequence on one state with the
  engine's arguments: ``dynamics2.fk_batched`` (substeps + 1 calls a
  tick), ``collision3.detect_batched`` (1), ``dynamics2.
  compute_dynamics_batch_last`` (substeps) and the contact step
  ``engine._zform_contact_step`` (``_aos_contact_step`` under PGS;
  substeps);
- the whole sim tick (``engine.step_batched``), the env's control step
  (``env.step``: controlFrequencyInv ticks, observations, reward, resets
  flagged) and ``env.reset_done``.

On the card each is the median of ``--reps`` calls timed with CUDA events,
and one more call runs under torch.profiler, summed by ``trace_summary``:
its kernel launches and device busy time. On the CPU each is timed with
``time.perf_counter`` and no launches are counted. ``--trace`` writes a
Chrome trace of 5 ticks under ``output/profile_tick/``.

``--epoch``: the rollout and update phases of bench.py's training epoch
(``profile_epoch.build_bench_agent``, bf16 unless ``--float32``), from
``train_epoch``'s own split, averaged over ``--epochs`` epochs after one
warm-up epoch.

    python -m ase_tpu_torch.tools.profile_tick [--envs 4096] [--reps 10] [--trace]
    python -m ase_tpu_torch.tools.profile_tick --epoch [--envs 4096] [--epochs 3]
"""

from __future__ import annotations

import argparse
import os
import statistics
import time

import torch

from ase_tpu_torch.tools import load_cfg, trace_summary
from ase_tpu_torch.utils import paths
from ase_tpu_torch.utils.profiling import profiled


def tick_parts(env, phys, tgt):
    """{part: (zero-argument call, calls per tick)}: the engine's stage
    functions on ``phys`` with PD targets (or torques) ``tgt``, each given
    the outputs of the stages before it, as ``engine.step_batched`` calls
    them without randomization."""
    from ase_tpu_torch.physics import collision3, dynamics2, engine

    model, cfg, T = env.model, env.sim_cfg, env._tables
    h = cfg.dt / cfg.substeps

    def fk():
        return dynamics2.fk_batched(model, T.dyn, phys)

    def collision():
        return collision3.detect_batched(T.detect, kin.body_quat, kin.body_pos, phys.prop_quat,
                                         phys.prop_pos, cfg.max_contacts,
                                         margin=cfg.solver.contact_offset)

    def dyn():
        return dynamics2.compute_dynamics_batch_last(model, T.dyn, phys, kin, T.diag,
                                                     diag_parts=T.diag_parts)

    kin = fk()
    contacts = collision()
    M_bl, bias, Phi = dyn()
    _, tau_full = engine._joint_torques(model, cfg, T, phys, tgt, h)
    u_free_prop = I_w = None
    if model.num_props:
        u_free_prop, I_w = engine._free_props(model, phys, h)
    step = engine._contact_step_fn(cfg)

    def contact_solve():
        return step(model, cfg, T, phys, contacts, M_bl, bias, Phi, tau_full, u_free_prop,
                    I_w, None)

    return {"fk": (fk, cfg.substeps + 1), "collision": (collision, 1),
            "dynamics": (dyn, cfg.substeps), "contact_solve": (contact_solve, cfg.substeps)}


def time_call(fn, device, reps: int, top: int = 10) -> dict:
    """``ms``, the median over ``reps`` calls of ``fn()`` after one warm-up
    call (CUDA events around each call on the card, ``time.perf_counter``
    on the CPU); on the card also one more call's ``trace_summary`` with its
    ``launches`` and ``busy_ms``."""
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return {"ms": statistics.median(times), "launches": None}
    torch.cuda.synchronize(device)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for e in ev[1:]:
        fn()
        e.record()
    torch.cuda.synchronize(device)
    _, prof, _ = profiled(fn, device)
    s = trace_summary.summarize(prof, top)
    return {"ms": statistics.median(a.elapsed_time(b) for a, b in zip(ev, ev[1:])),
            "launches": s.get("launches"), "busy_ms": s.get("busy_ms"), "summary": s}


def stage_times(env, state, actions, reps: int = 10, top: int = 10) -> dict:
    """The tick's parts, the whole tick, the control step and reset_done
    on ``env`` from ``state`` under ``actions`` (``time_call`` each). Each
    part also gets ``per_tick_ms`` and ``per_tick_launches`` (times its
    calls a tick); ``parts_over_tick`` is their sum over the tick's ms."""
    from ase_tpu_torch.physics import engine

    dev = env.device
    _, tgt = env.pre_physics_step(state, torch.clamp(actions, -1.0, 1.0))
    out = {"envs": env.num_envs, "reps": reps, "parts": {}}
    for name, (fn, calls) in tick_parts(env, state.phys, tgt).items():
        r = time_call(fn, dev, reps, top)
        r.update(calls_per_tick=calls, per_tick_ms=r["ms"] * calls,
                 per_tick_launches=None if r["launches"] is None else r["launches"] * calls)
        out["parts"][name] = r
    out["tick"] = time_call(lambda: engine.step_batched(env.model, env.sim_cfg, env._tables,
                                                        state.phys, tgt), dev, reps, top)
    out["control_step"] = time_call(lambda: env.step(state, actions), dev, reps, top)
    out["reset_done"] = time_call(lambda: env.reset_done(state), dev, reps, top)
    out["parts_sum_ms"] = sum(p["per_tick_ms"] for p in out["parts"].values())
    out["parts_over_tick"] = out["parts_sum_ms"] / out["tick"]["ms"]
    return out


def report(t: dict) -> str:
    """The parts in one line, then the tick, control step and reset_done."""
    def launches(r, n="launches"):
        return "" if r.get(n) is None else f" / {r[n]} launches"

    lines = [f"tick parts ({t['envs']} envs): " + ", ".join(
        f"{k} {p['per_tick_ms']:.3f} ms{launches(p, 'per_tick_launches')} "
        f"({p['calls_per_tick']} x {p['ms']:.3f} ms)" for k, p in t["parts"].items())
        + f"; sum {t['parts_sum_ms']:.3f} ms = {t['parts_over_tick']:.3f} of the tick"]
    for k, unit in (("tick", " env-ticks/s"), ("control_step", " env-steps/s"),
                    ("reset_done", "")):
        r = t[k]
        busy = "" if r.get("busy_ms") is None else f", device busy {r['busy_ms']:.3f} ms"
        rate = f" ({t['envs'] / r['ms'] * 1e3:.0f}{unit})" if unit else ""
        lines.append(f"{k}: {r['ms']:.3f} ms{launches(r)}{busy}{rate}")
    return "\n".join(lines)


def tick_mode(args, dev) -> dict:
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.physics import engine

    cfg = load_cfg("humanoid_ase_sword_shield_getup.yaml")
    cfg["env"]["numEnvs"] = args.envs
    cfg["env"]["motion_file"] = paths.default_clip()
    cfg["env"]["enableSelfCollision"] = True
    env = parse_task("HumanoidAMP", cfg, device=dev)
    state = env.initial_state()
    actions = torch.zeros(args.envs, env.get_action_size(), device=dev)
    out = stage_times(env, state, actions, args.reps)
    print(report(out), flush=True)
    if dev.type == "cuda":
        print(trace_summary.report(out["control_step"]["summary"], "control step",
                                   top=args.top), flush=True)
    if args.trace:
        _, tgt = env.pre_physics_step(state, actions)
        path = os.path.join("output", "profile_tick", time.strftime("%Y%m%d-%H%M%S")
                            + "_ticks.pt.trace.json.gz")

        def ticks():
            for _ in range(5):
                engine.step_batched(env.model, env.sim_cfg, env._tables, state.phys, tgt)

        profiled(ticks, dev, path)
        out["trace"] = path
        print(f"trace written to {path}", flush=True)
    return out


def epoch_mode(args, dev) -> dict:
    from ase_tpu_torch.tools.profile_epoch import build_bench_agent

    agent = build_bench_agent(args.envs, 32, not args.float32, str(dev))
    env_state = agent.setup_training()
    env_state, _ = agent.train_epoch(env_state)             # warm-up
    recs = []
    for _ in range(args.epochs):
        env_state, rec = agent.train_epoch(env_state)
        recs.append(rec)
    roll = sum(r["rollout_s"] for r in recs) / len(recs) * 1e3
    upd = sum(r["update_s"] for r in recs) / len(recs) * 1e3
    steps = agent.batch_size
    out = {"envs": args.envs, "precision": "float32" if args.float32 else "bf16",
           "epochs": args.epochs, "rollout_ms": roll, "update_ms": upd,
           "rollout_env_steps_per_s": steps / roll * 1e3,
           "env_steps_per_s": steps / (roll + upd) * 1e3}
    print(f"rollout phase: {roll:.1f} ms ({out['rollout_env_steps_per_s']:.0f} steps/s)\n"
          f"update phase: {upd:.1f} ms\n"
          f"epoch: {out['env_steps_per_s']:.0f} env-steps/s ({out['precision']}, "
          f"mean of {args.epochs} epochs)", flush=True)
    return out


def main(argv=None) -> dict:
    from ase_tpu_torch.utils.config import torch_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=int(os.environ.get("PROF_NUM_ENVS", 4096)))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--trace", action="store_true", help="tick mode: a Chrome trace of 5 ticks")
    ap.add_argument("--epoch", action="store_true", help="the epoch's rollout and update phases")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--float32", action="store_true", help="--epoch: float32 dense layers")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"device: {name}", flush=True)
    out = epoch_mode(args, dev) if args.epoch else tick_mode(args, dev)
    out["device"] = name
    return out


if __name__ == "__main__":
    main()
