"""The comparison that decides ``correct``.

After the window has closed, ``memory_peak_bytes`` has been read and the
program's objects are freed, the reference (``reference/follow.py``) redoes
every checked point from the program's captured inputs. Each checked point
gives, per env, the widest gap between the program's output and the
reference's; the readings below summarise them over the envs, and the
cell's limits file (``limits/<cell>.yaml``) names the readings compared and
holds each to its limit:

- ``act_gap``: the widest gap between an action the program produced and
  the reference's, over every env of every checked step;
- ``obs_gap``: over the start and every checked step, the median over the
  envs of each env's widest observation gap after the step's first control
  step (one control step of contact-rich physics carries a float32
  rounding difference in a small tail of the envs far past the rest, see
  PERF.md, so the bulk and the tail are read apart);
- ``obs_p99``: the same, its 99th percentile over the envs, and
  ``obs_over_<t>``: the percent of envs whose widest observation gap is
  over ``t`` (the tail: a fault in a minority of the envs moves these where
  it leaves the median);
- playing: ``rew_gap``, ``rew_p50``, ``rew_p99``: the widest, median and
  99th percentile gap of a step's rewards over the envs, and
  ``done_mismatch``: the envs whose done flag differs, summed over the
  checked steps (training: over the rollout's steps);
- training only, from the update's first optimizer steps: ``loss_gap``
  (the widest relative gap of a step's loss), ``grad_gap`` (the worst
  leaf's gap between the norms of the first gradient as Adam holds it) and
  ``step_gap`` (the worst leaf's gap between the norms of the weights'
  change after the checked steps), leaving out leaves whose reference
  gradient is under a thousandth of the median leaf's.

Each reading is the worst over the checked points.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from h100_bench.reference import follow

QUANTILES = (0.5, 0.99, 1.0)
OVER = (0.001, 0.003, 0.01, 0.03, 0.1, 0.3, 1.0)


def act_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    return float((prog.to(ref.device).double() - ref.double()).abs().max())


def env_gaps(prog: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each env's widest gap (a NaN on either side counts as infinite)."""
    gap = (prog.to(ref.device).double() - ref.double()).abs()
    return torch.nan_to_num(gap.reshape(prog.shape[0], -1).amax(dim=1), nan=math.inf)


def spread(per_env: torch.Tensor) -> Dict[str, float]:
    """Quantiles over the envs (``p50``, ``p99``, ``p100``) and the percent
    of envs over each of ``OVER`` (``over_<t>``)."""
    qs = torch.quantile(per_env, torch.tensor(QUANTILES, dtype=per_env.dtype,
                                              device=per_env.device)).tolist()
    out = {f"p{round(100 * q)}": v for q, v in zip(QUANTILES, qs)}
    out.update({f"over_{t:g}": 100.0 * float((per_env > t).double().mean()) for t in OVER})
    return out


def obs_gaps(prog: torch.Tensor, ref: torch.Tensor) -> Dict[str, float]:
    return spread(env_gaps(prog, ref))


def done_mismatch(prog: torch.Tensor, ref: torch.Tensor) -> int:
    return int(((prog.to(ref.device) > 0) != (ref > 0)).sum())


def judge(readings: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[Dict[str, float], bool, List[str]]:
    """The readings that the limits name, and whether each is within its
    limit (a limit with no reading fails)."""
    numbers = {k: readings.get(k, math.nan) for k in limits}
    failed = [k for k, v in numbers.items() if not (math.isfinite(v) and v <= limits[k])]
    return numbers, not failed, failed


def _worst(points: List[Dict[str, float]], prefix: str) -> Dict[str, float]:
    """The worst over the checked points of each spread reading, named
    ``<prefix>_gap`` (the median), ``<prefix>_p99`` and ``<prefix>_over_<t>``."""
    out = {}
    for key in points[0]:
        name = f"{prefix}_gap" if key == "p50" else f"{prefix}_{key}"
        out[name] = max(p[key] for p in points)
    return out


def _widest(points: List[Dict[str, float]], prefix: str) -> Dict[str, float]:
    out = _worst(points, prefix)
    out[f"{prefix}_p50"] = out.pop(f"{prefix}_gap")
    out[f"{prefix}_gap"] = out.pop(f"{prefix}_p100")
    return out


def play_numbers(ref: "follow.Reference", cap, device, witness: bool = False
                 ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """The play cells' readings, and the diagnostics printed beside them.
    ``witness`` adds, for each checked step, the reference's step with a
    float64 Cholesky and the reference's step run twice (PERF.md)."""
    start = ref.start(cap.fall_states, cap.start_gens)
    g = obs_gaps(cap.start_state.obs, start.obs)
    del start
    obs, rew, acts, dones = [g], [], [], 0
    diag = {"start_obs_gap": g, "steps": []}
    for s in cap.steps:
        state, rewards, actions = ref.play_step(s["state"], s["roll"], s["gens"])
        a = act_gap(s["actions"], actions)
        g = obs_gaps(s["out"].obs, state.obs)
        r = spread(env_gaps(s["rewards"].reshape(s["rewards"].shape[0], -1),
                            rewards.reshape(rewards.shape[0], -1)))
        d = done_mismatch(s["out"].reset_buf, state.reset_buf)
        acts.append(a)
        obs.append(g)
        rew.append(r)
        dones += d
        step = {"step": s["index"], "act_gap": a, "obs_gap": g, "rew_gap": r, "done_mismatch": d}
        if witness:
            step["witness"] = _witness(ref, s, state)
        diag["steps"].append(step)
        del state
    readings = {"act_gap": max(acts), **_worst(obs, "obs"), **_widest(rew, "rew"),
                "done_mismatch": dones}
    return readings, diag


def _witness(ref: "follow.Reference", s, state32) -> Dict[str, Any]:
    """Which side the envs in the tail side with: the program's step (its
    Cholesky kernel) and the reference's (the plain Cholesky, float32),
    each against the reference with a float64 Cholesky; and the reference
    against itself run again (nondeterminism)."""
    with follow.float64_cholesky():
        state64, _, _ = ref.play_step(s["state"], s["roll"], s["gens"])
    again, _, _ = ref.play_step(s["state"], s["roll"], s["gens"])
    prog_ref = env_gaps(s["out"].obs, state32.obs)
    prog_64 = env_gaps(s["out"].obs, state64.obs)
    ref_64 = env_gaps(state32.obs, state64.obs)
    tail = prog_ref > 0.1
    n = int(tail.sum())
    out = {"ref_vs_ref": spread(env_gaps(again.obs, state32.obs)),
           "prog_vs_f64": spread(prog_64), "ref_vs_f64": spread(ref_64),
           "tail_envs": n}
    if n:
        out.update(tail_prog_vs_f64_median=float(prog_64[tail].median()),
                   tail_ref_vs_f64_median=float(ref_64[tail].median()),
                   tail_prog_closer=int((prog_64[tail] < ref_64[tail]).sum()))
    return out


def train_numbers(ref: "follow.Reference", cap, minibatches: int, device
                  ) -> Tuple[Dict[str, float], Dict[str, Any]]:
    """The training cell's readings: every rollout step of the set-up epoch
    followed from the program's state, then the update's first optimizer
    steps on the reference's own records."""
    ref.init_train_state(cap.demo_gens)
    start = ref.start(cap.fall_states, cap.start_gens)
    g = obs_gaps(cap.start_state.obs, start.obs)
    del start
    obs, acts, dones, diag = [g], [], 0, {"start_obs_gap": g, "steps": []}
    recs, roll = [], None
    for t, s in enumerate(cap.steps):
        state, roll, rec, actions = ref.rollout_step(s["state"], s["roll"], s["gens"])
        a = act_gap(s["actions"], actions)
        g = obs_gaps(s["out"].obs, state.obs)
        d = done_mismatch(s["out"].reset_buf, state.reset_buf)
        acts.append(a)
        obs.append(g)
        dones += d
        diag["steps"].append({"step": t, "act_gap": a, "obs_gap": g, "done_mismatch": d})
        recs.append(rec)
        del state
    up = ref.train_update(recs, roll, cap.post_rollout_gens, minibatches)
    del recs
    prog = cap.update
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], up["loss"]))
    keep = follow.moved_leaves(up["g1"])
    grad = follow.leaf_norm_gap(prog["g1"], up["g1"])
    d_prog = {n: prog["p3"][n] - prog["p0"][n] for n in prog["p0"]}
    d_ref = {n: up["p3"][n] - up["p0"][n] for n in up["p0"]}
    step = follow.leaf_norm_gap(d_prog, d_ref, keep=set(keep))
    diag.update({"loss_prog": prog["loss"], "loss_ref": up["loss"],
                 "grad_worst_leaf": grad["leaf"], "step_worst_leaf": step["leaf"],
                 "leaves_counted": len(keep), "leaves": len(up["g1"]),
                 "init_weights_equal": all(bool(torch.equal(prog["p0"][n].to(up["p0"][n].device),
                                                                   up["p0"][n]))
                                           for n in up["p0"])})
    readings = {"act_gap": max(acts), **_worst(obs, "obs"), "done_mismatch": dones,
                "loss_gap": loss_gap, "grad_gap": grad["gap"], "step_gap": step["gap"]}
    return readings, diag
