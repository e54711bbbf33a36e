"""The yardstick's arithmetic: the card's peaks, the dense-layer FLOPs of
the networks (``mfu``) and the bytes and FLOPs of the Cholesky kernels
(their rooflines), all computed from shapes and the configuration's widths.

Peaks are NVIDIA's data sheet for the H100 SXM at its 700 W limit: 3.35
TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores (the
configurations run float32 with TF32 off).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "float32_flop_per_s": 67e12,
}


def mlp_macs(in_dim: int, units: Sequence[int], out_dim: int = 0) -> int:
    """Multiply-adds per row of a dense stack ``in_dim -> units... -> out_dim``
    (no output layer when ``out_dim`` is 0)."""
    dims = [int(in_dim), *(int(u) for u in units)] + ([int(out_dim)] if out_dim else [])
    return sum(a * b for a, b in zip(dims[:-1], dims[1:]))


def ase_parts(dims: Dict[str, int], widths: Dict[str, Sequence[int]]) -> Dict[str, int]:
    """Multiply-adds per row of each part of an ASE network: the actor (the
    style net and the actor MLP with its ``mu`` head), the critic, the
    discriminator and the encoder (which runs the discriminator's trunk
    again under its own head)."""
    obs, amp, act, lat = dims["obs"], dims["amp_obs"], dims["actions"], dims["latent"]
    units, disc, style = widths["mlp"], widths["disc"], widths["style"]
    return {
        "actor": mlp_macs(lat, style, lat) + mlp_macs(obs + lat, units, act),
        "critic": mlp_macs(obs + lat, units, 1),
        "disc": mlp_macs(amp, disc, 1),
        "enc": mlp_macs(amp, disc, lat),
    }


def train_epoch_flops(dims: Dict[str, int], widths: Dict[str, Sequence[int]],
                      train: Dict[str, int]) -> float:
    """Dense-layer FLOPs of one ASE training epoch (2 per multiply-add).

    Rollout: each of ``horizon`` steps runs the actor once and the critic
    twice (value and next value) over the envs. Rewards: the discriminator
    and the encoder over every recorded row. Update, per minibatch: forward
    and backward (3 passes) of the actor, the critic and the diversity
    term's second actor over its rows; of the discriminator over the agent
    and replay rows and the encoder over the AMP rows; and the demo rows'
    gradient penalty, counted as 6 passes (forward, the input gradient, and
    the backward through both)."""
    p = ase_parts(dims, widths)
    T, B = train["horizon"], train["envs"]
    n, na, mbs = train["minibatch"], train["amp_minibatch"], train["minibatches"]
    rollout = T * B * (p["actor"] + 2 * p["critic"])
    rewards = T * B * (p["disc"] + p["enc"])
    per_mb = 3 * n * (2 * p["actor"] + p["critic"]) + 3 * (2 * na) * p["disc"] \
        + 6 * na * p["disc"] + 3 * na * p["enc"]
    return 2.0 * (rollout + rewards + mbs * per_mb)


def play_step_flops(dims: Dict[str, int], widths: Dict[str, Sequence[int]], envs: int) -> float:
    """Dense-layer FLOPs of one ASE player control step: the actor's
    forward over the envs."""
    return 2.0 * envs * ase_parts(dims, widths)["actor"]


def hrl_decision_flops(dims: Dict[str, int], widths: Dict[str, Sequence[int]],
                       hlc_units: Sequence[int], envs: int, llc_steps: int) -> float:
    """Dense-layer FLOPs of one HRL decision: the high-level actor once over
    its observation, then for each of ``llc_steps`` control steps the
    low-level actor and the low-level discriminator (its style reward)."""
    p = ase_parts(dims, widths)
    hlc = mlp_macs(dims["hlc_obs"], hlc_units, dims["latent"])
    return 2.0 * envs * (hlc + llc_steps * (p["actor"] + p["disc"]))


def chol_work(kind: str, n: int, m: int, m2: int, B: int):
    """(bytes, FLOPs) one call needs: inputs read once (only the lower
    triangle of M or L), outputs written once (all of L)."""
    f, tri = 4.0 * B, n * (n + 1) // 2
    if kind == "chol_forward2":
        return f * (tri + n * n + 2 * n * (m + m2)), B * (n ** 3 / 3 + n * n * (m + m2))
    if kind == "back_solve":
        return f * (tri + 2 * n * m), float(B * n * n * m)
    raise ValueError(kind)


def chol_bound_s(kind: str, n: int, m: int, m2: int, B: int) -> float:
    """The least time one call could take on the card: the larger of its
    bytes over the HBM rate and its FLOPs over the float32 rate."""
    b, ops = chol_work(kind, n, m, m2, B)
    return max(b / PEAKS["hbm_bytes_per_s"], ops / PEAKS["float32_flop_per_s"])


def chol_roofline(record: Dict[str, Any], kind: str, kernel: str) -> Optional[float]:
    """The share of its roofline, in %, that one kind of Cholesky call
    (``chol_forward2`` or ``back_solve``) reaches in a traced play window:
    the least time its calls could take (``chol_bound_s`` from each call's
    shapes, recorded by the harness's wrapper) over the device time of its
    kernel's records (names holding ``kernel``), scaled by calls over
    records (the profiler can drop a few records). None where there is
    nothing to read, or where ``chol_forward`` calls share ``chol_forward2``'s
    kernel, so that the kernel's time cannot be split by name."""
    trace = record.get("trace") or {}
    calls = trace.get("chol_calls") or []
    if record.get("mode") != "play" or not calls:
        return None
    if kind == "chol_forward2" and any(c[0] == "chol_forward" for c in calls):
        return None
    mine = [c for c in calls if c[0] == kind]
    names = [n for n in (trace.get("kernel_s") or {}) if kernel in n]
    records = sum(trace["kernel_n"][n] for n in names)
    seconds = sum(trace["kernel_s"][n] for n in names)
    if not mine or not records or seconds <= 0:
        return None
    bound = sum(chol_bound_s(*c) for c in mine)
    return 100.0 * bound / (seconds * len(mine) / records)
