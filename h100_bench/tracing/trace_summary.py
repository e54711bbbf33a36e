"""Sum a torch.profiler trace by kernel name: a frozen copy of
``ase_tpu_torch/tools/trace_summary.py``, so that the benchmark's trace
reading does not move when the program's tool does.

Reads the newest ``*.json`` / ``*.json.gz`` Chrome trace under a directory
(default ``output/profile_bench``), or a trace file given directly, and
keeps its device events (``"cat"`` ``kernel``, ``gpu_memcpy``,
``gpu_memset``) and the host's CUDA launch calls (``cudaLaunchKernel`` and
the like). Prints:

- device busy ms (the sum of the device events' durations) over the span
  (first to last kept event, device or launch call) and the busy share;
- the kernel launches (device events that are kernels, not copies or sets)
  and the host's launch calls;
- the top names by total device time, with their counts;
- the rollup into buckets by name: matmul (cuBLAS, CUTLASS and nvjet
  kernels), gather/scatter, sort, custom (the port's Cholesky kernels),
  copies, reduce, elementwise, other.

A trace with no device events (a CPU run) prints "no device time recorded"
and reports no busy share.

    python -m h100_bench.tracing.trace_summary [trace_dir_or_file] [--top 40] [--like chol]

``summarize`` takes a trace path or a finished ``torch.profiler.profile``,
whose trace it exports to a temporary file and reads the same way (a
profiler writes its trace once: once exported, pass the file).
"""

from __future__ import annotations

import argparse
import collections
import glob
import gzip
import json
import os
import re
import tempfile
from typing import Iterable, List, NamedTuple, Optional

BUCKETS = [
    ("matmul", re.compile(r"gemm|gemv|cutlass|xmma|nvjet", re.I)),
    ("gather/scatter", re.compile(r"index|gather|scatter", re.I)),
    ("sort", re.compile(r"sort|radix", re.I)),
    ("custom", re.compile(r"chol_forward_kernel|back_solve_kernel")),
    ("copies", re.compile(r"copy|cat|transpose|memcpy|memset", re.I)),
    ("reduce", re.compile(r"reduce", re.I)),
    ("elementwise", re.compile(r"elementwise|vectorized", re.I)),
]
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH = re.compile(r"^cu\w*Launch")           # cudaLaunchKernel, cuLaunchKernel, ...
NOT_A_KERNEL = ("Memcpy", "Memset")            # device events that are copies or sets
NO_DEVICE_TIME = "no device time recorded"


class Event(NamedTuple):
    name: str
    ts_us: float
    dur_us: float
    on_device: bool


def bucket_of(name: str) -> str:
    for label, pat in BUCKETS:
        if pat.search(name):
            return label
    return "other"


def find_trace(root: str) -> str:
    """``root`` if it is a file, else the newest ``*.json`` or ``*.json.gz``
    under it."""
    if os.path.isfile(root):
        return root
    cands = [p for ext in ("*.json", "*.json.gz")
             for p in glob.glob(os.path.join(root, "**", ext), recursive=True)]
    if not cands:
        raise FileNotFoundError(f"no *.json or *.json.gz trace under {root}")
    return max(cands, key=os.path.getmtime)


def trace_events(path: str) -> List[Event]:
    """The device events and launch calls of a Chrome trace file."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    out = []
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "?")
        device = cat in DEVICE_CATS
        if device or (cat in ("cuda_runtime", "cuda_driver") and LAUNCH.search(name)):
            out.append(Event(name, float(e.get("ts", 0)), float(e.get("dur", 0)), device))
    return out


def summarize(source, top: int = 40, like: Optional[str] = None) -> dict:
    """Sum ``source`` (a trace path or a ``torch.profiler.profile``) by name;
    ``like`` keeps only the names it matches. Returns the numbers the
    module docstring lists; without device events, ``device_time`` says so
    and there is no busy share."""
    if isinstance(source, str):
        return _summarize(trace_events(source), top, like)
    # the profiler's own events() builds Python objects and a tree of every
    # host op: ~10x slower than its C++ trace export read back
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        source.export_chrome_trace(path)
        return _summarize(trace_events(path), top, like)


def _summarize(events: Iterable[Event], top: int, like: Optional[str]) -> dict:
    pat = re.compile(like, re.I) if like else None
    events = [e for e in events if pat is None or not e.on_device or pat.search(e.name)]
    dev = [e for e in events if e.on_device]
    out = {"launch_calls": sum(not e.on_device for e in events)}
    if not dev:
        out["device_time"] = NO_DEVICE_TIME
        return out
    tot, cnt = collections.Counter(), collections.Counter()
    for e in dev:
        tot[e.name] += e.dur_us / 1e3
        cnt[e.name] += 1
    busy = sum(tot.values())
    t0 = min(e.ts_us for e in events)
    t1 = max(e.ts_us + e.dur_us for e in events)
    span = (t1 - t0) / 1e3
    buckets = collections.Counter()
    for name, ms in tot.items():
        buckets[bucket_of(name)] += ms
    out.update({
        "device_time": "recorded",
        "busy_ms": busy, "span_ms": span, "busy_share": busy / span if span > 0 else None,
        "launches": sum(n for name, n in cnt.items() if not name.startswith(NOT_A_KERNEL)),
        "distinct": len(tot),
        "buckets": dict(buckets.most_common()),
        "top": [{"name": n, "ms": ms, "count": cnt[n]} for n, ms in tot.most_common(top)],
    })
    return out


def report(summary: dict, label: str = "", steps: int = 1, top: int = 40) -> str:
    """``summary`` as text; times and counts per step when the window
    holds ``steps`` steps."""
    head = f"{label}: " if label else ""
    if "busy_ms" not in summary:
        return f"{head}{NO_DEVICE_TIME} ({summary['launch_calls']} launch calls)"
    busy = summary["busy_ms"]
    share = summary["busy_share"]
    lines = [f"{head}device busy {busy / steps:.3f} ms over a {summary['span_ms'] / steps:.3f} "
             f"ms span per step ({'n/a' if share is None else f'{100 * share:.1f}%'}), "
             f"{summary['launches'] / steps:.0f} kernel launches and "
             f"{summary['launch_calls'] / steps:.0f} launch calls per step, "
             f"{summary['distinct']} distinct names"]
    for label_, ms in summary["buckets"].items():
        lines.append(f"  {label_:<15} {ms / steps:9.3f} ms  {100 * ms / max(busy, 1e-9):5.1f}%")
    for t in summary["top"][:top]:
        lines.append(f"  {t['ms'] / steps:9.3f} ms  x{t['count'] / steps:<8.0f} {t['name'][:120]}")
    return "\n".join(lines)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trace", nargs="?", default="output/profile_bench",
                   help="a trace file, or a directory whose newest trace is read")
    p.add_argument("--top", type=int, default=40)
    p.add_argument("--like", default=None, help="only device names that match this regex")
    args = p.parse_args(argv)
    path = find_trace(args.trace)
    summary = summarize(path, args.top, args.like)
    summary["trace"] = path
    print(f"# {path}")
    print(report(summary, top=args.top))
    return summary


if __name__ == "__main__":
    main()
