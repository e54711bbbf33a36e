"""The traced window's timeline, read from its Chrome trace.

Keeps the device events (kernels, copies, sets), the host's CUDA runtime
calls (to map a kernel to the host moment that launched it, by the
trace's correlation ids) and the harness's spans (``user_annotation``
events named in ``spans.SPAN_NAMES``). From them:

- ``busy_s``: the union of the device events' intervals;
- ``window_s``: the span from the first to the last event of any kind;
- ``kernels``, ``kernels_by_span`` and ``kernels_in``: kernel records; how
  many were launched inside each span (the innermost one); and inside any
  span of each name, at any depth;
- ``idle_gaps``: every gap between device work, by the innermost span
  open when the host launched the work that ended the gap
  (``outside_the_spans`` when none was);
- ``kernel_s`` and ``kernel_n``: device seconds and records by name, and
  ``top``: the names that took most.
"""

from __future__ import annotations

import bisect
import collections
import gzip
import json
from typing import Dict, List, Tuple

from h100_bench.tracing import trace_summary
from h100_bench.tracing.spans import SPAN_NAMES

OUTSIDE = "outside_the_spans"


def _innermost(spans: List[Tuple[float, float, str]], starts: List[float], ts: float) -> str:
    """The latest-starting span that holds ``ts``."""
    i = bisect.bisect_right(starts, ts)
    best = None
    for j in range(i - 1, -1, -1):
        s, e, name = spans[j]
        if e >= ts:
            best = name
            break
    return best or OUTSIDE


def read(path: str, top: int = 10) -> Dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    device, launch_ts, spans, ts_all = [], {}, [], []
    for e in data.get("traceEvents", []):
        if e.get("ph") != "X":
            continue
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        cat, name = e.get("cat", ""), e.get("name", "?")
        ts_all.append((ts, ts + dur))
        corr = (e.get("args") or {}).get("correlation")
        if cat in trace_summary.DEVICE_CATS:
            device.append((ts, ts + dur, name, corr, cat == "kernel"))
        elif cat in ("cuda_runtime", "cuda_driver") and corr is not None:
            launch_ts[corr] = ts
        elif cat == "user_annotation" and name in SPAN_NAMES:
            spans.append((ts, ts + dur, name))
    del data
    out = {"kernels": sum(1 for d in device if d[4])}
    if not device:
        return out
    t0 = min(a for a, _ in ts_all)
    t1 = max(b for _, b in ts_all)
    spans.sort()
    starts = [s[0] for s in spans]
    device.sort()
    busy, gaps = 0.0, collections.Counter()
    by_span = collections.Counter()
    cur_s, cur_e = device[0][0], device[0][1]
    for k, (s, e, name, corr, is_kernel) in enumerate(device):
        launched = launch_ts.get(corr)
        where = _innermost(spans, starts, launched) if launched is not None else OUTSIDE
        if is_kernel:
            by_span[where] += 1
        if k == 0:
            continue
        if s > cur_e:
            busy += cur_e - cur_s
            gaps[where] += s - cur_e
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    summary = trace_summary._summarize(
        [trace_summary.Event(n, s, e - s, True) for s, e, n, _, _ in device], top, None)
    kernel_s, kernel_n = collections.Counter(), collections.Counter()
    for s, e, name, _, _ in device:
        kernel_s[name] += (e - s) / 1e6
        kernel_n[name] += 1
    kernels_in = {}
    for span_name in sorted({n for _, _, n in spans}):
        mine = [(s, e) for s, e, n in spans if n == span_name]
        mine_starts = [s for s, _ in mine]
        count = 0
        for s, e, name, corr, is_kernel in device:
            launched = launch_ts.get(corr)
            if not is_kernel or launched is None:
                continue
            i = bisect.bisect_right(mine_starts, launched) - 1
            if i >= 0 and mine[i][1] >= launched:
                count += 1
        kernels_in[span_name] = count
    out.update({
        "busy_s": busy / 1e6, "window_s": (t1 - t0) / 1e6,
        "kernels_by_span": dict(by_span), "kernels_in": kernels_in,
        "idle_gaps": [[n, v / 1e6] for n, v in gaps.most_common(top)],
        "kernel_s": dict(kernel_s), "kernel_n": dict(kernel_n),
        "top": [[t["name"], t["ms"] / 1e3] for t in summary["top"][:top]],
    })
    return out
