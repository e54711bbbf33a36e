"""Running a call under torch.profiler and writing its Chrome trace: the
one code path of the ``ASE_TPU_PROFILE`` hook and the measurement tools."""

from __future__ import annotations

import gzip
import os
import shutil
import time

import torch


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profiled(fn, device, trace_path=None):
    """``fn()`` under torch.profiler (CPU, and CUDA on the card), ending in
    a device sync; the Chrome trace goes to ``trace_path`` if given.
    Returns (fn's result, the profiler, the host wall in s)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        wall = time.perf_counter() - t0
    if trace_path is not None:
        export(prof, trace_path)
    return out, prof, wall


def export(prof, path: str) -> None:
    """``prof``'s Chrome trace at ``path``, gzipped (at zlib's fastest
    level) when it ends in ``.gz``: a getup control step is ~50 MB raw."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if not path.endswith(".gz"):
        prof.export_chrome_trace(path)
        return
    raw = path[:-3]
    prof.export_chrome_trace(raw)
    try:
        with open(raw, "rb") as fin, gzip.open(path, "wb", compresslevel=1) as fout:
            shutil.copyfileobj(fin, fout)
    finally:
        os.remove(raw)
