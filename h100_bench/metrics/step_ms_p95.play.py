"""step_ms_p95.play: the 95th percentile (nearest rank) of the window's
control-step times in ms, from CUDA events recorded at each player step's
boundary and read after the window (an HRL decision's time over its
control steps)."""

import math


def read(record):
    ms = sorted(record.get("step_ms") or [])
    if record.get("mode") != "play" or len(ms) < 20:
        return None
    return ms[math.ceil(0.95 * len(ms)) - 1]
