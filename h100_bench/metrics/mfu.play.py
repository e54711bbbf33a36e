"""mfu.play: the dense-layer FLOPs of the networks that the window's
control steps need (the actor's forward; for HRL the high-level actor once
a decision and the low-level actor and discriminator each step, from the
configuration's widths) over the window's wall time and the card's float32
peak (67 TFLOP/s), in %."""

from h100_bench.flops import PEAKS


def read(record):
    f = (record.get("flops") or {}).get("per_control_step")
    w = record.get("window") or {}
    if record.get("mode") != "play" or not f or not w.get("control_steps"):
        return None
    return 100.0 * f * w["control_steps"] / w["wall_s"] / PEAKS["float32_flop_per_s"]
