"""mfu.train: the dense-layer FLOPs of the networks that the window's
epochs need (``flops.train_epoch_flops``, from the configuration's widths)
over the window's wall time and the card's float32 peak (67 TFLOP/s; the
configuration runs float32 with TF32 off), in %."""

from h100_bench.flops import PEAKS


def read(record):
    f = (record.get("flops") or {}).get("per_epoch")
    w = record.get("window") or {}
    if record.get("mode") != "train" or not f or not w.get("epochs"):
        return None
    return 100.0 * f * w["epochs"] / w["wall_s"] / PEAKS["float32_flop_per_s"]
