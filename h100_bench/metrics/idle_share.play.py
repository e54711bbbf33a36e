"""idle_share.play: the share of the traced window in which no operation ran
on the device: 1 - (the union of the device events' intervals / the
window's span), in %."""


def read(record):
    trace = record.get("trace") or {}
    if record.get("mode") != "play" or not trace.get("window_s") or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
