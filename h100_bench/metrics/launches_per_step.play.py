"""launches_per_step.play: kernel records in the traced window launched
inside the harness's ``player.step`` spans, per control step traced."""


def read(record):
    trace = record.get("trace") or {}
    steps = trace.get("control_steps") or 0
    n = (trace.get("kernels_in") or {}).get("player.step")
    if record.get("mode") != "play" or not steps or not n:
        return None
    return n / steps
