"""launches_per_step.train: kernel records in the traced window launched
inside the harness's ``rollout.step`` spans, per control step traced."""


def read(record):
    trace = record.get("trace") or {}
    steps = trace.get("control_steps") or 0
    n = (trace.get("kernels_in") or {}).get("rollout.step")
    if record.get("mode") != "train" or not steps or not n:
        return None
    return n / steps
