"""env_steps_per_s.train: the window's env-steps (envs x the control steps
of its whole epochs, rollout and update) over its wall time, ending in a
sync. The training rate, read per layer: the host's speed spreads it
between runs by more than half of the largest bound an end-to-end metric
may take."""


def read(record):
    w = record.get("window") or {}
    if record.get("mode") != "train" or not w.get("control_steps") or not w.get("wall_s"):
        return None
    return record["envs"] * w["control_steps"] / w["wall_s"]
