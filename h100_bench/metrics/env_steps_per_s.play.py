"""env_steps_per_s.play: the window's env-steps (envs x control steps; an
HRL decision counts its 5 control steps) over its wall time, ending in a
sync. The play rate, read per layer: the host's speed spreads it between
runs by more than half of the largest bound an end-to-end metric may
take."""


def read(record):
    w = record.get("window") or {}
    if record.get("mode") != "play" or not w.get("control_steps") or not w.get("wall_s"):
        return None
    return record["envs"] * w["control_steps"] / w["wall_s"]
