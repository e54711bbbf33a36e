"""reset_passes_per_call.play: reset passes that reset at least one env,
per ``reset_done`` call over the window, counted by the harness's wrappers
of ``Humanoid.reset_done`` and ``Humanoid._reset_chunk_pass``."""


def read(record):
    resets = record.get("resets") or {}
    passes = resets.get("passes") or []
    if record.get("mode") != "play" or not passes:
        return None
    return sum(passes) / len(passes)
