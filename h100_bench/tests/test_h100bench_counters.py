"""The reset-pass counter: per reset_done call, the passes that reset at
least one env and the envs they reset, read from the pass's own return."""

from h100_bench import program
from h100_bench.tracing.spans import Patches


class _Env:
    """reset_done drains ``flagged`` envs in chunked passes, as the env does."""

    def __init__(self, chunk):
        self.chunk = chunk

    def reset_done(self, flagged):
        state, n = self._reset_chunk_pass(flagged, self.chunk)
        while n > 0 and state > 0:
            state, n = self._reset_chunk_pass(state, self.chunk)
        return state

    def _reset_chunk_pass(self, flagged, chunk):
        n = min(flagged, chunk)
        return flagged - n, n


def test_passes_and_flagged_per_call():
    env = _Env(512)
    patches = Patches()
    rec = program.count_resets(patches, env)
    for flagged in (0, 14, 512, 513, 1500):
        env.reset_done(flagged)
    patches.undo()
    assert rec["passes"] == [0, 1, 1, 2, 3]
    assert rec["flagged"] == [0, 14, 512, 513, 1500]
    assert "reset_done" not in vars(env)     # the wrappers are gone
    env.reset_done(3)
    assert len(rec["passes"]) == 5


def test_the_metric_reads_the_counter():
    from h100_bench import cells

    read = cells.metric_reader("reset_passes_per_call.play")
    assert read({"mode": "play", "resets": {"passes": [1, 1, 2, 0]}}) == 1.0
    assert read({"mode": "train", "resets": {"passes": [1]}}) is None
