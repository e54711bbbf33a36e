"""The episode-clock rule: each env's clock a seeded uniform draw in
[0, episodeLength), the same for the same seed."""

from types import SimpleNamespace

import torch

from h100_bench import program


class _State(SimpleNamespace):
    def replace(self, **kw):
        return _State(**{**vars(self), **kw})


def _stagger(seed, B=4096, L=300):
    env = SimpleNamespace(max_episode_length=L)
    state = _State(progress=torch.zeros(B, dtype=torch.int32))
    return program.stagger_clocks(env, state, seed).progress


def test_clocks_are_uniform_on_the_episode():
    p = _stagger(2 ** 31 + 12345)
    assert p.dtype == torch.int32
    assert int(p.min()) >= 0 and int(p.max()) < 300
    # about envs / episodeLength envs on every clock value: each step ~13.7 time out
    counts = torch.bincount(p.long(), minlength=300).double()
    assert 8 < float(counts.mean()) < 20 and float(counts.max()) < 40
    assert abs(float(p.double().mean()) - 149.5) < 6


def test_the_same_seed_gives_the_same_clocks():
    assert torch.equal(_stagger(7), _stagger(7))
    assert not torch.equal(_stagger(7), _stagger(8))


def test_large_seeds_are_taken():
    assert program.program_seed(2 ** 33 + 5) < 2 ** 31
    _stagger(2 ** 40)
