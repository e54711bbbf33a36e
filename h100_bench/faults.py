"""Faults planted in the program underneath a run, to show that the
comparison catches them (the harness's tests, and readings on the card).
Each is installed on the built objects with ``Patches`` and is never part
of a benchmark run:

- ``unchanged``: a step that returns its state unchanged (training: the
  optimizer step does nothing; playing: the env step returns its input);
- ``half_batch``: half of the batch left out (training: each minibatch's
  rows are cut to their first half, the means taken over the rest; playing: only
  the first half of the envs is stepped);
- ``tenth_envs``: a tenth of the envs left out (the env step returns the
  last tenth of the envs, at least one, unchanged), a fault in a minority
  of the batch;
- ``altered``: an answer altered where it is produced (the policy's first
  action entry of env 0 moved by 0.5).
"""

from __future__ import annotations

import torch

FAULTS = ("unchanged", "half_batch", "tenth_envs", "altered")


def plant(name: str, patches, agent, mode: str) -> None:
    env = agent.env
    if name == "unchanged":
        if mode == "train":
            patches.set(agent, "_make_optimizer", _frozen_optimizer(agent._make_optimizer))
        else:
            patches.set(env, "step", lambda state, actions: state)
    elif name == "half_batch":
        if mode == "train":
            patches.set(agent, "_amp_minibatch_size", agent._amp_minibatch_size // 2)
            patches.wrap(agent, "_gather_minibatch", _half_minibatch(agent.minibatch_size))
        else:
            patches.wrap(env, "step", _partial_step(lambda B: B // 2))
    elif name == "tenth_envs":
        patches.wrap(env, "step", _partial_step(lambda B: B - max(1, B // 10)))
    elif name == "altered":
        patches.wrap(agent, "_actor_sigma", _altered_actor)
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")


def _frozen_optimizer(make):
    def wrapper():
        opt = make()
        opt.step = lambda *a, **k: None
        return opt
    return wrapper


def _half_minibatch(rows: int):
    """The minibatch's rows cut to their first half (its AMP rows are
    halved by the halved AMP minibatch size the gather reads)."""
    def make(fn):
        def wrapper(dataset, idx):
            mb = fn(dataset, idx)
            return {k: (v[:rows // 2] if v.dim() and v.shape[0] == rows else v)
                    for k, v in mb.items()}
        return wrapper
    return make


def _partial_step(stepped):
    """The env step applied to the first ``stepped(B)`` envs only."""
    return lambda fn: _partial(fn, stepped)


def _partial(fn, stepped):
    def wrapper(state, actions):
        new = fn(state, actions)
        B = actions.shape[0]
        keep = torch.arange(B, device=actions.device) < stepped(B)

        def pick(a, b):
            if isinstance(a, torch.Tensor):
                if a.dim() == 0 or a.shape[0] != B:
                    return a
                return torch.where(keep.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
            if isinstance(a, dict):
                return {k: pick(v, b[k]) for k, v in a.items()}
            return type(a)(*(pick(x, y) for x, y in zip(a, b)))

        return type(new)(**{f: pick(getattr(new, f), getattr(state, f))
                            for f in new.__dataclass_fields__})
    return wrapper


def _altered_actor(fn):
    def wrapper(obs_n, roll):
        mu, log_sigma = fn(obs_n, roll)
        mu = mu.clone()
        mu[0, 0] += 0.5
        return mu, log_sigma
    return wrapper
