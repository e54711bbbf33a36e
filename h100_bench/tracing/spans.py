"""Spans and counters the harness wraps around calls into the program.

Spans are ``torch.profiler.record_function`` ranges, so they land in the
traced window's Chrome trace beside the kernels; they are installed for the
traced window only. Counters are plain Python integers kept by wrappers,
so they need no device sync. Every wrapper is undone by ``Patches.undo``.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, List, Tuple

import torch

SPAN_NAMES = ("player.step", "rollout.step", "env.step", "env.reset_done", "agent.policy",
              "agent.update", "engine.step_batched")


class Patches:
    """Attribute replacements on objects and modules, undone in reverse."""

    def __init__(self):
        self._undo: List[Tuple[Any, str, Any, bool]] = []

    def set(self, owner, name: str, value) -> None:
        had = name in vars(owner)
        self._undo.append((owner, name, getattr(owner, name), had))
        setattr(owner, name, value)

    def wrap(self, owner, name: str, make: Callable[[Callable], Callable]) -> None:
        self.set(owner, name, make(getattr(owner, name)))

    def undo(self) -> None:
        while self._undo:
            owner, name, old, had = self._undo.pop()
            if had:
                setattr(owner, name, old)
            else:
                delattr(owner, name)


def spanned(name: str) -> Callable[[Callable], Callable]:
    def make(fn):
        def wrapper(*args, **kw):
            with torch.profiler.record_function(name):
                return fn(*args, **kw)
        return wrapper
    return make


class OpenSpan:
    """A span opened and closed at two different places (a rollout step
    runs from one ``reset_done`` call to the next)."""

    def __init__(self, name: str):
        self.name = name
        self._ctx = None

    def restart(self) -> None:
        self.close()
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()

    def close(self) -> None:
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None


@contextlib.contextmanager
def layer_spans(env, agent):
    """Spans around the program's layers: the env's step and reset pass,
    the agent's policy and update, the engine's tick."""
    from ase_tpu_torch.physics import engine

    local = Patches()
    local.wrap(env, "step", spanned("env.step"))
    local.wrap(env, "reset_done", spanned("env.reset_done"))
    local.wrap(agent, "_actor_sigma", spanned("agent.policy"))
    local.wrap(agent, "_update_phase", spanned("agent.update"))
    local.wrap(engine, "step_batched", spanned("engine.step_batched"))
    try:
        yield
    finally:
        local.undo()
