"""Gym-style vectorized env adapter (port of ``ase_tpu/envs/vec_env.py``;
reference ``ase/env/tasks/vec_task.py`` / ``vec_task_wrappers.py`` and the
rl_games RLGPUEnv shim in ``run.py:100-148``).

The env's native interface is the functional ``reset_done/step`` API; this
adapter wraps it in the stateful ``step(actions) -> (obs, rew, done, info)``
shape with clipped obs/actions and ``get_env_info`` metadata
(action_space / observation_space / amp_observation_space), for external RL
loops. Tensors stay on the env's device. The adapter draws no random number
of its own: resets and demo fetches draw through the env's ``_draw_*``
methods.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple

import numpy as np
import torch


class BoxSpace(NamedTuple):
    """Minimal gym.spaces.Box stand-in (gym isn't a dependency)."""

    low: np.ndarray
    high: np.ndarray

    @property
    def shape(self):
        return self.low.shape


class VecEnv:
    """Stateful adapter over a functional task env."""

    def __init__(self, task, clip_obs: float = np.inf, clip_actions: float = 1.0):
        self.task = task
        self.clip_obs = clip_obs
        self.clip_actions = clip_actions
        self._state = task.initial_state()

    # -- rl_games-style interface ---------------------------------------------

    def _obs(self):
        return torch.clamp(self._state.obs, -self.clip_obs, self.clip_obs)

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.task.device)
        actions = torch.clamp(actions, -self.clip_actions, self.clip_actions)
        self._state = self.task.step(self._state, actions)
        s = self._state
        info: Dict[str, Any] = {"terminate": s.terminate_buf}
        if hasattr(self.task, "amp_obs_flat"):
            info["amp_obs"] = self.task.amp_obs_flat(s)
        return self._obs(), s.rew, s.reset_buf, info

    def reset(self, env_ids=None):
        """Partial reset: env_ids=None resets everything (reference
        vec_task_wrappers.py:17-33 semantics)."""
        n, dev = self.task.num_envs, self.task.device
        if env_ids is None:
            mask = torch.ones(n, dtype=torch.int32, device=dev)
        else:
            mask = torch.zeros(n, dtype=torch.int32, device=dev)
            mask[torch.as_tensor(env_ids, dtype=torch.long, device=dev)] = 1
        self._state = self.task.reset_done(self._state.replace(reset_buf=mask))
        return self._obs()

    def fetch_amp_obs_demo(self, num_samples: int) -> torch.Tensor:
        return self.task.fetch_amp_obs_demo(num_samples)

    def get_env_info(self) -> Dict[str, Any]:
        na, no = self.task.get_action_size(), self.task.get_obs_size()
        info = {
            "action_space": BoxSpace(-np.ones(na, np.float32), np.ones(na, np.float32)),
            "observation_space": BoxSpace(
                np.full(no, -np.inf, np.float32), np.full(no, np.inf, np.float32)
            ),
        }
        amp = self.task.amp_obs_size()
        if amp:
            info["amp_observation_space"] = BoxSpace(
                np.full(amp, -np.inf, np.float32), np.full(amp, np.inf, np.float32)
            )
        return info

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, state) -> None:
        """Carry a state in (another env's rows, a checkpointed state)."""
        self._state = state
