"""HumanoidAMPTask: base of the goal-conditioned AMP tasks (port of
``ase_tpu/envs/humanoid_amp_task.py``).

The task observation is concatenated onto the humanoid observation. Each
task keeps its goal in ``aux``: ``_update_task`` runs before the physics
of every step (goals due for a change are resampled), ``_reset_task`` with
every reset pass, after which the reset envs' observations are recomputed
with their new goals. A task draws its goal numbers through one
``_draw_goal(n)``; a reset pass takes them with its other draws (so a
chunked pass draws them even when nothing is flagged, as the reference's
unconditional first pass does).
"""

from __future__ import annotations

from typing import Dict

import torch

from h100_bench.reference.ase_ref.envs.humanoid import EnvState
from h100_bench.reference.ase_ref.envs.humanoid_amp import HumanoidAMP
from h100_bench.reference.ase_ref.ops import quat as rot


class HumanoidAMPTask(HumanoidAMP):
    def __init__(self, cfg, device="cuda"):
        self._enable_task_obs = bool(cfg["env"]["enableTaskObs"])
        super().__init__(cfg, device=device)

    def get_obs_size(self) -> int:
        obs_size = super().get_obs_size()
        if self._enable_task_obs:
            obs_size += self.get_task_obs_size()
        return obs_size

    def get_task_obs_size(self) -> int:
        return 0

    # -- hooks -------------------------------------------------------------------

    def _draw_goal(self, n: int) -> Dict[str, torch.Tensor]:
        """Random numbers one goal resample over ``n`` envs consumes."""
        return {}

    def _update_task(self, state: EnvState) -> EnvState:
        return state

    def _reset_task(self, state: EnvState, mask: torch.Tensor, draws) -> EnvState:
        return state

    # -- overrides -----------------------------------------------------------------

    def _draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        d = super()._draw_reset(n)
        d.update(self._draw_goal(n))
        return d

    def pre_physics_step(self, state, actions):
        state, tgt = super().pre_physics_step(state, actions)
        return self._update_task(state), tgt

    def _reset_envs(self, state: EnvState, mask: torch.Tensor, draws) -> EnvState:
        state = super()._reset_envs(state, mask, draws)
        state = self._reset_task(state, mask, draws)
        obs = self._compute_observations(state)
        return state.replace(obs=torch.where(mask[:, None], obs, state.obs))

    def _compute_observations(self, state: EnvState) -> torch.Tensor:
        humanoid_obs = super()._compute_observations(state)
        if self._enable_task_obs:
            return torch.cat([humanoid_obs, self._compute_task_obs(state)], dim=-1)
        return humanoid_obs

    def _compute_task_obs(self, state: EnvState) -> torch.Tensor:
        raise NotImplementedError

    # -- helpers of the tasks ----------------------------------------------------------

    def _uniform(self, n: int, lo: float, hi: float, *shape) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(n, *shape, generator=self.gen, device=self.device)

    def _randint(self, n: int, lo: int, hi: int) -> torch.Tensor:
        return torch.randint(lo, hi, (n,), generator=self.gen, device=self.device)

    def _root_facing_dir(self, state: EnvState) -> torch.Tensor:
        """(B, 2) the root's x-axis under its heading rotation."""
        root_rot = state.body_quat[:, 0, :]
        x = torch.zeros_like(state.body_pos[:, 0, :])
        x[:, 0] = 1.0
        return rot.quat_rotate(rot.calc_heading_quat(root_rot), x)[:, 0:2]

    @staticmethod
    def _masked(mask: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return torch.where(mask.reshape(mask.shape + (1,) * (old.dim() - 1)), new.to(old.dtype), old)
