"""HumanoidReach: bring a body (the sword) to a target point (port of
``ase_tpu/envs/humanoid_reach.py``).

3-dim task obs (the target in the root's heading frame, not offset by the
root position, as the reference has it); reward ``exp(-4 |target - body|^2)``;
the target is resampled in a box around the origin every
[tarChangeStepsMin, tarChangeStepsMax) steps and on reset.
"""

from __future__ import annotations

from typing import Dict

import torch

from ase_tpu_torch.envs.humanoid import EnvState
from ase_tpu_torch.envs.humanoid_amp_task import HumanoidAMPTask
from ase_tpu_torch.ops import quat as rot


class HumanoidReach(HumanoidAMPTask):
    def __init__(self, cfg, device="cuda"):
        env_cfg = cfg["env"]
        self._tar_change_steps_min = int(env_cfg["tarChangeStepsMin"])
        self._tar_change_steps_max = int(env_cfg["tarChangeStepsMax"])
        self._tar_dist_max = float(env_cfg["tarDistMax"])
        self._tar_height_min = float(env_cfg["tarHeightMin"])
        self._tar_height_max = float(env_cfg["tarHeightMax"])
        self._reach_body_name = env_cfg["reachBodyName"]
        super().__init__(cfg, device=device)
        self._reach_body_id = self.model.body_index(self._reach_body_name)

    def get_task_obs_size(self) -> int:
        return 3 if self._enable_task_obs else 0

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = super()._initial_aux(B)
        aux["tar_pos"] = torch.zeros(B, 3, device=self.device)
        aux["tar_change_steps"] = torch.zeros(B, dtype=torch.int32, device=self.device)
        return aux

    def _draw_goal(self, n: int) -> Dict[str, torch.Tensor]:
        r = torch.rand(n, 3, generator=self.gen, device=self.device)
        xy = self._tar_dist_max * (2.0 * r[:, 0:2] - 1.0)
        z = (self._tar_height_max - self._tar_height_min) * r[:, 2:3] + self._tar_height_min
        return {"goal_pos": torch.cat([xy, z], dim=-1),
                "goal_change_steps": self._randint(n, self._tar_change_steps_min,
                                                   self._tar_change_steps_max)}

    def _resample_goal(self, state: EnvState, mask: torch.Tensor, d) -> EnvState:
        aux = dict(state.aux)
        aux["tar_pos"] = self._masked(mask, d["goal_pos"], aux["tar_pos"])
        aux["tar_change_steps"] = self._masked(
            mask, state.progress + d["goal_change_steps"], aux["tar_change_steps"])
        return state.replace(aux=aux)

    def _update_task(self, state: EnvState) -> EnvState:
        mask = state.progress >= state.aux["tar_change_steps"]
        return self._resample_goal(state, mask, self._draw_goal(self.num_envs))

    def _reset_task(self, state: EnvState, mask: torch.Tensor, draws) -> EnvState:
        return self._resample_goal(state, mask, draws)

    def _compute_task_obs(self, state: EnvState) -> torch.Tensor:
        heading_rot = rot.calc_heading_quat_inv(state.body_quat[:, 0, :])
        return rot.quat_rotate(heading_rot, state.aux["tar_pos"])

    def _compute_reward(self, state: EnvState) -> torch.Tensor:
        diff = state.aux["tar_pos"] - state.body_pos[:, self._reach_body_id, :]
        return torch.exp(-4.0 * torch.sum(diff * diff, dim=-1))
