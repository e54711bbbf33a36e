"""HumanoidLocation: walk to a target position on the ground (port of
``ase_tpu/envs/humanoid_location.py``).

2-dim task obs (the heading-local target offset); reward 0.5 position +
0.4 velocity toward the target + 0.1 facing it, with velocity and facing
full within reach of the target; the target is resampled within
``tarDistMax`` of the character every [tarChangeStepsMin,
tarChangeStepsMax) steps and on reset.
"""

from __future__ import annotations

from typing import Dict

import torch

from ase_tpu_torch.envs.humanoid import EnvState
from ase_tpu_torch.envs.humanoid_amp_task import HumanoidAMPTask
from ase_tpu_torch.ops import quat as rot


class HumanoidLocation(HumanoidAMPTask):
    def __init__(self, cfg, device="cuda"):
        env_cfg = cfg["env"]
        self._tar_speed = float(env_cfg["tarSpeed"])
        self._tar_change_steps_min = int(env_cfg["tarChangeStepsMin"])
        self._tar_change_steps_max = int(env_cfg["tarChangeStepsMax"])
        self._tar_dist_max = float(env_cfg["tarDistMax"])
        super().__init__(cfg, device=device)

    def get_task_obs_size(self) -> int:
        return 2 if self._enable_task_obs else 0

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = super()._initial_aux(B)
        aux["tar_pos"] = torch.zeros(B, 2, device=self.device)
        aux["tar_change_steps"] = torch.zeros(B, dtype=torch.int32, device=self.device)
        aux["prev_root_pos"] = torch.zeros(B, 3, device=self.device)
        return aux

    def _draw_goal(self, n: int) -> Dict[str, torch.Tensor]:
        u = torch.rand(n, 2, generator=self.gen, device=self.device)
        return {"goal_offset": self._tar_dist_max * (2.0 * u - 1.0),
                "goal_change_steps": self._randint(n, self._tar_change_steps_min,
                                                   self._tar_change_steps_max)}

    def _resample_goal(self, state: EnvState, mask: torch.Tensor, d) -> EnvState:
        aux = dict(state.aux)
        aux["tar_pos"] = self._masked(mask, state.body_pos[:, 0, 0:2] + d["goal_offset"],
                                      aux["tar_pos"])
        aux["tar_change_steps"] = self._masked(
            mask, state.progress + d["goal_change_steps"], aux["tar_change_steps"])
        return state.replace(aux=aux)

    def _update_task(self, state: EnvState) -> EnvState:
        mask = state.progress >= state.aux["tar_change_steps"]
        state = self._resample_goal(state, mask, self._draw_goal(self.num_envs))
        return state.replace(aux={**state.aux, "prev_root_pos": state.body_pos[:, 0, :]})

    def _reset_task(self, state: EnvState, mask: torch.Tensor, draws) -> EnvState:
        return self._resample_goal(state, mask, draws)

    def _compute_task_obs(self, state: EnvState) -> torch.Tensor:
        root_pos = state.body_pos[:, 0, :]
        tar = state.aux["tar_pos"]
        tar3d = torch.cat([tar, torch.zeros_like(tar[:, :1])], -1)
        heading_rot = rot.calc_heading_quat_inv(state.body_quat[:, 0, :])
        return rot.quat_rotate(heading_rot, tar3d - root_pos)[:, 0:2]

    def _compute_reward(self, state: EnvState) -> torch.Tensor:
        dist_threshold, pos_err_scale, vel_err_scale = 0.5, 0.5, 4.0
        pos_reward_w, vel_reward_w, face_reward_w = 0.5, 0.4, 0.1
        root_pos = state.body_pos[:, 0, :]

        pos_diff = state.aux["tar_pos"] - root_pos[:, 0:2]
        pos_err = torch.sum(pos_diff * pos_diff, dim=-1)
        pos_reward = torch.exp(-pos_err_scale * pos_err)

        tar_dir = pos_diff / torch.clamp(torch.linalg.norm(pos_diff, dim=-1, keepdim=True),
                                         min=1e-8)
        root_vel = (root_pos - state.aux["prev_root_pos"]) / self.dt
        tar_dir_speed = torch.sum(tar_dir * root_vel[:, :2], dim=-1)
        tar_vel_err = torch.clamp(self._tar_speed - tar_dir_speed, min=0.0)
        vel_reward = torch.exp(-vel_err_scale * tar_vel_err ** 2)
        vel_reward = torch.where(tar_dir_speed <= 0, torch.zeros_like(vel_reward), vel_reward)

        facing_err = torch.sum(tar_dir * self._root_facing_dir(state), dim=-1)
        facing_reward = torch.clamp(facing_err, min=0.0)

        near = pos_err < dist_threshold
        one = torch.ones_like(pos_reward)
        facing_reward = torch.where(near, one, facing_reward)
        vel_reward = torch.where(near, one, vel_reward)
        return pos_reward_w * pos_reward + vel_reward_w * vel_reward + face_reward_w * facing_reward
