"""HumanoidHeading: move in a target direction at a target speed while
facing another direction (port of ``ase_tpu/envs/humanoid_heading.py``).

5-dim task obs (the heading-local target direction, the target speed, the
heading-local facing direction); reward 0.7 direction + 0.3 facing; the
goal is resampled every [headingChangeStepsMin, headingChangeStepsMax)
steps and on reset.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from h100_bench.reference.ase_ref.envs.humanoid import EnvState
from h100_bench.reference.ase_ref.envs.humanoid_amp_task import HumanoidAMPTask
from h100_bench.reference.ase_ref.ops import quat as rot


class HumanoidHeading(HumanoidAMPTask):
    def __init__(self, cfg, device="cuda"):
        env_cfg = cfg["env"]
        self._tar_speed_min = float(env_cfg["tarSpeedMin"])
        self._tar_speed_max = float(env_cfg["tarSpeedMax"])
        self._heading_change_steps_min = int(env_cfg["headingChangeStepsMin"])
        self._heading_change_steps_max = int(env_cfg["headingChangeStepsMax"])
        self._enable_rand_heading = bool(env_cfg["enableRandHeading"])
        super().__init__(cfg, device=device)

    def get_task_obs_size(self) -> int:
        return 5 if self._enable_task_obs else 0

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = super()._initial_aux(B)
        x = torch.tensor([1.0, 0.0], device=self.device).repeat(B, 1)
        aux["tar_dir"] = x
        aux["tar_facing_dir"] = x.clone()
        aux["tar_speed"] = torch.ones(B, device=self.device)
        aux["heading_change_steps"] = torch.zeros(B, dtype=torch.int32, device=self.device)
        aux["prev_root_pos"] = torch.zeros(B, 3, device=self.device)
        return aux

    def _draw_goal(self, n: int) -> Dict[str, torch.Tensor]:
        if self._enable_rand_heading:
            theta = self._uniform(n, -math.pi, math.pi)
            face_theta = self._uniform(n, -math.pi, math.pi)
        else:
            theta = face_theta = torch.zeros(n, device=self.device)
        return {"goal_theta": theta, "goal_face_theta": face_theta,
                "goal_speed": self._uniform(n, self._tar_speed_min, self._tar_speed_max),
                "goal_change_steps": self._randint(n, self._heading_change_steps_min,
                                                   self._heading_change_steps_max)}

    def _resample_goal(self, state: EnvState, mask: torch.Tensor, d) -> EnvState:
        aux = dict(state.aux)

        def unit(a):
            return torch.stack([torch.cos(a), torch.sin(a)], -1)

        aux["tar_dir"] = self._masked(mask, unit(d["goal_theta"]), aux["tar_dir"])
        aux["tar_facing_dir"] = self._masked(mask, unit(d["goal_face_theta"]),
                                             aux["tar_facing_dir"])
        aux["tar_speed"] = self._masked(mask, d["goal_speed"], aux["tar_speed"])
        aux["heading_change_steps"] = self._masked(
            mask, state.progress + d["goal_change_steps"], aux["heading_change_steps"])
        return state.replace(aux=aux)

    def _update_task(self, state: EnvState) -> EnvState:
        mask = state.progress >= state.aux["heading_change_steps"]
        state = self._resample_goal(state, mask, self._draw_goal(self.num_envs))
        return state.replace(aux={**state.aux, "prev_root_pos": state.body_pos[:, 0, :]})

    def _reset_task(self, state: EnvState, mask: torch.Tensor, draws) -> EnvState:
        return self._resample_goal(state, mask, draws)

    def _compute_task_obs(self, state: EnvState) -> torch.Tensor:
        heading_rot = rot.calc_heading_quat_inv(state.body_quat[:, 0, :])
        zero = torch.zeros_like(state.aux["tar_dir"][:, :1])
        local_tar = rot.quat_rotate(heading_rot, torch.cat([state.aux["tar_dir"], zero], -1))
        local_face = rot.quat_rotate(heading_rot,
                                     torch.cat([state.aux["tar_facing_dir"], zero], -1))
        return torch.cat([local_tar[:, 0:2], state.aux["tar_speed"][:, None],
                          local_face[:, 0:2]], dim=-1)

    def _compute_reward(self, state: EnvState) -> torch.Tensor:
        vel_err_scale, tangent_err_w = 0.25, 0.1
        dir_reward_w, facing_reward_w = 0.7, 0.3
        root_vel = (state.body_pos[:, 0, :] - state.aux["prev_root_pos"]) / self.dt
        tar_dir, tar_speed = state.aux["tar_dir"], state.aux["tar_speed"]

        tar_dir_speed = torch.sum(tar_dir * root_vel[:, :2], dim=-1)
        tangent_vel = root_vel[:, :2] - tar_dir_speed[:, None] * tar_dir
        tangent_speed = torch.sum(tangent_vel, dim=-1)
        tar_vel_err = tar_speed - tar_dir_speed
        dir_reward = torch.exp(-vel_err_scale * (tar_vel_err ** 2
                                                 + tangent_err_w * tangent_speed ** 2))
        dir_reward = torch.where(tar_dir_speed <= 0, torch.zeros_like(dir_reward), dir_reward)

        facing_err = torch.sum(state.aux["tar_facing_dir"] * self._root_facing_dir(state), -1)
        facing_reward = torch.clamp(facing_err, min=0.0)
        return dir_reward_w * dir_reward + facing_reward_w * facing_reward
