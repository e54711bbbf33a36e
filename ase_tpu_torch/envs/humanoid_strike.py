"""HumanoidStrike: knock over a target block with the sword (port of
``ase_tpu/envs/humanoid_strike.py``).

The target is a free box prop (0.4 x 0.4 x 1.8 m, density 30) placed at
every reset near (0.5-1.5 m, half the time) or far (0.5-10 m) from the
character at a random heading and yaw, its draws through one
``_draw_target`` that the reset pass takes inside ``_draw_reset``.
15-dim task obs (the heading-local target position, rotation as tangent
and normal, linear and angular velocity); reward 0.6 tip-over + 0.4
approach velocity, 1 once the target's up axis is within cos 0.2 of
horizontal, which is also ``aux['successes']``. Early termination adds
the reference's target-contact failure: the target pushed sideways while
a body other than the feet and the strike bodies touches something.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ase_tpu_torch.envs.humanoid import EnvState
from ase_tpu_torch.envs.humanoid_amp_task import HumanoidAMPTask
from ase_tpu_torch.ops import quat as rot
from ase_tpu_torch.physics import mjcf


class HumanoidStrike(HumanoidAMPTask):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device=device)
        self._tar_dist_min = 0.5
        self._tar_dist_max = 10.0
        self._near_dist = 1.5
        self._near_prob = 0.5
        strike_ids = [self.model.body_index(b) for b in cfg["env"]["strikeBodyNames"]]
        # bodies whose contact with anything fails a strike that moved the target
        mask = self._contact_mask.clone()
        mask[strike_ids] = False
        self._nonstrike_mask = mask

    def _build_model(self, asset_path: str):
        target = mjcf.box_prop([0.2, 0.2, 0.9], density=30.0)
        return mjcf.add_props(super()._build_model(asset_path), [target])

    def get_task_obs_size(self) -> int:
        return 15 if self._enable_task_obs else 0

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = super()._initial_aux(B)
        aux["prev_root_pos"] = torch.zeros(B, 3, device=self.device)
        aux["successes"] = torch.zeros(B, device=self.device)
        return aux

    # -- target placement (humanoid_strike.py:60-92) --------------------------------

    def _draw_target(self, n: int) -> Dict[str, torch.Tensor]:
        """Random numbers one target placement over ``n`` envs consumes."""
        u = torch.rand(n, 4, generator=self.gen, device=self.device)
        dist_max = torch.where(u[:, 0] < self._near_prob, self._near_dist, self._tar_dist_max)
        return {"target_dist": (dist_max - self._tar_dist_min) * u[:, 1] + self._tar_dist_min,
                "target_theta": 2 * math.pi * u[:, 2],
                "target_yaw": 2 * math.pi * u[:, 3]}

    def _draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        d = super()._draw_reset(n)
        d.update(self._draw_target(n))
        return d

    def _reset_actors(self, state: EnvState, mask, draws) -> Tuple[EnvState, torch.Tensor]:
        new_state, mask = super()._reset_actors(state, mask, draws)
        phys = new_state.phys
        dist, theta = draws["target_dist"], draws["target_theta"]
        tar_xy = phys.root_pos[:, 0:2] + torch.stack(
            [dist * torch.cos(theta), dist * torch.sin(theta)], -1)
        tar_pos = torch.cat([tar_xy, torch.full_like(tar_xy[:, :1], 0.9)], -1)
        up = torch.zeros_like(tar_pos)
        up[:, 2] = 1.0
        prop_pos, prop_quat, u = phys.prop_pos.clone(), phys.prop_quat.clone(), phys.u.clone()
        prop_pos[:, 0] = tar_pos
        prop_quat[:, 0] = rot.quat_from_angle_axis(draws["target_yaw"], up)
        u[:, self.model.nu:self.model.nu + 6] = 0.0
        return new_state.replace(
            phys=phys._replace(prop_pos=prop_pos, prop_quat=prop_quat, u=u)), mask

    # -- stepping ---------------------------------------------------------------------

    def _update_task(self, state: EnvState) -> EnvState:
        return state.replace(aux={**state.aux, "prev_root_pos": state.body_pos[:, 0, :]})

    def _target_states(self, state: EnvState):
        """The target's position, rotation, linear and angular velocity."""
        nu, u = self.model.nu, state.phys.u
        return (state.phys.prop_pos[:, 0], state.phys.prop_quat[:, 0], u[:, nu:nu + 3],
                u[:, nu + 3:nu + 6])

    @staticmethod
    def _tilt_cos(tar_rot: torch.Tensor) -> torch.Tensor:
        """(B,) cosine of the angle between the target's up axis and z."""
        up = torch.zeros(tar_rot.shape[0], 3, device=tar_rot.device)
        up[:, 2] = 1.0
        return torch.sum(up * rot.quat_rotate(tar_rot, up), dim=-1)

    def post_physics_step(self, state: EnvState) -> EnvState:
        state = super().post_physics_step(state)
        tilt = self._tilt_cos(state.phys.prop_quat[:, 0])
        return state.replace(aux={**state.aux, "successes": (tilt < 0.2).to(torch.float32)})

    def _compute_task_obs(self, state: EnvState) -> torch.Tensor:
        root_pos = state.body_pos[:, 0, :]
        tar_pos, tar_rot, tar_vel, tar_ang = self._target_states(state)
        heading_rot = rot.calc_heading_quat_inv(state.body_quat[:, 0, :])
        local_tar_pos = torch.cat([tar_pos[:, 0:2] - root_pos[:, 0:2], tar_pos[:, 2:3]], -1)
        return torch.cat([
            rot.quat_rotate(heading_rot, local_tar_pos),
            rot.quat_to_tan_norm(rot.quat_mul(heading_rot, tar_rot)),
            rot.quat_rotate(heading_rot, tar_vel),
            rot.quat_rotate(heading_rot, tar_ang),
        ], dim=-1)

    def _compute_reward(self, state: EnvState) -> torch.Tensor:
        tar_speed, vel_err_scale = 1.0, 4.0
        tar_rot_w, vel_reward_w = 0.6, 0.4
        tar_pos, tar_rot, _, _ = self._target_states(state)
        root_pos = state.body_pos[:, 0, :]

        tar_rot_err = self._tilt_cos(tar_rot)
        tar_rot_r = torch.clamp(1.0 - tar_rot_err, min=0.0)

        tar_dir = tar_pos[:, 0:2] - root_pos[:, 0:2]
        tar_dir = tar_dir / torch.clamp(torch.linalg.norm(tar_dir, dim=-1, keepdim=True), min=1e-8)
        root_vel = (root_pos - state.aux["prev_root_pos"]) / self.dt
        tar_dir_speed = torch.sum(tar_dir * root_vel[:, :2], dim=-1)
        tar_vel_err = torch.clamp(tar_speed - tar_dir_speed, min=0.0)
        vel_reward = torch.exp(-vel_err_scale * tar_vel_err ** 2)
        vel_reward = torch.where(tar_dir_speed <= 0, torch.zeros_like(vel_reward), vel_reward)

        reward = tar_rot_w * tar_rot_r + vel_reward_w * vel_reward
        return torch.where(tar_rot_err < 0.2, torch.ones_like(reward), reward)

    def _compute_reset(self, state: EnvState):
        """The humanoid's resets, plus the target-contact failure
        (humanoid_strike.py:159-179)."""
        reset, term = super()._compute_reset(state)
        if not self._enable_early_termination:
            return reset, term
        threshold = 1.0
        nb = self.model.nb
        tar_contact = torch.any(torch.abs(state.contact_forces[:, nb, 0:2]) > threshold, dim=-1)
        nonstrike = state.contact_forces[:, :nb] * self._nonstrike_mask[None, :, None]
        nonstrike_contact = torch.any(torch.abs(nonstrike).reshape(nonstrike.shape[0], -1)
                                      > threshold, dim=-1)
        fail = tar_contact & nonstrike_contact & (state.progress > 1)
        one = torch.ones_like(reset)
        return torch.where(fail, one, reset), torch.where(fail, one, term)
