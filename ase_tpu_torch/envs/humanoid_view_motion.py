"""HumanoidViewMotion: kinematic playback of the motion library through the
env stack (port of ``ase_tpu/envs/humanoid_view_motion.py``), the check of
retargeted motion data.

Each env plays one clip (env i clip i mod M, advancing by num_envs on each
reset) in real time: one sim tick per control step, zero torques under
torque control, then the physics state overwritten from the library at the
clip's time with zeroed velocities. Self-collision is off; an episode
resets when its clip ends. A reset draws no random numbers.
"""

from __future__ import annotations

import copy
from typing import Dict, Tuple

import torch

from ase_tpu_torch.envs.humanoid import EnvState, Humanoid
from ase_tpu_torch.envs.humanoid_amp import HumanoidAMP
from ase_tpu_torch.motion import motion_lib as ml


class HumanoidViewMotion(HumanoidAMP):
    def __init__(self, cfg, device="cuda"):
        cfg = copy.deepcopy(cfg)
        sim_dt = float(cfg.get("sim", {}).get("dt", 1.0 / 60.0))
        # the clip advances at the configured control rate, one tick a step
        self._motion_dt = int(cfg["env"]["controlFrequencyInv"]) * sim_dt
        cfg["env"]["controlFrequencyInv"] = 1
        cfg["env"]["pdControl"] = False
        cfg["env"]["enableSelfCollision"] = False
        super().__init__(cfg, device=device)

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = super()._initial_aux(B)
        # offset by -B: the construction-time full reset advances the ids by
        # B, so the first playback is clips [0, B) (the reference's order)
        aux["motion_ids"] = torch.remainder(
            torch.arange(B, device=self.device) - B, self._motion_lib.num_motions)
        return aux

    def _draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        # the reference's reset splits no key for the motion state here
        return Humanoid._draw_reset(self, n)

    def pre_physics_step(self, state: EnvState, actions: torch.Tensor):
        return state.replace(actions=actions), torch.zeros_like(actions)

    def post_physics_step(self, state: EnvState) -> EnvState:
        return self._motion_sync(super().post_physics_step(state))

    def _motion_times(self, state: EnvState) -> torch.Tensor:
        return state.progress.to(torch.float32) * self._motion_dt

    def _motion_sync(self, state: EnvState) -> EnvState:
        """The physics state at each env's clip time, velocities zeroed."""
        ms = ml.get_motion_state(self._motion_lib, state.aux["motion_ids"],
                                 self._motion_times(state))
        for k in ("root_vel", "root_ang_vel", "dof_vel"):
            ms[k] = torch.zeros_like(ms[k])
        return self._refresh_kinematics(state.replace(phys=self._ref_state_phys(ms)))

    def _compute_reset(self, state: EnvState):
        lengths = self._motion_lib.lengths[state.aux["motion_ids"]]
        reset = (self._motion_times(state) > lengths).to(torch.int32)
        return reset, torch.zeros_like(reset)

    def _reset_actors(self, state: EnvState, mask, draws) -> Tuple[EnvState, torch.Tensor]:
        ids = state.aux["motion_ids"]
        ids = torch.where(mask, torch.remainder(ids + self.num_envs,
                                                self._motion_lib.num_motions), ids)
        aux = {**state.aux, "motion_ids": ids,
               "reset_ref_mask": torch.zeros(mask.shape[0], dtype=torch.bool,
                                             device=self.device)}
        return state.replace(aux=aux), mask
