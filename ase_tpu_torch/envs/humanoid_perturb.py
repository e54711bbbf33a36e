"""HumanoidPerturb: box projectiles thrown at the character (port of
``ase_tpu/envs/humanoid_perturb.py``).

13 free box props per env (12 small, 0.2 m at density 200; one large,
0.5 m at density 100), parked at x = 200 + i, are launched at the torso on
the fixed ``PERTURB_OBJS`` schedule from 4-5 m away at 0.25-2 m height and
30-40 m/s. Every step draws a launch (origin, aim noise and speed) through
one ``_draw_perturb``, as the reference draws every step, launch or not.
Early termination is off: an episode ends at its length only.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ase_tpu_torch.envs.humanoid import EnvState
from ase_tpu_torch.envs.humanoid_amp import HumanoidAMP
from ase_tpu_torch.ops import quat as rot
from ase_tpu_torch.physics import mjcf

# (size class, steps after the previous launch)
PERTURB_OBJS = [
    ("small", 60), ("small", 7), ("small", 10), ("small", 35), ("small", 2),
    ("small", 2), ("small", 3), ("small", 2), ("small", 2), ("small", 3),
    ("small", 2), ("large", 60), ("small", 300),
]


class HumanoidPerturb(HumanoidAMP):
    def __init__(self, cfg, device="cuda"):
        super().__init__(cfg, device=device)
        self._proj_dist_min, self._proj_dist_max = 4.0, 5.0
        self._proj_h_min, self._proj_h_max = 0.25, 2.0
        self._proj_speed_min, self._proj_speed_max = 30.0, 40.0
        times = np.cumsum([gap for _, gap in PERTURB_OBJS])
        self._perturb_timesteps = torch.as_tensor(times, dtype=torch.int32, device=self.device)
        self._perturb_period = int(times[-1]) + 1

    def _build_model(self, asset_path: str):
        props = [mjcf.box_prop([0.1] * 3, density=200.0) if kind == "small"
                 else mjcf.box_prop([0.25] * 3, density=100.0) for kind, _ in PERTURB_OBJS]
        return mjcf.add_props(super()._build_model(asset_path), props)

    def default_phys_state(self, batch: int):
        phys = super().default_phys_state(batch)
        park = torch.tensor([[200.0 + i, 0.0, 1.0] for i in range(len(PERTURB_OBJS))],
                            device=self.device)
        return phys._replace(prop_pos=park.expand(batch, -1, -1).clone())

    def _draw_perturb(self, n: int) -> Dict[str, torch.Tensor]:
        """Random numbers one step's launch over ``n`` envs consumes."""
        u = torch.rand(n, 4, generator=self.gen, device=self.device)
        return {"theta": 2 * math.pi * u[:, 0],
                "dist": (self._proj_dist_max - self._proj_dist_min) * u[:, 1] + self._proj_dist_min,
                "height": (self._proj_h_max - self._proj_h_min) * u[:, 2] + self._proj_h_min,
                "aim_noise": torch.randn(n, 3, generator=self.gen, device=self.device),
                "speed": ((self._proj_speed_max - self._proj_speed_min) * u[:, 3:4]
                          + self._proj_speed_min)}

    def post_physics_step(self, state: EnvState) -> EnvState:
        return super().post_physics_step(self._update_proj(state, self._draw_perturb(self.num_envs)))

    def _update_proj(self, state: EnvState, d) -> EnvState:
        """Launch the projectile due at this step of the schedule, if any,
        at the torso (body 1)."""
        curr = torch.remainder(state.progress, self._perturb_period)
        launch = curr[:, None] == self._perturb_timesteps[None, :]        # (B, np)
        root = state.body_pos[:, 0, :]
        pos = torch.stack([root[:, 0] + d["dist"] * torch.cos(d["theta"]),
                           root[:, 1] - d["dist"] * torch.sin(d["theta"]), d["height"]], -1)
        launch_dir = state.body_pos[:, 1, :] - pos + 0.1 * d["aim_noise"]
        launch_dir = launch_dir / torch.clamp(
            torch.linalg.norm(launch_dir, dim=-1, keepdim=True), min=1e-8)
        vel = d["speed"] * launch_dir
        vel[:, 0:2] += state.body_vel[:, 1, 0:2]

        phys = state.phys
        B, P = launch.shape
        m = launch[:, :, None]
        prop_pos = torch.where(m, pos[:, None, :], phys.prop_pos)
        prop_quat = torch.where(m, rot.quat_identity((B, P), device=self.device), phys.prop_quat)
        blk = torch.cat([vel, torch.zeros_like(vel)], -1)[:, None, :]
        nu = self.model.nu
        u_prop = torch.where(m, blk, phys.u[:, nu:].reshape(B, P, 6)).reshape(B, -1)
        u = torch.cat([phys.u[:, :nu], u_prop], -1)
        return state.replace(phys=phys._replace(prop_pos=prop_pos, prop_quat=prop_quat, u=u))

    def _compute_reset(self, state: EnvState):
        reset = (state.progress >= self.max_episode_length - 1).to(torch.int32)
        return reset, torch.zeros_like(reset)
