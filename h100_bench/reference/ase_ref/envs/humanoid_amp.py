"""HumanoidAMP: AMP observation history + reference state init (port of
``ase_tpu/envs/humanoid_amp.py``).

Keeps the rolling ``numAMPObsSteps`` window of per-step AMP features, the
discriminator's demo windows from the motion library (``fetch_amp_obs_demo``,
its draws through ``_draw_demo``), and Reference State Initialization
(Default / Start / Random / Hybrid), with the reference's default two-query
reset: one motion query for the RSI frame, one for the (steps - 1) history
frames at -dt offsets.
"""

from __future__ import annotations

import enum
from typing import Dict, Tuple

import torch

from h100_bench.reference.ase_ref.envs import obs as obs_kernels
from h100_bench.reference.ase_ref.envs.humanoid import EnvState, Humanoid, where_phys
from h100_bench.reference.ase_ref.motion import motion_lib as ml
from h100_bench.reference.ase_ref.ops import quat as rot
from h100_bench.reference.ase_ref.physics import dynamics


class StateInit(enum.Enum):
    Default = 0
    Start = 1
    Random = 2
    Hybrid = 3


class HumanoidAMP(Humanoid):
    def __init__(self, cfg, device="cuda"):
        env_cfg = cfg["env"]
        self._state_init = StateInit[env_cfg["stateInit"]]
        self._hybrid_init_prob = float(env_cfg.get("hybridInitProb", 0.5))
        self._num_amp_obs_steps = int(env_cfg["numAMPObsSteps"])
        if self._num_amp_obs_steps < 2:
            raise ValueError("numAMPObsSteps must be >= 2")
        super().__init__(cfg, device=device)
        self._num_amp_obs_per_step = (
            13 + 6 * (len(self.model.dof_offsets) - 1) + self.model.nd
            + 3 * len(env_cfg["keyBodies"]))
        self._load_motion(env_cfg["motion_file"])

    def get_num_amp_obs(self) -> int:
        return self._num_amp_obs_steps * self._num_amp_obs_per_step

    def amp_obs_size(self) -> int:
        return self.get_num_amp_obs()

    def _load_motion(self, motion_file: str):
        from h100_bench.reference.ase_ref.utils import paths

        self._motion_lib = ml.load_motion_lib(
            paths.motion_file(motion_file), self.model.dof_body_ids,
            self.model.dof_offsets, self._key_body_ids.tolist(), device=self.device)

    # -- AMP observations --------------------------------------------------------

    def _update_aux(self, state: EnvState) -> EnvState:
        state = super()._update_aux(state)
        buf = torch.roll(state.aux["amp_obs"], 1, dims=1)
        buf[:, 0] = self._compute_amp_observations(state)
        return state.replace(aux={**state.aux, "amp_obs": buf})

    def _compute_amp_observations(self, state: EnvState) -> torch.Tensor:
        dof_pos = dynamics.dof_pos_batched(self.model, self._tables.dof, state.phys)
        dof_vel = state.phys.u[:, self.model.root_dofs:self.model.nu]
        return obs_kernels.build_amp_observations(
            state.body_pos[:, 0, :], state.body_quat[:, 0, :],
            state.body_vel[:, 0, :], state.body_ang_vel[:, 0, :],
            dof_pos, dof_vel, state.body_pos[:, self._key_body_ids, :],
            self._local_root_obs, self._root_height_obs, self.model.dof_offsets)

    def amp_obs_flat(self, state: EnvState) -> torch.Tensor:
        return state.aux["amp_obs"].reshape(state.aux["amp_obs"].shape[0], -1)

    def _history_amp_obs(self, motion_ids, times0, steps: int) -> torch.Tensor:
        """The reset history: AMP features at times0 - dt * (1..steps),
        (n, steps, D)."""
        offs = -self.dt * (torch.arange(steps, device=self.device) + 1)
        return self._amp_obs_at(motion_ids, times0, offs)

    # -- demo fetch (humanoid_amp.py:105-124) -------------------------------------

    def _draw_demo(self, n: int) -> Dict[str, torch.Tensor]:
        """Random numbers one demo fetch of ``n`` rows consumes (replicated:
        the demo buffer is the same on every rank)."""
        gen = self.replicated_gen
        return {"motion_ids": ml.sample_motions(self._motion_lib, gen, n),
                "motion_phase": torch.rand(n, generator=gen, device=self.device)}

    def fetch_amp_obs_demo(self, n: int) -> torch.Tensor:
        """(n, amp_obs_size) AMP windows of random clips at random times."""
        d = self._draw_demo(n)
        truncate_time = self.dt * (self._num_amp_obs_steps - 1)
        times0 = ml.sample_time(self._motion_lib, d["motion_phase"], d["motion_ids"],
                                truncate_time) + truncate_time
        return self.build_amp_obs_demo(d["motion_ids"], times0).reshape(n, -1)

    def build_amp_obs_demo(self, motion_ids: torch.Tensor, times0: torch.Tensor) -> torch.Tensor:
        """AMP features at times0 - dt * (0..steps-1), (n, steps, D)."""
        steps = self._num_amp_obs_steps
        offs = -self.dt * torch.arange(steps, device=self.device)
        return self._amp_obs_at(motion_ids, times0, offs)

    def _amp_obs_at(self, motion_ids, times0, offs) -> torch.Tensor:
        """AMP features of each clip at times0 + offs, (n, len(offs), D)."""
        n, steps = motion_ids.shape[0], offs.shape[0]
        ids = motion_ids[:, None].expand(n, steps).reshape(-1)
        times = (times0[:, None] + offs[None, :]).reshape(-1)
        ms = ml.get_motion_state(self._motion_lib, ids, times)
        return obs_kernels.build_amp_observations(
            ms["root_pos"], ms["root_rot"], ms["root_vel"], ms["root_ang_vel"],
            ms["dof_pos"], ms["dof_vel"], ms["key_pos"],
            self._local_root_obs, self._root_height_obs, self.model.dof_offsets,
        ).reshape(n, steps, -1)

    # -- resets ----------------------------------------------------------------------

    def _draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        d = super()._draw_reset(n)
        if self._state_init != StateInit.Default:
            d["motion_ids"] = ml.sample_motions(self._motion_lib, self.gen, n)
            d["motion_phase"] = torch.rand(n, generator=self.gen, device=self.device)
            d["u_hybrid"] = torch.rand(n, generator=self.gen, device=self.device)
        return d

    def _ref_state_phys(self, ms) -> dynamics.State:
        """Batched physics state from a motion-state dict."""
        B = ms["root_pos"].shape[0]
        T = self._tables.dof
        s = dynamics.default_state(self.model, B)
        joint_q = s.joint_q.clone()
        hinge_q = s.hinge_q.clone()
        if len(T.sph_rows):
            joint_q[:, T.sph_rows] = rot.exp_map_to_quat(
                ms["dof_pos"][:, T.sph_cols].reshape(B, -1, 3))
        if len(T.hin_rows):
            hinge_q[:, T.hin_rows] = ms["dof_pos"][:, T.hin_cols]
        u = s.u.clone()
        u[:, self.model.root_dofs:self.model.nu] = ms["dof_vel"]
        u[:, 0:3] = ms["root_vel"]
        u[:, 3:6] = ms["root_ang_vel"]
        return s._replace(root_pos=ms["root_pos"], root_quat=ms["root_rot"],
                          joint_q=joint_q, hinge_q=hinge_q, u=u)

    def _reset_actors(self, state: EnvState, mask, draws) -> Tuple[EnvState, torch.Tensor]:
        B = mask.shape[0]
        if self._state_init == StateInit.Default:
            phys = self.default_phys_state(B)
            ref_mask = torch.zeros(B, dtype=torch.bool, device=self.device)
            motion_ids = torch.zeros(B, dtype=torch.long, device=self.device)
            motion_times = torch.zeros(B, device=self.device)
        else:
            motion_ids = draws["motion_ids"]
            if self._state_init == StateInit.Start:
                motion_times = torch.zeros(B, device=self.device)
            else:
                motion_times = ml.sample_time(self._motion_lib, draws["motion_phase"], motion_ids)
            ms = ml.get_motion_state(self._motion_lib, motion_ids, motion_times)
            phys = self._ref_state_phys(ms)
            if self._state_init in (StateInit.Start, StateInit.Random):
                ref_mask = torch.ones(B, dtype=torch.bool, device=self.device)
            else:
                ref_mask = draws["u_hybrid"] < self._hybrid_init_prob
                phys = where_phys(ref_mask, phys, self.default_phys_state(B))
        aux = {**state.aux, "reset_ref_mask": ref_mask & mask,
               "reset_motion_ids": motion_ids, "reset_motion_times": motion_times}
        return state.replace(phys=phys, aux=aux), mask

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = super()._initial_aux(B)
        aux["amp_obs"] = torch.zeros(B, self._num_amp_obs_steps, self._num_amp_obs_per_step,
                                     device=self.device)
        aux["reset_ref_mask"] = torch.zeros(B, dtype=torch.bool, device=self.device)
        aux["reset_motion_ids"] = torch.zeros(B, dtype=torch.long, device=self.device)
        aux["reset_motion_times"] = torch.zeros(B, device=self.device)
        return aux

    def _post_reset(self, state: EnvState, mask: torch.Tensor) -> EnvState:
        state = super()._post_reset(state, mask)
        return self._init_amp_obs(state, mask)

    def _init_amp_obs(self, state: EnvState, mask: torch.Tensor) -> EnvState:
        """Fill the history window of freshly reset envs."""
        steps = self._num_amp_obs_steps
        curr = self._compute_amp_observations(state)
        hist_ref = self._history_amp_obs(state.aux["reset_motion_ids"],
                                         state.aux["reset_motion_times"], steps - 1)
        hist_default = curr[:, None, :].expand(-1, steps - 1, -1)
        new_hist = torch.where(state.aux["reset_ref_mask"][:, None, None], hist_ref,
                               hist_default)
        new_buf = torch.cat([curr[:, None], new_hist], dim=1)
        buf = torch.where(mask[:, None, None], new_buf, state.aux["amp_obs"])
        return state.replace(aux={**state.aux, "amp_obs": buf})
