"""HumanoidAMPGetup: fall-recovery curriculum (port of
``ase_tpu/envs/humanoid_amp_getup.py``).

Fall states are generated once, at the first ``initial_state``, by dropping
every env from a random orientation under random PD targets for 150 sim
ticks; a fraction of resets then start from a cached fall pose, terminated
episodes may continue as recovery episodes, and termination is off during
the recovery window.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from h100_bench.reference.ase_ref.envs.humanoid import EnvState, where_phys
from h100_bench.reference.ase_ref.envs.humanoid_amp import HumanoidAMP
from h100_bench.reference.ase_ref.physics import engine

FALL_TICKS = 150


class HumanoidAMPGetup(HumanoidAMP):
    def __init__(self, cfg, device="cuda"):
        env_cfg = cfg["env"]
        self._recovery_episode_prob = float(env_cfg["recoveryEpisodeProb"])
        self._recovery_steps = int(env_cfg["recoverySteps"])
        self._fall_init_prob = float(env_cfg["fallInitProb"])
        super().__init__(cfg, device=device)
        self._fall_states = None

    def _draw_fall(self, n: int):
        """(normal (n, 4), uniform actions in [-0.5, 0.5) (n, nd)) for the
        fall drop."""
        q = torch.randn(n, 4, generator=self.gen, device=self.device)
        a = torch.rand(n, self.get_action_size(), generator=self.gen,
                       device=self.device) - 0.5
        return q, a

    def generate_fall_states(self):
        """Drop every env from a random orientation for FALL_TICKS sim ticks
        (``humanoid_amp_getup.py:36``); cache the poses with zero velocity."""
        B = self.num_envs
        q, rand_actions = self._draw_fall(B)
        q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
        phys = self.default_phys_state(B)._replace(root_quat=q)
        tgt = self._pd_action_offset[None] + self._pd_action_scale[None] * rand_actions
        kin = None
        for _ in range(FALL_TICKS):
            out = engine.step_batched(self.model, self.sim_cfg, self._tables, phys, tgt,
                                      kin0=kin)
            phys, kin = out.state, out.kin
        self._fall_states = phys._replace(u=phys.u * 0.0)
        return self._fall_states

    def initial_state(self) -> EnvState:
        if self._fall_states is None:
            self.generate_fall_states()
        return super().initial_state()

    # -- resets ---------------------------------------------------------------------

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = super()._initial_aux(B)
        aux["recovery_counter"] = torch.zeros(B, dtype=torch.int32, device=self.device)
        return aux

    def _draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        d = super()._draw_reset(n)
        d["u_recovery"] = torch.rand(n, generator=self.gen, device=self.device)
        d["u_fall"] = torch.rand(n, generator=self.gen, device=self.device)
        d["fall_idx"] = torch.randint(0, self.num_envs, (n,), generator=self.gen,
                                      device=self.device)
        return d

    def _reset_actors(self, state: EnvState, mask, draws) -> Tuple[EnvState, torch.Tensor]:
        recovery = (draws["u_recovery"] < self._recovery_episode_prob) & (state.terminate_buf == 1)
        fall = (draws["u_fall"] < self._fall_init_prob) & ~recovery
        new_state, mask = super()._reset_actors(state, mask, draws)
        fall_phys = type(self._fall_states)(*(x[draws["fall_idx"]] for x in self._fall_states))
        phys = where_phys(fall, fall_phys, new_state.phys)
        phys = where_phys(recovery, state.phys, phys)
        aux = dict(new_state.aux)
        aux["reset_ref_mask"] = aux["reset_ref_mask"] & ~fall & ~recovery
        counter = aux["recovery_counter"]
        aux["recovery_counter"] = torch.where(
            mask & (fall | recovery), torch.full_like(counter, self._recovery_steps),
            torch.where(mask, torch.zeros_like(counter), counter))
        return new_state.replace(phys=phys, aux=aux), mask

    def pre_physics_step(self, state, actions):
        state, tgt = super().pre_physics_step(state, actions)
        counter = torch.clamp(state.aux["recovery_counter"] - 1, min=0)
        return state.replace(aux={**state.aux, "recovery_counter": counter}), tgt

    def _compute_reset(self, state: EnvState):
        reset, term = super()._compute_reset(state)
        is_recovery = state.aux["recovery_counter"] > 0
        zero = torch.zeros_like(reset)
        return torch.where(is_recovery, zero, reset), torch.where(is_recovery, zero, term)
