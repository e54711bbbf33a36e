"""Humanoid environment on batched tensors (port of ``ase_tpu/envs/humanoid.py``).

Methods keep the reference's functional shape -- state in, state out -- so
the port's tests hold each step against the JAX env. ``EnvState`` is a plain
dataclass of per-env tensors (leading dim B) on the env's device. Random
draws come from the env's ``torch.Generator`` through ``_draw_reset``, one
call per reset pass, so a caller can substitute its own numbers.

With ``pdControl`` off the actions drive the joints as torques (action x
motor gear x ``powerScale``). The reference follows no configuration with
domain randomization (``task.randomize``), which raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from h100_bench.reference.ase_ref.envs import obs as obs_kernels
from h100_bench.reference.ase_ref.ops import quat as rot
from h100_bench.reference.ase_ref.physics import dynamics, dynamics2, engine, mjcf
from h100_bench.reference.ase_ref.physics.solver import SolverConfig


@dataclasses.dataclass
class EnvState:
    phys: dynamics.State
    body_pos: torch.Tensor        # (B, nb, 3)
    body_quat: torch.Tensor       # (B, nb, 4)
    body_vel: torch.Tensor        # (B, nb, 3)
    body_ang_vel: torch.Tensor    # (B, nb, 3)
    contact_forces: torch.Tensor  # (B, nb+np, 3)
    obs: torch.Tensor             # (B, obs_dim)
    rew: torch.Tensor             # (B,)
    reset_buf: torch.Tensor       # (B,) int32
    terminate_buf: torch.Tensor   # (B,) int32
    progress: torch.Tensor        # (B,) int32
    actions: torch.Tensor         # (B, nd)
    aux: Dict[str, torch.Tensor]  # task/AMP extensions, (B, ...) or 0-d (global)

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def take(state: EnvState, idx: torch.Tensor) -> EnvState:
    """Rows ``idx`` of every per-env tensor (0-d ``aux`` entries pass)."""
    kw = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    out = {}
    for k, v in kw.items():
        if k == "phys":
            out[k] = dynamics.State(*(x[idx] for x in v))
        elif k == "aux":
            out[k] = {a: x[idx] if x.dim() else x for a, x in v.items()}
        else:
            out[k] = v[idx]
    return EnvState(**out)


def put(state: EnvState, idx: torch.Tensor, sub: EnvState) -> EnvState:
    """``state`` with rows ``idx`` replaced by ``sub`` (new tensors); 0-d
    ``aux`` entries keep ``state``'s."""
    def p(x, y):
        x = x.clone()
        x[idx] = y
        return x

    out = {}
    for f in dataclasses.fields(state):
        v, w = getattr(state, f.name), getattr(sub, f.name)
        if f.name == "phys":
            out[f.name] = dynamics.State(*(p(x, y) for x, y in zip(v, w)))
        elif f.name == "aux":
            out[f.name] = {a: p(x, w[a]) if x.dim() else x for a, x in v.items()}
        else:
            out[f.name] = p(v, w)
    return EnvState(**out)


def where_phys(mask: torch.Tensor, a: dynamics.State, b: dynamics.State) -> dynamics.State:
    """Per-env select between two batched physics states."""
    return dynamics.State(*(
        torch.where(mask.reshape(mask.shape + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)))


class Humanoid:
    """Config-driven humanoid env; ``device`` defaults to the card."""

    def __init__(self, cfg: Dict[str, Any], device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        env_cfg = cfg["env"]
        self._pd_control = bool(env_cfg.get("pdControl", True))
        self.power_scale = float(env_cfg.get("powerScale", 1.0))
        self.num_envs = int(env_cfg["numEnvs"])
        self.max_episode_length = int(env_cfg["episodeLength"])
        self.control_freq_inv = int(env_cfg.get("controlFrequencyInv", 2))
        self._local_root_obs = bool(env_cfg["localRootObs"])
        self._root_height_obs = bool(env_cfg.get("rootHeightObs", True))
        self._enable_early_termination = bool(env_cfg["enableEarlyTermination"])
        self._termination_height = float(env_cfg.get("terminationHeight", 0.15))
        # each step publishes the applied dof torques in aux["dof_forces"]
        self._expose_dof_forces = bool(env_cfg.get("exposeDofForces", False))

        self.asset_file = env_cfg["asset"]["assetFileName"]
        path = mjcf.find_asset(env_cfg["asset"]["assetRoot"], self.asset_file)
        plane = env_cfg.get("plane", {})
        model = self._build_model(path)
        self.model = model.replace(plane_friction=torch.tensor(
            float(plane.get("staticFriction", 1.0)), device=self.device))

        sim = cfg.get("sim", {})
        self.sim_dt = float(sim.get("dt", 1.0 / 60.0))
        self.dt = self.control_freq_inv * self.sim_dt
        physx = sim.get("physx", {})
        self.sim_cfg = engine.SimConfig(
            dt=self.sim_dt,
            substeps=int(sim.get("substeps", 2)),
            solver=SolverConfig(
                iterations=int(env_cfg.get(
                    "solverIterations", 4 * int(physx.get("num_position_iterations", 4)))),
                scheme=str(env_cfg.get("solverScheme", "jacobi")),
                max_depenetration_velocity=float(physx.get("max_depenetration_velocity", 10.0)),
                contact_offset=float(physx.get("contact_offset", 0.02)),
            ),
            max_contacts=int(env_cfg.get("maxContacts", 24)),
            enable_self_collision=bool(env_cfg.get("enableSelfCollision", True)),
            torque_control=not self._pd_control,
            power_scale=self.power_scale,
        )
        self._tables = engine.Tables(self.model, self.sim_cfg)

        self._key_body_ids = torch.as_tensor(
            [self.model.body_index(b) for b in env_cfg["keyBodies"]], device=self.device)
        contact_ids = [self.model.body_index(b) for b in env_cfg["contactBodies"]]
        contact_mask = np.ones(self.model.nb, bool)
        contact_mask[contact_ids] = False
        self._contact_mask = torch.as_tensor(contact_mask, device=self.device)

        self._build_pd_action_offset_scale()
        self._build_termination_heights()
        self.reset_chunk = int(env_cfg.get("resetChunk", 0))

        if cfg.get("task", {}).get("randomize", False):
            raise NotImplementedError("the reference follows no configuration with "
                                      "domain randomization")

        self._initial_root_pos = torch.tensor([0.0, 0.0, 0.89], device=self.device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(cfg.get("seed", 0)))
        self.replicated_gen = self.gen

    def _build_model(self, asset_path: str):
        """The physics model: the asset's articulation (tasks with props
        append them here)."""
        return mjcf.load_mjcf(asset_path, device=self.device)

    # -- sizes ----------------------------------------------------------------

    def get_obs_size(self) -> int:
        return 1 + self.model.nb * (3 + 6 + 3 + 3) - 3

    def get_action_size(self) -> int:
        return self.model.nd

    @property
    def num_obs(self) -> int:
        return self.get_obs_size()

    @property
    def num_actions(self) -> int:
        return self.get_action_size()

    def amp_obs_size(self) -> int:
        return 0

    def _build_pd_action_offset_scale(self):
        lim_low = self.model.np("dof_limit_lo").copy()
        lim_high = self.model.np("dof_limit_hi").copy()
        offsets = self.model.dof_offsets
        for j in range(len(offsets) - 1):
            off = offsets[j]
            if offsets[j + 1] - off == 3:
                scale = max(np.max(np.abs(lim_low[off:off + 3])),
                            np.max(np.abs(lim_high[off:off + 3])))
                scale = min(1.2 * scale, np.pi)
                lim_low[off:off + 3] = -scale
                lim_high[off:off + 3] = scale
            else:
                mid = 0.5 * (lim_high[off] + lim_low[off])
                scale = 0.7 * (lim_high[off] - lim_low[off])
                lim_low[off] = mid - scale
                lim_high[off] = mid + scale
        f32 = dict(dtype=torch.float32, device=self.device)
        self._pd_action_offset = torch.as_tensor(0.5 * (lim_high + lim_low), **f32)
        self._pd_action_scale = torch.as_tensor(0.5 * (lim_high - lim_low), **f32)

    def _build_termination_heights(self):
        heights = np.full(self.model.nb, self._termination_height, dtype=np.float32)
        head = self.model.body_index("head")
        heights[head] = max(0.3, heights[head])
        if "sword_shield" in self.asset_file:
            arm = self.model.body_index("left_lower_arm")
            heights[arm] = max(0.32, heights[arm])
        self._termination_heights = torch.as_tensor(heights, device=self.device)

    # -- states -----------------------------------------------------------------

    def default_phys_state(self, batch: int) -> dynamics.State:
        s = dynamics.default_state(self.model, batch)
        return s._replace(root_pos=self._initial_root_pos.expand(batch, 3).clone())

    def _initial_aux(self, B: int) -> Dict[str, torch.Tensor]:
        aux = {}
        if self._expose_dof_forces:
            aux["dof_forces"] = torch.zeros(B, self.model.nd, device=self.device)
        return aux

    def initial_state(self) -> EnvState:
        """Construct and fully reset the batched env state."""
        B, nb, dev = self.num_envs, self.model.nb, self.device
        state = EnvState(
            phys=self.default_phys_state(B),
            body_pos=torch.zeros(B, nb, 3, device=dev),
            body_quat=rot.quat_identity((B, nb), device=dev),
            body_vel=torch.zeros(B, nb, 3, device=dev),
            body_ang_vel=torch.zeros(B, nb, 3, device=dev),
            contact_forces=torch.zeros(B, nb + self.model.num_props, 3, device=dev),
            obs=torch.zeros(B, self.get_obs_size(), device=dev),
            rew=torch.zeros(B, device=dev),
            reset_buf=torch.zeros(B, dtype=torch.int32, device=dev),
            terminate_buf=torch.zeros(B, dtype=torch.int32, device=dev),
            progress=torch.zeros(B, dtype=torch.int32, device=dev),
            actions=torch.zeros(B, self.get_action_size(), device=dev),
            aux=self._initial_aux(B),
        )
        state = self._refresh_kinematics(state)
        return self._reset_envs(state, torch.ones(B, dtype=torch.bool, device=dev),
                                self._draw_reset(B))

    def _refresh_kinematics(self, state: EnvState) -> EnvState:
        kin = dynamics2.fk_batched(self.model, self._tables.dyn, state.phys, None)
        return state.replace(body_pos=kin.body_pos, body_quat=kin.body_quat,
                             body_vel=kin.body_vel[..., 3:6],
                             body_ang_vel=kin.body_vel[..., 0:3])

    # -- resets -------------------------------------------------------------------

    def _draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        """Random numbers one reset pass over ``n`` envs consumes (none in
        the base env; tasks add theirs)."""
        return {}

    def reset_done(self, state: EnvState) -> EnvState:
        """Reset every env whose reset_buf is set.

        With ``resetChunk`` set, resets run on gathered sub-batches of at most
        ``chunk`` envs (the first flagged by env index); a storm larger than
        one chunk drains in repeated passes within the same step, as the
        reference's drain loop does (``humanoid.py:283-349``). The first pass
        draws its random numbers even when nothing is flagged, as the
        reference's unconditional first pass does."""
        chunk = self.reset_chunk
        if chunk and chunk < self.num_envs:
            state, n = self._reset_chunk_pass(state, chunk)
            while n > 0 and bool((state.reset_buf > 0).any()):
                state, n = self._reset_chunk_pass(state, chunk)
            return state
        mask = state.reset_buf > 0
        draws = self._draw_reset(self.num_envs)
        if not bool(mask.any()):
            return state
        return self._reset_envs(state, mask, draws)

    def _reset_chunk_pass(self, state: EnvState, chunk: int):
        draws = self._draw_reset(chunk)
        idx = torch.nonzero(state.reset_buf > 0)[:chunk, 0]
        n = int(idx.shape[0])
        if n == 0:
            return state, 0
        sub = take(state, idx)
        sub = self._reset_envs(sub, torch.ones(n, dtype=torch.bool, device=self.device),
                               {k: v[:n] for k, v in draws.items()})
        return put(state, idx, sub), n

    def _reset_envs(self, state: EnvState, mask: torch.Tensor, draws) -> EnvState:
        new_state, mask = self._reset_actors(state, mask, draws)
        phys = where_phys(mask, new_state.phys, state.phys)
        zero = torch.zeros_like(state.progress)
        state = new_state.replace(
            phys=phys,
            progress=torch.where(mask, zero, state.progress),
            reset_buf=torch.where(mask, zero, state.reset_buf),
            terminate_buf=torch.where(mask, zero, state.terminate_buf),
        )
        state = self._refresh_kinematics(state)
        return self._post_reset(state, mask)

    def _reset_actors(self, state: EnvState, mask, draws) -> Tuple[EnvState, torch.Tensor]:
        return state.replace(phys=self.default_phys_state(mask.shape[0])), mask

    def _post_reset(self, state: EnvState, mask: torch.Tensor) -> EnvState:
        obs = self._compute_observations(state)
        return state.replace(obs=torch.where(mask[:, None], obs, state.obs))

    # -- stepping -------------------------------------------------------------------

    def pre_physics_step(self, state: EnvState, actions: torch.Tensor):
        """The env state with ``actions`` stored, and what the engine gets:
        PD position targets, or under torque control the actions as they
        are."""
        if self._pd_control:
            tgt = self._pd_action_offset[None] + self._pd_action_scale[None] * actions
        else:
            tgt = actions
        return state.replace(actions=actions), tgt

    def step(self, state: EnvState, actions: torch.Tensor) -> EnvState:
        actions = torch.clamp(actions, -1.0, 1.0)
        state, tgt = self.pre_physics_step(state, actions)
        phys, kin0 = state.phys, None
        for _ in range(self.control_freq_inv):
            out = engine.step_batched(self.model, self.sim_cfg, self._tables, phys, tgt,
                                      kin0=kin0)
            phys, kin0 = out.state, out.kin
        state = state.replace(phys=phys, body_pos=out.body_pos, body_quat=out.body_quat,
                              body_vel=out.body_vel, body_ang_vel=out.body_ang_vel,
                              contact_forces=out.contact_forces)
        if self._expose_dof_forces:
            state = state.replace(aux={**state.aux, "dof_forces": out.dof_forces})
        return self.post_physics_step(state)

    def post_physics_step(self, state: EnvState) -> EnvState:
        state = state.replace(progress=state.progress + 1)
        state = self._update_aux(state)
        obs = self._compute_observations(state)
        rew = self._compute_reward(state)
        reset, term = self._compute_reset(state)
        return state.replace(obs=obs, rew=rew, reset_buf=reset, terminate_buf=term)

    def _update_aux(self, state: EnvState) -> EnvState:
        return state

    def _compute_observations(self, state: EnvState) -> torch.Tensor:
        return obs_kernels.compute_humanoid_observations_max(
            state.body_pos, state.body_quat, state.body_vel, state.body_ang_vel,
            self._local_root_obs, self._root_height_obs)

    def _compute_reward(self, state: EnvState) -> torch.Tensor:
        return torch.ones(self.num_envs, device=self.device)

    def _compute_reset(self, state: EnvState):
        return obs_kernels.compute_humanoid_reset(
            state.progress, state.contact_forces[:, :self.model.nb], self._contact_mask,
            state.body_pos, float(self.max_episode_length),
            self._enable_early_termination, self._termination_heights)

