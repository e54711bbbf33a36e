"""Articulated-body state, static masks and the joint-batched actuation
the engine runs (port of ``ase_tpu/physics/dynamics.py``).

``State`` and ``Kin`` carry a leading batch dim. Stable-PD drive semantics
are the reference's: tau = kp (err - dt qd) - kd qd, with dt kd moved onto
the mass-matrix diagonal.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from h100_bench.reference.ase_ref.ops import quat as rot
from h100_bench.reference.ase_ref.physics import model as M


class State(NamedTuple):
    """Batched physics state."""

    root_pos: torch.Tensor    # (B, 3)
    root_quat: torch.Tensor   # (B, 4) xyzw
    joint_q: torch.Tensor     # (B, n_sph, 4) spherical joint local quats
    hinge_q: torch.Tensor     # (B, n_hinge)
    u: torch.Tensor           # (B, nv)
    prop_pos: torch.Tensor    # (B, np, 3)
    prop_quat: torch.Tensor   # (B, np, 4)


class Kin(NamedTuple):
    body_R: torch.Tensor      # (B, nb, 3, 3)
    body_pos: torch.Tensor    # (B, nb, 3)
    body_quat: torch.Tensor   # (B, nb, 4)
    body_vel: torch.Tensor    # (B, nb, 6) [w, v_origin], world frame
    com_world: torch.Tensor   # (B, nb, 3)


def sph_ids(model: M.Model):
    return [b for b in range(model.nb) if model.jtype[b] == M.SPHERICAL]


def hinge_ids(model: M.Model):
    return [b for b in range(model.nb) if model.jtype[b] == M.REVOLUTE]


def default_state(model: M.Model, batch: Optional[int] = None) -> State:
    """The reference's ``default_state``: one env without a batch dim when
    ``batch`` is None, else tiled over ``batch`` envs."""
    dev = model.device
    lead = () if batch is None else (batch,)
    return State(
        root_pos=torch.zeros(lead + (3,), device=dev),
        root_quat=rot.quat_identity(lead, device=dev),
        joint_q=rot.quat_identity(lead + (len(sph_ids(model)),), device=dev),
        hinge_q=torch.zeros(lead + (len(hinge_ids(model)),), device=dev),
        u=torch.zeros(lead + (model.nv,), device=dev),
        prop_pos=torch.zeros(lead + (model.num_props, 3), device=dev),
        prop_quat=rot.quat_identity(lead + (model.num_props,), device=dev),
    )


# -- dof <-> joint-state views (the Isaac tensor API's dof_pos / dof_vel) -------


# -- the AoS kinematics and dynamics -------------------------------------------


class DynOut(NamedTuple):
    Mmat: torch.Tensor     # (..., nu, nu) LHS with armature + dt kd (SPD)
    bias: torch.Tensor     # (..., nu) C(q, v) + g
    Phi: torch.Tensor      # (..., nu, 6)
    Amask: torch.Tensor    # (nb, nu)


def ancestor_mask(model: M.Model) -> np.ndarray:
    """Static (nb, nu) mask: A[b, d] = 1 if dof d is on the path to body b."""
    A = np.zeros((model.nb, model.nu), dtype=np.float32)
    for b in range(model.nb):
        cur = b
        while cur != -1:
            jt = model.jtype[cur]
            off = model.dof_offset[cur]
            if jt == M.FREE:
                A[b, off:off + 6] = 1.0
            elif jt == M.SPHERICAL:
                A[b, off:off + 3] = 1.0
            elif jt == M.REVOLUTE:
                A[b, off] = 1.0
            cur = model.parents[cur]
    return A


def dof_body(model: M.Model) -> np.ndarray:
    """Static (nu,) map dof index -> owning body."""
    out = np.zeros(model.nu, dtype=np.int64)
    for b in range(model.nb):
        n = {M.FREE: 6, M.SPHERICAL: 3, M.REVOLUTE: 1}.get(model.jtype[b], 0)
        off = model.dof_offset[b]
        out[off:off + n] = b
    return out


def crba_masks(model: M.Model):
    """Static masks for the composite-inertia mass-matrix assembly:
    (A (nb, nu), W (nu, nu), both (nu, nu), S (nb, nb))."""
    A = ancestor_mask(model)
    W = A[dof_body(model)]
    both = W * W.T
    nb = model.nb
    S = np.zeros((nb, nb), dtype=np.float32)
    for b in range(nb):
        cur = b
        while cur != -1:
            S[cur, b] = 1.0
            cur = model.parents[cur]
    return A, W, both, S


@dataclasses.dataclass(frozen=True)
class DofTables:
    """Gather/scatter indices between stacked-joint tensors and the (nd,)
    dof view (device tensors)."""

    sph_rows: torch.Tensor
    sph_cols: torch.Tensor
    hin_rows: torch.Tensor
    hin_cols: torch.Tensor


def dof_tables(model: M.Model) -> DofTables:
    s_ids, h_ids = sph_ids(model), hinge_ids(model)
    sph_rows, sph_cols, hin_rows, hin_cols = [], [], [], []
    for j, b in enumerate(model.dof_body_ids):
        off = model.dof_offsets[j]
        if model.jtype[b] == M.SPHERICAL:
            sph_rows.append(s_ids.index(b))
            sph_cols.extend([off, off + 1, off + 2])
        else:
            hin_rows.append(h_ids.index(b))
            hin_cols.append(off)

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=model.device)

    return DofTables(t(sph_rows), t(sph_cols), t(hin_rows), t(hin_cols))


def dof_pos_batched(model: M.Model, tables: DofTables, states: State) -> torch.Tensor:
    """(B, nd) exp-map coords for spherical joints, angles for hinges."""
    B = states.root_pos.shape[0]
    out = torch.zeros(B, model.nd, device=states.u.device)
    if len(tables.sph_rows):
        exp = rot.quat_to_exp_map(states.joint_q[:, tables.sph_rows])
        out[:, tables.sph_cols] = exp.reshape(B, -1)
    if len(tables.hin_rows):
        out[:, tables.hin_cols] = states.hinge_q[:, tables.hin_rows]
    return out


def pd_torques_batched(model: M.Model, tables: DofTables, states: State,
                       pd_target: torch.Tensor, dt: float,
                       kd_scale: torch.Tensor = None) -> torch.Tensor:
    """(B, nd) Stable-PD torques. ``kd_scale`` is a damping multiplier per
    env (B,) or per dof (B, nd) (domain randomization)."""
    B = pd_target.shape[0]
    kp, kd = model.stiffness, model.damping
    qd = states.u[:, model.root_dofs:model.nu]
    if kd_scale is not None and kd_scale.dim() == 1:
        kd_scale = kd_scale[:, None].expand(B, model.nd)
    out = torch.zeros(B, model.nd, device=pd_target.device)
    sc, hc = tables.sph_cols, tables.hin_cols
    if len(tables.sph_rows):
        q_cur = states.joint_q[:, tables.sph_rows]
        q_tar = rot.exp_map_to_quat(pd_target[:, sc].reshape(B, -1, 3))
        err = rot.quat_to_exp_map(rot.quat_mul(rot.quat_conjugate(q_cur), q_tar))
        w_loc = qd[:, sc].reshape(B, -1, 3)
        kp_s = kp[sc].reshape(-1, 3)
        kd_s = kd[sc].reshape(-1, 3)
        if kd_scale is not None:
            kd_s = kd_s * kd_scale[:, sc].reshape(B, -1, 3)
        tau_s = kp_s * (err - dt * w_loc) - kd_s * w_loc
        out[:, sc] = tau_s.reshape(B, -1)
    if len(tables.hin_rows):
        e = pd_target[:, hc] - states.hinge_q[:, tables.hin_rows]
        kd_h = kd[hc] if kd_scale is None else kd[hc] * kd_scale[:, hc]
        out[:, hc] = kp[hc] * (e - dt * qd[:, hc]) - kd_h * qd[:, hc]
    return out


def limit_torques_batched(model: M.Model, tables: DofTables, states: State,
                          k_limit: float = 200.0) -> torch.Tensor:
    """(B, nd) soft joint-limit torques."""
    q = dof_pos_batched(model, tables, states)
    qd = states.u[:, model.root_dofs:model.nu]
    over = torch.clamp(q - model.dof_limit_hi, min=0.0)
    under = torch.clamp(model.dof_limit_lo - q, min=0.0)
    in_violation = (over > 0) | (under > 0)
    damp = torch.where(in_violation, torch.full_like(q, 2.0 * float(np.sqrt(k_limit))),
                       torch.zeros_like(q))
    return -k_limit * over + k_limit * under - damp * qd * in_violation
