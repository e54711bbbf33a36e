"""Articulated-body state, static masks, the joint-batched actuation the
engine runs, and the per-body (AoS) oracles (port of
``ase_tpu/physics/dynamics.py``).

``State`` and ``Kin`` carry leading batch dims (none for one env, as the
reference's ``engine.step`` takes it). Stable-PD drive semantics are the
reference's: tau = kp (err - dt qd) - kd qd, with dt kd moved onto the
mass-matrix diagonal.

The AoS functions (``dof_pos`` ... ``limit_torques``) keep the reference's
Python loops over bodies, joints and dofs: the tree walked body by body
and the mass matrix assembled by CRBA over static masks. They are a second
formulation of the physics, independent of the component-form batched code
in ``dynamics2`` that the engine runs, and the tests and ``chip_smoke.py``
hold the one against the other. Each op works on whole batches, so the
oracle runs one env on the CPU or thousands on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ase_tpu_torch.ops import quat as rot
from ase_tpu_torch.ops import spatial as sp
from ase_tpu_torch.physics import model as M


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

def dof_pos(model: M.Model, state: State) -> torch.Tensor:
    """(..., nd) exp-map coordinates of spherical joints, hinge angles."""
    s_ids, h_ids = sph_ids(model), hinge_ids(model)
    pieces = []
    for b in model.dof_body_ids:
        if model.jtype[b] == M.SPHERICAL:
            pieces.append(rot.quat_to_exp_map(state.joint_q[..., s_ids.index(b), :]))
        else:
            pieces.append(state.hinge_q[..., h_ids.index(b), None])
    return torch.cat(pieces, dim=-1)


def dof_vel(model: M.Model, state: State) -> torch.Tensor:
    return state.u[..., model.root_dofs:model.nu]


def set_dof_state(model: M.Model, state: State, dof_p: torch.Tensor,
                  dof_v: torch.Tensor) -> State:
    s_ids, h_ids = sph_ids(model), hinge_ids(model)
    joint_q, hinge_q, u = state.joint_q.clone(), state.hinge_q.clone(), state.u.clone()
    for j, b in enumerate(model.dof_body_ids):
        off = model.dof_offsets[j]
        if model.jtype[b] == M.SPHERICAL:
            joint_q[..., s_ids.index(b), :] = rot.exp_map_to_quat(dof_p[..., off:off + 3])
        else:
            hinge_q[..., h_ids.index(b)] = dof_p[..., off]
    u[..., model.root_dofs:model.nu] = dof_v
    return state._replace(joint_q=joint_q, hinge_q=hinge_q, u=u)


def set_root_state(state: State, pos, quat, lin_vel, ang_vel) -> State:
    u = state.u.clone()
    u[..., 0:3] = lin_vel
    u[..., 3:6] = ang_vel
    return state._replace(root_pos=pos, root_quat=quat, u=u)


def has_free_root(model: M.Model) -> bool:
    return model.jtype[0] == M.FREE


# -- the AoS kinematics and dynamics -------------------------------------------

def local_joint_quat(model: M.Model, state: State, b: int) -> torch.Tensor:
    """(..., 4) rotation of body ``b`` in its parent's frame."""
    jt = model.jtype[b]
    if jt == M.FREE:
        jq = state.root_quat
    elif jt == M.SPHERICAL:
        jq = state.joint_q[..., sph_ids(model).index(b), :]
    elif jt == M.REVOLUTE:
        jq = rot.quat_from_angle_axis(state.hinge_q[..., hinge_ids(model).index(b)],
                                      model.joint_axis[b])
    else:
        jq = rot.quat_identity(state.root_pos.shape[:-1], device=state.root_pos.device)
    return rot.quat_mul(model.body_iquat[b], jq)


def fk(model: M.Model, state: State) -> Kin:
    """Forward kinematics by walking the tree body by body
    (``dynamics.py:140``): rotations, origins, world-frame spatial
    velocities [w, v at the origin] and centres of mass, (..., nb, ...).
    A fixed base sits at ``root_pos`` plus its MJCF placement and moves
    with no dof."""
    nb = model.nb
    u = state.u
    zeros3 = torch.zeros_like(state.root_pos)
    quats, Rs, ps = [], [], []
    for b in range(nb):
        lq = local_joint_quat(model, state, b)
        p = model.parents[b]
        if p == -1:
            quats.append(lq)
            ps.append(state.root_pos if model.jtype[b] == M.FREE
                      else state.root_pos + model.body_ipos[b])
        else:
            quats.append(rot.quat_mul(quats[p], lq))
            ps.append(ps[p] + rot.quat_rotate(quats[p], model.body_ipos[b]))
        Rs.append(rot.quat_to_rotation_matrix(quats[b]))

    vels = [None] * nb
    for b in range(nb):
        p = model.parents[b]
        if p == -1:
            if model.jtype[b] == M.FREE:
                w, v = u[..., 3:6], u[..., 0:3]
            else:
                w, v = zeros3, zeros3
        else:
            wp, vp = vels[p][..., 0:3], vels[p][..., 3:6]
            v = vp + torch.linalg.cross(wp, ps[b] - ps[p], dim=-1)
            off = model.dof_offset[b]
            if model.jtype[b] == M.SPHERICAL:
                w = wp + (Rs[b] @ u[..., off:off + 3, None])[..., 0]
            elif model.jtype[b] == M.REVOLUTE:
                w = wp + (Rs[b] @ model.joint_axis[b]) * u[..., off:off + 1]
            else:
                w = wp
        vels[b] = torch.cat([w, v], dim=-1)

    R = torch.stack(Rs, dim=-3)
    pos = torch.stack(ps, dim=-2)
    com_w = pos + (R @ model.com[:nb, :, None])[..., 0]
    return Kin(R, pos, torch.stack(quats, dim=-2), torch.stack(vels, dim=-2), com_w)


def motion_subspace(model: M.Model, kin: Kin, origin: torch.Tensor):
    """(Phi, Phi_dot), each (..., nu, 6): the world-frame dof axes as
    spatial motions at the reference point ``origin`` (..., 3), and the
    axes' time derivatives (``dynamics.py:206``)."""
    cols, dcols = [], []
    zeros3 = torch.zeros_like(origin)
    zeros6 = torch.zeros(origin.shape[:-1] + (6,), dtype=origin.dtype, device=origin.device)
    root_v = kin.body_vel[..., 0, :]

    def unit(k):
        e = torch.zeros_like(origin)
        e[..., k] = 1.0
        return e

    for b in range(model.nb):
        jt = model.jtype[b]
        p_b = kin.body_pos[..., b, :]
        w_b = kin.body_vel[..., b, 0:3]
        v_b_at_o = kin.body_vel[..., b, 3:6] + torch.linalg.cross(w_b, origin - p_b, dim=-1)
        v_sp = torch.cat([w_b, v_b_at_o], dim=-1)
        if jt == M.FREE:
            for k in range(3):      # linear dofs: world axes, constant
                cols.append(torch.cat([zeros3, unit(k)], dim=-1))
                dcols.append(zeros6)
            vlin = root_v[..., 3:6]
            for k in range(3):      # angular dofs: world axes through the moving root
                e = unit(k)
                cols.append(torch.cat([e, torch.linalg.cross(e, origin - p_b, dim=-1)], dim=-1))
                dcols.append(torch.cat([zeros3, torch.linalg.cross(e, -vlin, dim=-1)], dim=-1))
        elif jt == M.SPHERICAL:
            for k in range(3):
                a = kin.body_R[..., b, :, k]
                phi = torch.cat([a, torch.linalg.cross(a, origin - p_b, dim=-1)], dim=-1)
                cols.append(phi)
                dcols.append(sp.motion_cross(v_sp, phi))
        elif jt == M.REVOLUTE:
            a = kin.body_R[..., b, :, :] @ model.joint_axis[b]
            phi = torch.cat([a, torch.linalg.cross(a, origin - p_b, dim=-1)], dim=-1)
            cols.append(phi)
            dcols.append(sp.motion_cross(v_sp, phi))
    return torch.stack(cols, dim=-2), torch.stack(dcols, dim=-2)


class DynOut(NamedTuple):
    Mmat: torch.Tensor     # (..., nu, nu) LHS with armature + dt kd (SPD)
    bias: torch.Tensor     # (..., nu) C(q, v) + g
    Phi: torch.Tensor      # (..., nu, 6)
    Amask: torch.Tensor    # (nb, nu)


def compute_dynamics(model: M.Model, state: State, kin: Kin, dt: float) -> DynOut:
    """Mass matrix and bias forces by composite rigid-body inertias over
    static masks (``dynamics.py:285``): all spatial quantities at the root
    origin, so a subtree's inertia is a masked sum. The diagonal takes the
    armature and the Stable-PD drive's dt x damping on the joint dofs and,
    with a free root, dt x the root's angular damping."""
    nb, nu, rd = model.nb, model.nu, model.root_dofs
    dev = state.u.device
    A_np, W_np, both_np, S_np = crba_masks(model)
    A, W, both, S = (torch.as_tensor(x, device=dev) for x in (A_np, W_np, both_np, S_np))
    origin = state.root_pos
    Phi, Phid = motion_subspace(model, kin, origin)
    u_art = state.u[..., :nu]

    R = kin.body_R
    I_com_w = R @ model.inertia[:nb] @ R.transpose(-1, -2)
    lever = kin.com_world - origin[..., None, :]
    I_sp = sp.spatial_inertia(model.mass[:nb], lever, I_com_w)     # (..., nb, 6, 6)
    Ic = torch.einsum("pb,...bkl->...pkl", S, I_sp)

    db = torch.as_tensor(dof_body(model), device=dev)
    F = torch.einsum("...dkl,...dl->...dk", Ic[..., db, :, :], Phi)
    G = torch.einsum("...dk,...ek->...de", F, Phi)
    WG = W * G
    Mmat = WG + WG.transpose(-1, -2) - both * G

    a_bias = torch.einsum("bd,...dk->...bk", A, Phid * u_art[..., None])
    v_sp = torch.einsum("bd,...dk->...bk", A, Phi * u_art[..., None])
    Iv = torch.einsum("...bkl,...bl->...bk", I_sp, v_sp)
    f_bias = torch.einsum("...bkl,...bl->...bk", I_sp, a_bias) + sp.force_cross(v_sp, Iv)
    Fg = (model.mass[:nb, None] * model.gravity[None, :]).expand_as(lever)
    f_grav = torch.cat([torch.linalg.cross(lever, Fg, dim=-1), Fg], dim=-1)
    Fd = torch.einsum("bd,...bk->...dk", A, f_bias - f_grav)
    bias = (Phi * Fd).sum(-1)

    diag = torch.zeros(nu, device=dev)
    diag[rd:] += model.armature + dt * model.damping
    if rd == 6:
        diag[3:6] += dt * model.ang_damping
    return DynOut(Mmat + torch.diag(diag), bias, Phi, A)


def pd_torques(model: M.Model, state: State, pd_target: torch.Tensor, dt: float,
               kd_scale=1.0) -> torch.Tensor:
    """(..., nd) Stable-PD torques from exp-map / angle targets, joint by
    joint (``dynamics.py:342``). ``kd_scale``, a number or one per env
    (...), scales the velocity gain (damping randomization)."""
    kp = model.stiffness
    ks = torch.as_tensor(kd_scale, dtype=pd_target.dtype, device=pd_target.device)
    kd = model.damping * ks[..., None]
    qd = dof_vel(model, state)
    s_ids, h_ids = sph_ids(model), hinge_ids(model)
    taus = []
    for j, b in enumerate(model.dof_body_ids):
        off = model.dof_offsets[j]
        if model.jtype[b] == M.SPHERICAL:
            q_cur = state.joint_q[..., s_ids.index(b), :]
            q_tar = rot.exp_map_to_quat(pd_target[..., off:off + 3])
            err = rot.quat_to_exp_map(rot.quat_mul(rot.quat_conjugate(q_cur), q_tar))
            w_loc = qd[..., off:off + 3]
            taus.append(kp[off:off + 3] * (err - dt * w_loc) - kd[..., off:off + 3] * w_loc)
        else:
            e = pd_target[..., off] - state.hinge_q[..., h_ids.index(b)]
            tau = kp[off] * (e - dt * qd[..., off]) - kd[..., off] * qd[..., off]
            taus.append(tau[..., None])
    return torch.cat(taus, dim=-1)


def limit_torques(model: M.Model, state: State, k_limit: float = 200.0) -> torch.Tensor:
    """(..., nd) soft joint-limit penalty torques on the dof view
    (``dynamics.py:376``)."""
    q = dof_pos(model, state)
    qd = dof_vel(model, state)
    over = torch.clamp(q - model.dof_limit_hi, min=0.0)
    under = torch.clamp(model.dof_limit_lo - q, min=0.0)
    in_violation = (over > 0) | (under > 0)
    damp = torch.where(in_violation, 2.0 * float(np.sqrt(k_limit)), 0.0)
    return -k_limit * over + k_limit * under - damp * qd * in_violation


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
