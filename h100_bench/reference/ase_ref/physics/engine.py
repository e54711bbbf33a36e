"""The simulation engine: one batched sim tick over its substeps (port of
``ase_tpu/physics/engine.py``: ``step_batched`` and ``_substep_batched``).

Per tick: one narrow phase at the pre-tick pose (PhysX-TGS cadence, the
reference's default), then ``substeps`` substeps of: dynamics assembly,
the actuation torques (Stable-PD on position targets, or under
``torque_control`` the actions times the motor gear and ``power_scale``)
plus the limit torques, the contact step, and semi-implicit integration.

The contact step is the ``jacobi`` scheme's Z-form path: the contact
Jacobian, ONE fused Cholesky + forward substitution (``ops.chol.chol_forward``,
the plain version here), the block-Jacobi contact solve on A = Z^T Z, ONE
backward substitution (``ops.chol.back_solve``). The reference follows no
configuration with the ``pgs`` scheme or with free props (the strike
target, the perturb projectiles); either raises ``NotImplementedError``.

Domain randomization reaches the tick through the reference's knobs
(``engine.py:421``): friction per env or per shape, the gain (stiffness)
scale of the actuation torque per env or per dof, mass per env or per
body, gravity (props included), damping, the plane's restitution (a
Newton bounce target on the pre-solve normal velocities; the PGS branch
ignores it, as the reference's does) and the actor's geometric scale (FK,
dynamics and the humanoid's geoms). A knob left at None costs nothing;
the Cholesky systems stay n = nu whatever the knobs.

The reference's ``ASE_TPU_*_AOS`` and ``ASE_TPU_COLLISION_PER_SUBSTEP``
A/B switches are left out.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from h100_bench.reference.ase_ref.ops import chol
from h100_bench.reference.ase_ref.ops import quat as rot
from h100_bench.reference.ase_ref.physics import collision3, dynamics, dynamics2, solver, solver2
from h100_bench.reference.ase_ref.physics import model as M
from h100_bench.reference.ase_ref.physics.dynamics import State
from h100_bench.reference.ase_ref.physics.solver import SolverConfig


class SimConfig(NamedTuple):
    dt: float = 1.0 / 60.0
    substeps: int = 2
    solver: SolverConfig = SolverConfig()
    max_contacts: int = 24
    enable_self_collision: bool = True
    torque_control: bool = False       # False: PD position drives
    power_scale: float = 1.0           # torque control: tau = action x gear x this
    limit_stiffness: float = 200.0
    max_dof_vel: float = 64.0


class StepOut(NamedTuple):
    state: State
    body_pos: torch.Tensor        # (B, nb, 3)
    body_quat: torch.Tensor       # (B, nb, 4)
    body_vel: torch.Tensor        # (B, nb, 3)
    body_ang_vel: torch.Tensor    # (B, nb, 3)
    contact_forces: torch.Tensor  # (B, nb + np, 3)
    dof_forces: torch.Tensor      # (B, nd)
    kin: dynamics.Kin


class Tables:
    """Static device tables of one (model, config): the narrow-phase
    candidates (``collision3.build_soa_tables``), the dynamics masks, the
    dof gather tables and the implicit-damping diagonal."""

    def __init__(self, model: M.Model, cfg: SimConfig):
        solver.check_scheme(cfg.solver.scheme)      # the substep trusts it from here
        self.soa = collision3.build_soa_tables(model, cfg.enable_self_collision)
        self.detect = collision3.DetectConsts(model, self.soa, model.device)
        self.dyn = dynamics2.DynStatic(model)
        self.dof = dynamics.dof_tables(model)
        self.Amask = torch.as_tensor(dynamics.ancestor_mask(model), device=model.device)
        self.diag = self.dyn.diag(model, cfg.dt / cfg.substeps)
        self.diag_parts = self.dyn.diag_parts(model, cfg.dt / cfg.substeps)
        s_ids = dynamics.sph_ids(model)
        self.sph_dofs = torch.as_tensor(
            [model.dof_offset[b] + k for b in s_ids for k in range(3)],
            dtype=torch.long, device=model.device)
        self.hinge_dofs = torch.as_tensor(
            [model.dof_offset[b] for b in dynamics.hinge_ids(model)],
            dtype=torch.long, device=model.device)


def _clamp_w(model: M.Model, w: torch.Tensor) -> torch.Tensor:
    """Angular velocities scaled down to at most ``max_ang_vel``."""
    wn = torch.linalg.norm(w, dim=-1, keepdim=True) + 1e-9
    return w * torch.clamp(model.max_ang_vel / wn, max=1.0)


def _zform_contact_step(model: M.Model, cfg: SimConfig, T: Tables, states: State, contacts,
                        M_bl, bias, Phi, tau_full, u_free_prop, I_w, restitution):
    """The Jacobi scheme's contact step in Z-form (``engine.py:262-334``):
    with Z = L^-1 J^T the Delassus operator is A = Z^T Z and the free
    contact velocity is J u + h Z^T y0, y0 = L^-1 (tau - bias), so one fused
    factor and forward substitution (``chol.chol_forward``) and one
    backward substitution (``chol.back_solve``) carry the substep.
    Returns (u_new (B, nv), body_forces (B, nb, 3))."""
    h = cfg.dt / cfg.substeps
    nu = model.nu
    JT_bl, _ = solver2.contact_jacobian_t_bl(
        model, contacts, Phi, T.Amask, states.root_pos, states.prop_pos)
    L_bl, Z, y0 = chol.chol_forward(M_bl, JT_bl, (tau_full - bias).T[:, None, :].contiguous())
    y0 = y0[:, 0, :]                                                # (nu, B)

    Zb = Z.permute(2, 1, 0)                                         # (B, 3K, nu)
    if cfg.solver.matvec_bf16:
        Z16 = Zb.to(torch.bfloat16)
        A = torch.bmm(Z16, Z16.transpose(1, 2))                     # bf16 out, f32 accumulate
    else:
        A = torch.bmm(Zb, Zb.transpose(1, 2))
    u_art = states.u[:, :nu]
    v_art_cur = torch.einsum("vib,bv->bi", JT_bl, u_art)
    v0f = v_art_cur + h * torch.einsum("vib,vb->bi", Z, y0)
    if restitution is None:
        lam_f = solver2.jacobi_lambda(contacts, A, v0f, h, cfg.solver)
    else:
        # the pre-solve normal contact velocities, the bounce's reference
        vn_pre = v_art_cur[:, :contacts.depth.shape[1]]
        lam_f = solver2.jacobi_lambda(contacts, A, v0f, h, cfg.solver,
                                      restitution=restitution, vn_pre=vn_pre)

    du_bl = (h * y0 + torch.einsum("vib,bi->vb", Z, lam_f))[:, None, :].contiguous()
    u_new = u_art + chol.back_solve(L_bl, du_bl)[:, 0, :].T
    body_forces = solver2.body_forces_from_lambda(
        model, contacts, lam_f, h, contact_offset=cfg.solver.contact_offset)
    return u_new, body_forces


def _joint_torques(model: M.Model, cfg: SimConfig, T: Tables, states: State,
                   actions: torch.Tensor, h: float, gain_scale=None, damping_scale=None):
    """A substep's joint torques: the actuation (torque control or PD
    towards ``actions``, scaled by ``gain_scale`` under stiffness
    randomization) plus the joint-limit torques. Returns (tau (B, nd),
    tau_full (B, nu): tau after the root's zero dofs)."""
    if cfg.torque_control:
        tau = actions * model.motor_gear * cfg.power_scale
    else:
        tau = dynamics.pd_torques_batched(model, T.dof, states, actions, h,
                                          kd_scale=damping_scale)
    limit = dynamics.limit_torques_batched(model, T.dof, states, cfg.limit_stiffness)
    if gain_scale is None:
        tau = tau + limit
    else:   # stiffness randomization scales the whole actuation torque
        tau = tau * (gain_scale[:, None] if gain_scale.dim() == 1 else gain_scale) + limit
    tau_full = torch.zeros(actions.shape[0], model.nu, device=actions.device)
    tau_full[:, model.root_dofs:] = tau
    return tau, tau_full


def _contact_step_fn(cfg: SimConfig):
    """The contact step of ``cfg``'s solver scheme (``jacobi`` only)."""
    if cfg.solver.scheme != "jacobi":
        raise NotImplementedError("the reference follows the jacobi contact scheme only")
    return _zform_contact_step


def _substep_batched(model: M.Model, cfg: SimConfig, T: Tables, states: State,
                     actions: torch.Tensor, kin: dynamics.Kin, contacts, gain_scale=None,
                     mass_scale=None, gravity_scale=None, damping_scale=None,
                     restitution=None, actor_scale=None):
    h = cfg.dt / cfg.substeps
    nu, rd, P = model.nu, model.root_dofs, model.num_props
    Bn = actions.shape[0]

    M_bl, bias, Phi = dynamics2.compute_dynamics_batch_last(
        model, T.dyn, states, kin, T.diag, mass_scale=mass_scale, gravity_scale=gravity_scale,
        damping_scale=damping_scale, actor_scale=actor_scale, diag_parts=T.diag_parts)

    tau, tau_full = _joint_torques(model, cfg, T, states, actions, h, gain_scale=gain_scale,
                                   damping_scale=damping_scale)
    u_free_prop = I_w = None
    if P:
        raise NotImplementedError("the reference follows no configuration with props")

    u_new, body_forces = _contact_step_fn(cfg)(model, cfg, T, states, contacts, M_bl, bias, Phi,
                                               tau_full, u_free_prop, I_w, restitution)

    u_new = u_new.clone()
    u_new[:, rd:nu] = torch.clamp(u_new[:, rd:nu], -cfg.max_dof_vel, cfg.max_dof_vel)
    if rd == 6:
        u_new[:, 3:6] = _clamp_w(model, u_new[:, 3:6])
        root_pos = states.root_pos + h * u_new[:, 0:3]
        root_quat = rot.quat_integrate(states.root_quat, u_new[:, 3:6], h)
    else:
        root_pos, root_quat = states.root_pos, states.root_quat

    joint_q = states.joint_q
    if len(T.sph_dofs):
        w_loc = u_new[:, T.sph_dofs].reshape(Bn, -1, 3)
        joint_q = rot.quat_integrate_local(states.joint_q, w_loc, h)
    hinge_q = states.hinge_q
    if len(T.hinge_dofs):
        hinge_q = states.hinge_q + h * u_new[:, T.hinge_dofs]

    prop_pos, prop_quat = states.prop_pos, states.prop_quat
    if P:
        blk = u_new[:, nu:].reshape(Bn, P, 6)
        wp = _clamp_w(model, blk[..., 3:6])
        u_new[:, nu:] = torch.cat([blk[..., 0:3], wp], dim=-1).reshape(Bn, -1)
        prop_pos = prop_pos + h * blk[..., 0:3]
        prop_quat = rot.quat_integrate(prop_quat, wp, h)

    new_states = State(root_pos=root_pos, root_quat=root_quat, joint_q=joint_q,
                       hinge_q=hinge_q, u=u_new, prop_pos=prop_pos, prop_quat=prop_quat)
    return new_states, body_forces, tau


def step_batched(model: M.Model, cfg: SimConfig, T: Tables, states: State,
                 actions: torch.Tensor, friction_scale=None, gain_scale=None,
                 mass_scale=None, gravity_scale=None, damping_scale=None,
                 restitution=None, actor_scale=None,
                 kin0: Optional[dynamics.Kin] = None) -> StepOut:
    """Advance one sim tick (``cfg.substeps`` substeps). ``kin0`` is an
    optional FK of ``states`` (the previous tick's ``StepOut.kin``, from the
    same ``actor_scale``).

    The domain-randomization knobs, each None when off: ``friction_scale``
    (B,) or per shape (B, nb + np); ``gain_scale`` (B,) or per dof (B, nd);
    ``mass_scale`` (B,) or per body (B, nb); ``gravity_scale`` (B,);
    ``damping_scale`` (B,) or (B, nd); ``restitution`` (B,); ``actor_scale``
    (B,)."""
    kin = kin0 if kin0 is not None else dynamics2.fk_batched(model, T.dyn, states, actor_scale)
    per_shape = friction_scale is not None and friction_scale.dim() == 2
    contacts = collision3.detect_batched(
        T.detect, kin.body_quat, kin.body_pos, states.prop_quat, states.prop_pos,
        cfg.max_contacts, margin=cfg.solver.contact_offset,
        friction_scale=friction_scale if per_shape else None, actor_scale=actor_scale)
    if friction_scale is not None and not per_shape:
        contacts = contacts._replace(friction=contacts.friction * friction_scale[:, None])
    forces = tau = None
    for _ in range(cfg.substeps):
        states, forces, tau = _substep_batched(
            model, cfg, T, states, actions, kin, contacts, gain_scale=gain_scale,
            mass_scale=mass_scale, gravity_scale=gravity_scale, damping_scale=damping_scale,
            restitution=restitution, actor_scale=actor_scale)
        kin = dynamics2.fk_batched(model, T.dyn, states, actor_scale)
    return StepOut(
        state=states,
        body_pos=kin.body_pos,
        body_quat=kin.body_quat,
        body_vel=kin.body_vel[..., 3:6],
        body_ang_vel=kin.body_vel[..., 0:3],
        contact_forces=forces,
        dof_forces=tau,
        kin=kin,
    )


# -- the one-env form and the batched helpers ----------------------------------


