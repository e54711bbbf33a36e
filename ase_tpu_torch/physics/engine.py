"""The simulation engine: one batched sim tick over its substeps (port of
``ase_tpu/physics/engine.py``: ``step_batched`` and ``_substep_batched``).

Per tick: one narrow phase at the pre-tick pose (PhysX-TGS cadence, the
reference's default), then ``substeps`` substeps of: dynamics assembly,
the actuation torques (Stable-PD on position targets, or under
``torque_control`` the actions times the motor gear and ``power_scale``)
plus the limit torques, the contact step, and semi-implicit integration.

The contact step follows ``cfg.solver.scheme``:
- ``jacobi`` (the default): the Z-form path. The contact Jacobian, ONE
  fused Cholesky + forward substitution (``ops.chol.chol_forward``, a CUDA
  kernel on the card), the block-Jacobi contact solve on A = Z^T Z, ONE
  backward substitution (``ops.chol.back_solve``).
- ``pgs``: the reference's AoS branch. The mass matrix factored by the
  library (``cholesky_ex``), qdd and W = M^-1 J^T by two-sided triangular
  solves, and the sequential projected Gauss-Seidel solve of
  ``physics/solver.py``. It launches none of the Cholesky kernels: the
  reference runs none on this branch either.
Any other scheme raises ``ValueError`` (the reference runs PGS for it).

Free props (the strike target, the perturb projectiles) are solved in
closed form beside the articulation: each is a rigid body with 6 velocity
dofs after the articulation's in ``u``, its free step (gravity and the
gyroscopic term) done explicitly, its inverse mass in the contact solve
through ``W_prop``. They add no row to the Cholesky systems.

Domain randomization reaches the tick through the reference's knobs
(``engine.py:421``): friction per env or per shape, the gain (stiffness)
scale of the actuation torque per env or per dof, mass per env or per
body, gravity (props included), damping, the plane's restitution (a
Newton bounce target on the pre-solve normal velocities; the PGS branch
ignores it, as the reference's does) and the actor's geometric scale (FK,
dynamics and the humanoid's geoms). A knob left at None costs nothing;
the Cholesky systems stay n = nu whatever the knobs.

``step`` is the reference's one-env form (a batch of one through
``step_batched``, so on the card it launches the kernels at B = 1);
``make_batched_step`` and ``batch_default_state`` are its batched
helpers. The AoS oracles (``dynamics.fk``, ``compute_dynamics``,
``pd_torques``, ``limit_torques``, ``collision2.detect``) are held against
the tick's parts in the tests and ``chip_smoke.py``, never switched into
it: the reference's ``ASE_TPU_*_AOS`` and ``ASE_TPU_COLLISION_PER_SUBSTEP``
A/B switches are left out.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import torch

from ase_tpu_torch.ops import chol, linalg3
from ase_tpu_torch.ops import quat as rot
from ase_tpu_torch.physics import collision3, dynamics, dynamics2, solver, solver2
from ase_tpu_torch.physics import model as M
from ase_tpu_torch.physics.dynamics import State
from ase_tpu_torch.physics.solver import SolverConfig


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


def _free_props(model: M.Model, states: State, h: float, gravity_scale=None):
    """The props' free step: gravity (randomized with the rest of the sim)
    on the linear velocity and the gyroscopic term, implicitly damped, on
    the angular one (``engine.py:229-248``). Returns (u_free_prop (B,
    6 np), I_w (B, np, 3, 3) world inertias)."""
    Bn, P = states.u.shape[0], model.num_props
    blk = states.u[:, model.nu:].reshape(Bn, P, 6)
    R = rot.quat_to_rotation_matrix(states.prop_quat)               # (B, np, 3, 3)
    if gravity_scale is None:
        v = blk[..., 0:3] + h * model.gravity
    else:
        v = blk[..., 0:3] + h * model.gravity * gravity_scale[:, None, None]
    I_w = torch.einsum("bpij,pjk,bplk->bpil", R, model.inertia[model.nb:], R)
    w = blk[..., 3:6]
    Iww = torch.einsum("bpij,bpj->bpi", I_w, w)
    wdot = linalg3.solve3(I_w, -torch.linalg.cross(w, Iww, dim=-1))
    w = (w + h * wdot) / (1.0 + h * model.ang_damping)
    return torch.cat([v, w], dim=-1).reshape(Bn, -1), I_w


def _zform_contact_step(model: M.Model, cfg: SimConfig, T: Tables, states: State, contacts,
                        M_bl, bias, Phi, tau_full, u_free_prop, I_w, restitution):
    """The Jacobi scheme's contact step in Z-form (``engine.py:262-334``):
    with Z = L^-1 J^T the Delassus operator is A = Z^T Z and the free
    contact velocity is J u + h Z^T y0, y0 = L^-1 (tau - bias), so one fused
    factor and forward substitution (``chol.chol_forward``) and one
    backward substitution (``chol.back_solve``) carry the substep.
    Returns (u_new (B, nv), body_forces (B, nb + np, 3))."""
    h = cfg.dt / cfg.substeps
    nu, P = model.nu, model.num_props
    Bn = tau_full.shape[0]
    JT_bl, JT_prop = solver2.contact_jacobian_t_bl(
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
    if P:
        # the props' inverse mass on their Jacobian block: W = M_prop^-1 J_prop^T
        Jp = JT_prop.reshape(Bn, P, 6, -1)
        lin = Jp[:, :, 0:3] / model.mass[model.nb:, None, None]
        ang = torch.einsum("bpij,bpjm->bpim", linalg3.inv3(I_w), Jp[:, :, 3:6])
        W_prop = torch.cat([lin, ang], dim=2).reshape(Bn, 6 * P, -1)
        A = A + torch.bmm(JT_prop.transpose(1, 2), W_prop).to(A.dtype)
        v0f = v0f + torch.einsum("bvi,bv->bi", JT_prop, u_free_prop)
    if restitution is None:
        lam_f = solver2.jacobi_lambda(contacts, A, v0f, h, cfg.solver)
    else:
        # the pre-solve normal contact velocities, the bounce's reference
        vn_pre = v_art_cur
        if P:
            vn_pre = vn_pre + torch.einsum("bvi,bv->bi", JT_prop, states.u[:, nu:])
        vn_pre = vn_pre[:, :contacts.depth.shape[1]]
        lam_f = solver2.jacobi_lambda(contacts, A, v0f, h, cfg.solver,
                                      restitution=restitution, vn_pre=vn_pre)

    du_bl = (h * y0 + torch.einsum("vib,bi->vb", Z, lam_f))[:, None, :].contiguous()
    u_new = u_art + chol.back_solve(L_bl, du_bl)[:, 0, :].T
    if P:
        u_new = torch.cat([u_new, u_free_prop + torch.einsum("bvj,bj->bv", W_prop, lam_f)], 1)
    body_forces = solver2.body_forces_from_lambda(
        model, contacts, lam_f, h, contact_offset=cfg.solver.contact_offset)
    return u_new, body_forces


def _aos_contact_step(model: M.Model, cfg: SimConfig, T: Tables, states: State, contacts,
                      M_bl, bias, Phi, tau_full, u_free_prop, I_w, restitution):
    """The PGS scheme's contact step on the AoS branch (``engine.py:335-366``):
    the mass matrix factored and solved two-sided for qdd and for
    W = M^-1 J^T (library calls: the reference runs these outside any
    Pallas kernel), the props' block of W from their 3x3 inverses, then
    ``solver.solve_batched``. As in the reference, this branch ignores the
    ``restitution`` knob. Returns (u_new (B, nv), body_forces (B, nb + np,
    3))."""
    h = cfg.dt / cfg.substeps
    nu, P = model.nu, model.num_props
    Bn = tau_full.shape[0]
    # cholesky_ex: torch.linalg.cholesky would sync the host to check info
    L = torch.linalg.cholesky_ex(M_bl.permute(2, 0, 1), check_errors=False).L
    J = solver.contact_jacobian(model, contacts, Phi, T.Amask, states.root_pos,
                                states.prop_pos)                   # (B, K, 3, nv)
    Jf = J.reshape(Bn, -1, model.nv)
    # qdd and W_art share the two triangular solves: columns [tau - bias | J^T]
    rhs = torch.cat([(tau_full - bias)[:, :, None], Jf[..., :nu].transpose(1, 2)], dim=2)
    X = torch.linalg.solve_triangular(
        L.mT, torch.linalg.solve_triangular(L, rhs, upper=False), upper=True)
    u_free, W = states.u[:, :nu] + h * X[:, :, 0], X[:, :, 1:]
    if P:
        Jp = Jf[..., nu:].transpose(1, 2).reshape(Bn, P, 6, -1)
        lin = Jp[:, :, 0:3] / model.mass[model.nb:, None, None]
        ang = torch.einsum("bpij,bpjm->bpim", linalg3.inv3(I_w), Jp[:, :, 3:6])
        W = torch.cat([W, torch.cat([lin, ang], dim=2).reshape(Bn, 6 * P, -1)], dim=1)
        u_free = torch.cat([u_free, u_free_prop], dim=1)
    u_new, _, body_forces = solver.solve_batched(model, contacts, J, W, u_free, h, cfg.solver)
    return u_new, body_forces


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
    tau_full = torch.zeros(Bn, nu, device=actions.device)
    tau_full[:, rd:] = tau
    u_free_prop = I_w = None
    if P:
        u_free_prop, I_w = _free_props(model, states, h, gravity_scale)

    contact_step = _aos_contact_step if cfg.solver.scheme == "pgs" else _zform_contact_step
    u_new, body_forces = contact_step(model, cfg, T, states, contacts, M_bl, bias, Phi,
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

def _unbatch(x):
    if isinstance(x, tuple):
        return type(x)(*(_unbatch(y) for y in x))
    return x[0]


def step(model: M.Model, cfg: SimConfig, tables: Tables, state: State, action: torch.Tensor,
         friction_scale=1.0, gain_scale=1.0) -> StepOut:
    """One sim tick of one env: ``state`` and ``action`` (nd,) carry no
    batch dim; they go through ``step_batched`` as a batch of one, and the
    outputs come back without it. A scale of 1.0 is no randomization."""
    dev = action.device

    def knob(x):
        return None if isinstance(x, (int, float)) and x == 1.0 else \
            torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1)

    states = State(*(x[None] for x in state))
    out = step_batched(model, cfg, tables, states, action[None],
                       friction_scale=knob(friction_scale), gain_scale=knob(gain_scale))
    return _unbatch(out)


def make_batched_step(model: M.Model, cfg: SimConfig):
    """(states, actions (B, nd)) -> StepOut, over this model's tables."""
    return partial(step_batched, model, cfg, Tables(model, cfg))


def batch_default_state(model: M.Model, batch: int) -> State:
    return dynamics.default_state(model, batch)
