"""Component-grouped contact pipeline (port of ``ase_tpu/physics/solver2.py``).

The transposed contact Jacobian is built in the batch-last (nu, 3K, B)
layout the Cholesky kernel takes, its 3K columns grouped by contact-frame
component [normals | t1 | t2]; per-contact 3x3 block quantities live in
(B, K) component tensors. The free props' block ``JT_prop`` (B, 6 np, 3K)
is built with ops over a props axis, so its launch count does not grow
with the number of props. ``contact_jacobian_t`` and ``solve_batched_t``
are the reference's batch-first forms, which the engine does not run: the
tests hold the batch-last builder against the first, and the first
against the reference.
"""

from __future__ import annotations

import torch

from ase_tpu_torch.physics import model as M
from ase_tpu_torch.physics.collision import Contacts
from ase_tpu_torch.physics.solver import SolverConfig


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _basis_comps(normal):
    """Orthonormal contact frame as component tuples of (B, K)."""
    n = tuple(normal[..., k] for k in range(3))
    use_z = torch.abs(n[2]) < 0.9
    one, zero = torch.ones_like(n[0]), torch.zeros_like(n[0])
    ref = (torch.where(use_z, zero, one), zero, torch.where(use_z, one, zero))
    t1 = _cross(n, ref)
    t1n = torch.clamp(torch.sqrt(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]), min=1e-9)
    t1 = tuple(c / t1n for c in t1)
    t2 = _cross(n, t1)
    return n, t1, t2


def _active(contacts: Contacts, contact_offset: float) -> torch.Tensor:
    n_ok = torch.abs(torch.sum(contacts.normal * contacts.normal, dim=-1) - 1.0) < 0.1
    return ((contacts.depth > -contact_offset) & n_ok).to(torch.float32)


def contact_jacobian_t_bl(model: M.Model, contacts: Contacts, Phi: torch.Tensor,
                          Amask: torch.Tensor, origin: torch.Tensor,
                          prop_pos: torch.Tensor):
    """(JT (nu, 3K, B) batch-last and contiguous, JT_prop (B, 6 np, 3K) or
    None without props) (``solver2.py:123``). The articulation block's
    one-hot runs over the nb articulated bodies, so contacts on props add
    nothing to it."""
    nb = model.nb
    n, t1, t2 = _basis_comps(contacts.normal)
    lever = tuple(contacts.pos[..., k] - origin[:, k:k + 1] for k in range(3))
    Pa = tuple(Phi[..., k].T for k in range(3))         # (nu, B)
    Pl = tuple(Phi[..., 3 + k].T for k in range(3))

    ar = torch.arange(nb, device=Phi.device)
    oh = ((contacts.body_a[..., None] == ar).to(torch.float32)
          - (contacts.body_b[..., None] == ar).to(torch.float32))    # (B, K, nb)
    mdiff = torch.einsum("cv,bkc->vkb", Amask, oh)                   # (nu, K, B)

    def art_block(b):
        c = _cross(lever, b)
        core = sum(
            Pl[x][:, None, :] * b[x].T[None, :, :] + Pa[x][:, None, :] * c[x].T[None, :, :]
            for x in range(3)
        )
        return mdiff * core

    JT = torch.cat([art_block(n), art_block(t1), art_block(t2)], dim=1)
    if model.num_props == 0:
        return JT, None
    return JT, _jacobian_t_prop(model, contacts, prop_pos, (n, t1, t2))


def contact_jacobian_t(model: M.Model, contacts: Contacts, Phi: torch.Tensor,
                       Amask: torch.Tensor, origin: torch.Tensor,
                       prop_pos: torch.Tensor) -> torch.Tensor:
    """JT (B, nv, 3K) batch-first, columns grouped [n | t1 | t2], the props'
    rows after the articulation's (``solver2.py:60``)."""
    nb = model.nb
    n, t1, t2 = _basis_comps(contacts.normal)
    lever = tuple(contacts.pos[..., k] - origin[:, k:k + 1] for k in range(3))
    Pa = tuple(Phi[..., k] for k in range(3))           # (B, nu) angular
    Pl = tuple(Phi[..., 3 + k] for k in range(3))       # linear

    ar = torch.arange(nb, device=Phi.device)
    oh_a = (contacts.body_a[..., None] == ar).to(torch.float32)     # (B, K, nb)
    oh_b = (contacts.body_b[..., None] == ar).to(torch.float32)
    mdiff = torch.einsum("bkc,cv->bvk", oh_a - oh_b, Amask)         # (B, nu, K)

    def art_block(b):
        c = _cross(lever, b)
        core = sum(Pl[x][:, :, None] * b[x][:, None, :] + Pa[x][:, :, None] * c[x][:, None, :]
                   for x in range(3))
        return mdiff * core

    JT = torch.cat([art_block(n), art_block(t1), art_block(t2)], dim=2)
    if model.num_props == 0:
        return JT
    return torch.cat([JT, _jacobian_t_prop(model, contacts, prop_pos, (n, t1, t2))], dim=1)


def _jacobian_t_prop(model: M.Model, contacts: Contacts, prop_pos: torch.Tensor, basis):
    """(B, 6 np, 3K): for prop p the rows [lin x, y, z | ang x, y, z], each
    3K long in the [n | t1 | t2] column order, signed +1 where the prop is
    body_a of a contact and -1 where it is body_b (``solver2.py:170-195``)."""
    B, K = contacts.depth.shape
    P = model.num_props
    pid = model.nb + torch.arange(P, device=prop_pos.device)
    sgn = ((contacts.body_a[..., None] == pid).to(torch.float32)
           - (contacts.body_b[..., None] == pid).to(torch.float32))  # (B, K, P)
    sgn = sgn.permute(0, 2, 1)[:, :, None, None, :]                  # (B, P, 1, 1, K)
    bas = torch.stack([torch.stack(b, dim=-1) for b in basis], dim=1)   # (B, 3 basis, K, 3)
    r = contacts.pos[:, None] - prop_pos[:, :, None]                 # (B, P, K, 3)
    rxb = torch.stack(_cross(tuple(r[:, :, None, :, x] for x in range(3)),
                             tuple(bas[:, None, :, :, x] for x in range(3))), dim=2)
    lin = bas.permute(0, 3, 1, 2)[:, None]                           # (B, 1, 3 comp, 3 basis, K)
    rows = torch.cat([lin.expand(B, P, 3, 3, K), rxb], dim=2) * sgn   # (B, P, 6, 3, K)
    return rows.reshape(B, 6 * P, 3 * K)


def _inv3_comps(D):
    a, b, c = D[0][0], D[0][1], D[0][2]
    d, e, f = D[1][0], D[1][1], D[1][2]
    g, h, i = D[2][0], D[2][1], D[2][2]
    A = e * i - f * h
    Bc = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * Bc + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-12, det, torch.ones_like(det))
    return (
        (A * inv_det, (c * h - b * i) * inv_det, (b * f - c * e) * inv_det),
        (Bc * inv_det, (a * i - c * g) * inv_det, (c * d - a * f) * inv_det),
        (C * inv_det, (b * g - a * h) * inv_det, (a * e - b * d) * inv_det),
    )


def solve_batched_t(model: M.Model, contacts: Contacts, JT: torch.Tensor, W: torch.Tensor,
                    u_free: torch.Tensor, dt: float, cfg: SolverConfig):
    """The contact solve on a batch-first JT and W = M^-1 J^T, both (B, nv,
    3K) component-grouped (``solver2.py:215``). Returns (u_new (B, nv),
    lam (B, K, 3), body_forces (B, nb + np, 3))."""
    A = torch.einsum("bvi,bvj->bij", JT, W)
    v0f = torch.einsum("bvi,bv->bi", JT, u_free)
    lam_f = jacobi_lambda(contacts, A, v0f, dt, cfg)
    u_new = u_free + torch.einsum("bvj,bj->bv", W, lam_f)
    body_forces = body_forces_from_lambda(model, contacts, lam_f, dt)
    K = contacts.depth.shape[1]
    lam = torch.stack([lam_f[:, :K], lam_f[:, K:2 * K], lam_f[:, 2 * K:]], dim=-1)
    return u_new, lam, body_forces


def jacobi_lambda(contacts: Contacts, A: torch.Tensor, v0f: torch.Tensor,
                  dt: float, cfg: SolverConfig, restitution: torch.Tensor = None,
                  vn_pre: torch.Tensor = None) -> torch.Tensor:
    """Block-Jacobi Coulomb iteration on the Delassus operator A (B, 3K, 3K)
    (``solver2.py:238``). Returns lam (B, 3K), component-grouped.

    With ``restitution`` (B,) and ``vn_pre`` (B, K), the pre-solve normal
    contact velocities, an impacting contact gets a Newton bounce target:
    its normal velocity is driven to e max(-vn_pre, 0) on top of the
    Baumgarte bias.

    With ``cfg.matvec_bf16`` the operator and each iterate enter the matvec
    rounded to bfloat16 and the products accumulate in float32, as the
    reference's ``preferred_element_type=float32`` einsum does; A is held
    as float32 copies of its bfloat16 values, whose products are exact in
    float32."""
    B, K = contacts.depth.shape
    active = _active(contacts, cfg.contact_offset)
    mu = contacts.friction * active
    reg = cfg.regularization

    v_bias = torch.clamp(
        cfg.baumgarte / dt * torch.clamp(contacts.depth - cfg.slop, min=0.0),
        max=cfg.max_depenetration_velocity,
    ) + torch.clamp(contacts.depth, max=0.0) / dt
    if restitution is not None:
        v_bias = v_bias + restitution[:, None] * torch.clamp(-vn_pre, min=0.0)

    A_it = A.to(torch.bfloat16).to(torch.float32) if cfg.matvec_bf16 else A.to(torch.float32)

    dblk = torch.diagonal(A_it.reshape(B, 3, K, 3, K), dim1=2, dim2=4)   # (B, 3, 3, K)
    D = [[dblk[:, i, j] + (reg + 1e-5 if i == j else 0.0) for j in range(3)]
         for i in range(3)]
    Dinv = _inv3_comps(D)

    active = active * (D[0][0] > 1e-4).to(torch.float32)
    mu = mu * active
    lam_cap = cfg.impulse_cap_velocity / torch.clamp(D[0][0], min=1e-3)
    omega = cfg.relaxation

    lam = torch.zeros(B, 3 * K, device=A.device)
    for _ in range(cfg.iterations):
        lam_in = lam.to(torch.bfloat16).to(torch.float32) if cfg.matvec_bf16 else lam
        r = v0f + reg * lam + torch.bmm(A_it, lam_in[:, :, None])[:, :, 0]
        en = v_bias - r[:, :K]
        e1 = -r[:, K:2 * K]
        e2 = -r[:, 2 * K:]
        dn = Dinv[0][0] * en + Dinv[0][1] * e1 + Dinv[0][2] * e2
        d1 = Dinv[1][0] * en + Dinv[1][1] * e1 + Dinv[1][2] * e2
        d2 = Dinv[2][0] * en + Dinv[2][1] * e1 + Dinv[2][2] * e2
        ln = torch.minimum(torch.clamp(lam[:, :K] + omega * dn, min=0.0), lam_cap)
        l1 = lam[:, K:2 * K] + omega * d1
        l2 = lam[:, 2 * K:] + omega * d2
        lt_norm = torch.sqrt(l1 * l1 + l2 * l2) + 1e-9
        scale = torch.clamp(mu * ln / lt_norm, max=1.0)
        lam = torch.cat([ln * active, l1 * scale * active, l2 * scale * active], dim=1)
    return lam


def body_forces_from_lambda(model: M.Model, contacts: Contacts, lam_f: torch.Tensor,
                            dt: float, contact_offset: float = 0.0) -> torch.Tensor:
    """World-frame per-body contact forces (B, nb + np, 3)
    (``solver2.py:332``)."""
    K = contacts.depth.shape[1]
    active = _active(contacts, contact_offset)
    n, t1, t2 = _basis_comps(contacts.normal)
    ln, l1, l2 = lam_f[:, :K], lam_f[:, K:2 * K], lam_f[:, 2 * K:]
    f = torch.stack([(ln * nk + l1 * t1k + l2 * t2k) / dt
                     for nk, t1k, t2k in zip(n, t1, t2)], dim=-1)     # (B, K, 3)
    ar = torch.arange(model.nb + model.num_props, device=lam_f.device)
    oh = (((contacts.body_a[..., None] == ar).to(torch.float32)
           - (contacts.body_b[..., None] == ar).to(torch.float32)) * active[..., None])
    return torch.einsum("bkc,bkx->bcx", oh, f)
