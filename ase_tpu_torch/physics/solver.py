"""Velocity-level contact impulse solver on the generalized system (port of
``ase_tpu/physics/solver.py``): the contact Jacobian in (K, 3, nv) blocks,
the Coulomb projection, the one-env ``solve`` and the batched
``solve_batched`` with both iteration schemes.

* ``jacobi`` (the default): projected block-Jacobi with under-relaxation
  (``ops/jacobi_solver.py``). The engine's default path runs it in the
  component-grouped Z-form of ``physics/solver2.py`` instead; this module's
  form serves ``solve`` and the A/B comparison of the two.
* ``pgs``: sequential projected Gauss-Seidel. Each sweep visits the
  contacts 0..K-1 in order, and each contact's update sees the impulses
  of the contacts before it in the same sweep. The engine takes this path
  under ``solverScheme: pgs``.

Inactive contacts (depth below -contact_offset, the padding of the
contact selection, non-unit normals) get zero impulse.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ase_tpu_torch.ops import jacobi_solver, linalg3
from ase_tpu_torch.ops import spatial as sp
from ase_tpu_torch.physics import model as M
from ase_tpu_torch.physics.collision import Contacts

SCHEMES = ("jacobi", "pgs")


class SolverConfig(NamedTuple):
    iterations: int = 16
    relaxation: float = 0.35           # Jacobi under-relaxation
    scheme: str = "jacobi"             # "jacobi" | "pgs"
    baumgarte: float = 0.2
    slop: float = 0.002
    max_depenetration_velocity: float = 10.0
    impulse_cap_velocity: float = 25.0
    regularization: float = 1e-6
    matvec_bf16: bool = True           # bf16 Delassus product and matvec,
                                       # f32 accumulation (the reference default)
    contact_offset: float = 0.02


def check_scheme(scheme: str) -> None:
    """Raise on a scheme other than ``SCHEMES`` (the reference runs PGS for
    any string but "jacobi")."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown contact solver scheme {scheme!r}; known: {SCHEMES}")


def _tangent_basis(n: torch.Tensor):
    """Orthonormal tangents (..., 3), (..., 3) for the normals n (..., 3)."""
    use_z = (torch.abs(n[..., 2:3]) < 0.9).expand(n.shape)
    ref = torch.where(use_z, n.new_tensor([0.0, 0.0, 1.0]), n.new_tensor([1.0, 0.0, 0.0]))
    t1 = torch.linalg.cross(n, ref, dim=-1)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-9)
    return t1, torch.linalg.cross(n, t1, dim=-1)


def contact_jacobian(model: M.Model, contacts: Contacts, Phi: torch.Tensor,
                     Amask: torch.Tensor, origin: torch.Tensor,
                     prop_pos: torch.Tensor) -> torch.Tensor:
    """J (B, K, 3, nv): generalized velocity -> the contact-frame [n, t1, t2]
    velocity of body_a relative to body_b (``solver.py:80``). Phi (B, nu, 6)
    holds the articulation's dof axes at ``origin`` (B, 3); Amask (nb, nu)
    the ancestor-dof mask. Without props nv = nu; each prop adds its 6
    dofs (linear, angular), signed +1 as body_a and -1 as body_b."""
    B, K = contacts.depth.shape
    nb, nu, P = model.nb, model.nu, model.num_props
    t1, t2 = _tangent_basis(contacts.normal)
    basis = torch.stack([contacts.normal, t1, t2], dim=2)              # (B, K, 3, 3)

    # the point Jacobian is the same for every body at the point; only the
    # ancestor-dof mask differs, so J_rel = (mask_a - mask_b) * Jp
    lever = contacts.pos - origin[:, None, :]
    C = torch.linalg.cross(lever[:, :, None, :].expand(basis.shape), basis, dim=-1)
    Jp = (torch.einsum("bkij,bvj->bkiv", basis, Phi[..., 3:6])
          + torch.einsum("bkij,bvj->bkiv", C, Phi[..., 0:3]))       # (B, K, 3, nu)

    def art_mask(b):
        valid = ((b >= 0) & (b < nb)).to(torch.float32)
        return Amask[torch.clamp(b, 0, nb - 1)] * valid[..., None]     # (B, K, nu)

    J = (art_mask(contacts.body_a) - art_mask(contacts.body_b))[:, :, None, :] * Jp
    if P == 0:
        return J
    pid = nb + torch.arange(P, device=J.device)
    sgn = ((contacts.body_a[..., None] == pid).to(torch.float32)
           - (contacts.body_b[..., None] == pid).to(torch.float32))  # (B, K, P)
    r = contacts.pos[:, :, None, :] - prop_pos[:, None, :, :]          # (B, K, P, 3)
    eye = torch.eye(3, device=J.device).expand(B, K, P, 3, 3)
    blocks = torch.cat([eye, -sp.skew(r)], dim=-1) * sgn[..., None, None]   # (B, K, P, 3, 6)
    J_prop = torch.einsum("bkij,bkpjc->bkipc", basis, blocks).reshape(B, K, 3, 6 * P)
    return torch.cat([J, J_prop], dim=3)


def _project(lam: torch.Tensor, mu: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Coulomb cone projection of impulse blocks (..., 3) [n, t1, t2]."""
    ln = torch.clamp(lam[..., 0], min=0.0)
    lt = lam[..., 1:3]
    lt_norm = torch.linalg.norm(lt, dim=-1) + 1e-9
    scale = torch.clamp(mu * ln / lt_norm, max=1.0)
    return torch.cat([ln[..., None], lt * scale[..., None]], dim=-1) * active[..., None]


def _pgs_iterate(A, v0, target, diag_inv, mu, active, iterations: int) -> torch.Tensor:
    """Sequential projected Gauss-Seidel (``solver.py:304``), batched over
    envs: ``iterations`` sweeps over the contacts in order 0..K-1, each
    contact's block updated in place. A (B, 3K, 3K); v0, target (B, K, 3);
    diag_inv (B, K, 3, 3); mu, active (B, K). Returns lam (B, K, 3)."""
    B, K = mu.shape
    lam = torch.zeros(B, K, 3, device=A.device)
    lam_col = lam.view(B, 3 * K, 1)          # the live iterate, seen by every row
    rows = [A[:, 3 * k:3 * k + 3] for k in range(K)]
    for _ in range(iterations):
        for k in range(K):
            vk = v0[:, k] + torch.bmm(rows[k], lam_col)[..., 0]
            dlam = torch.einsum("bij,bj->bi", diag_inv[:, k], target[:, k] - vk)
            lam[:, k] = _project(lam[:, k] + dlam, mu[:, k], active[:, k])
    return lam


def _solve(model: M.Model, contacts: Contacts, J, W, u_free, dt: float, cfg: SolverConfig,
           one_env: bool):
    """The batched solve of ``solve`` (``one_env``) and ``solve_batched``.
    Returns (u_new (B, nv), lam (B, K, 3), body_forces (B, nb + np, 3))."""
    check_scheme(cfg.scheme)
    B, K = contacts.depth.shape
    n_ok = torch.abs(torch.sum(contacts.normal * contacts.normal, dim=-1) - 1.0) < 0.1
    active = ((contacts.depth > -cfg.contact_offset) & n_ok).to(torch.float32)
    mu = contacts.friction * active

    A = torch.bmm(J.reshape(B, 3 * K, -1), W)
    A = A + cfg.regularization * torch.eye(3 * K, device=A.device)

    # Baumgarte depenetration (PhysX-style clamp) + the speculative approach
    # allowance gap/dt of contacts still up to contact_offset apart
    v_bias = torch.clamp(
        cfg.baumgarte / dt * torch.clamp(contacts.depth - cfg.slop, min=0.0),
        max=cfg.max_depenetration_velocity,
    ) + torch.clamp(contacts.depth, max=0.0) / dt
    target = torch.cat([v_bias[..., None], v_bias.new_zeros(B, K, 2)], dim=-1)
    v0 = torch.einsum("bkiv,bv->bki", J, u_free)

    diag = torch.diagonal(A.reshape(B, K, 3, K, 3), dim1=1, dim2=3).permute(0, 3, 1, 2)
    diag = diag + 1e-5 * torch.eye(3, device=A.device)
    diag_inv = linalg3.inv3(diag)

    if not one_env:
        # rows whose own diagonal is tiny are uncontrollable: deactivate
        active = active * (diag[..., 0, 0] > 1e-4).to(torch.float32)
        mu = mu * active

    if cfg.scheme == "pgs":
        lam = _pgs_iterate(A, v0, target, diag_inv, mu, active, cfg.iterations)
    elif one_env:
        lam = jacobi_solver.solve_jacobi_xla(A, v0, target, diag_inv, mu, active,
                                             cfg.iterations, cfg.relaxation)
    else:
        # divergence guard: cap each normal impulse at the one that would
        # inject impulse_cap_velocity through its own diagonal
        lam_cap = cfg.impulse_cap_velocity / torch.clamp(diag[..., 0, 0], min=1e-3)
        A_it = A.to(torch.bfloat16) if cfg.matvec_bf16 else A
        lam = jacobi_solver.solve_jacobi(A_it, v0, target, diag_inv, mu, active,
                                         cfg.iterations, cfg.relaxation, lam_cap)

    u_new = u_free + torch.bmm(W, lam.reshape(B, -1, 1))[..., 0]

    # world-frame contact forces per body, +f on body_a and -f on body_b
    t1, t2 = _tangent_basis(contacts.normal)
    f_world = (lam[..., 0:1] * contacts.normal + lam[..., 1:2] * t1
               + lam[..., 2:3] * t2) / dt
    nbp = model.nb + model.num_props
    ar = torch.arange(nbp, device=lam.device)
    ba = torch.clamp(contacts.body_a, 0, nbp - 1)
    bb = torch.clamp(contacts.body_b, 0, nbp - 1)
    has_b = (contacts.body_b >= 0).to(torch.float32)
    oh = ((ba[..., None] == ar).to(torch.float32) * active[..., None]
          - (bb[..., None] == ar).to(torch.float32) * (active * has_b)[..., None])
    return u_new, lam, torch.einsum("bkc,bkx->bcx", oh, f_world)


def solve(model: M.Model, contacts: Contacts, J: torch.Tensor, W: torch.Tensor,
          u_free: torch.Tensor, dt: float, cfg: SolverConfig):
    """One env (``solver.py:145``): contacts of (K, ...), J (K, 3, nv), W
    (nv, 3K) = M^-1 J^T, u_free (nv,). Unlike ``solve_batched`` it
    deactivates no row by its diagonal, and its Jacobi iteration runs in
    float32 with no impulse cap. Returns (u_new (nv,), lam (K, 3),
    body_forces (nb + np, 3))."""
    one = Contacts(*(x[None] for x in contacts))
    out = _solve(model, one, J[None], W[None], u_free[None], dt, cfg, one_env=True)
    return tuple(x[0] for x in out)


def solve_batched(model: M.Model, contacts: Contacts, J: torch.Tensor, W: torch.Tensor,
                  u_free: torch.Tensor, dt: float, cfg: SolverConfig):
    """Batched contact solve (``solver.py:224``): contacts of (B, K, ...),
    J (B, K, 3, nv), W (B, nv, 3K), u_free (B, nv). PGS in float32; Jacobi
    with the impulse cap and, under ``cfg.matvec_bf16``, the bfloat16
    matvec. Returns (u_new (B, nv), lam (B, K, 3), body_forces (B, nb + np,
    3))."""
    return _solve(model, contacts, J, W, u_free, dt, cfg, one_env=False)
