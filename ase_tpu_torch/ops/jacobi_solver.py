"""Projected block-Jacobi contact iteration on (B, K, 3) blocks (port of
``ase_tpu/ops/jacobi_solver.py``: ``solve_jacobi_xla`` and
``solve_jacobi``).

Each of ``iterations`` rounds computes, per environment,
    r    = v0 + A lam
    dlam = Dinv . (target - r)           (the 3x3 block preconditioner)
    lam  = project_coulomb(lam + omega dlam)
with the normal impulse capped at ``lam_cap`` when one is given.

When ``A`` arrives as bfloat16, the matvec multiplies bfloat16 operands
and sums their products in float32 into a float32 result, as XLA's
``preferred_element_type=float32`` does: the operands are widened to
float32 first (exact), because torch rounds the output of a bfloat16
``bmm`` to bfloat16. The preconditioner, the projection and the iterate
stay float32.
"""

from __future__ import annotations

import torch


def solve_jacobi_xla(A, v0, target, diag_inv, mu, active, iterations: int, omega: float,
                     lam_cap=None) -> torch.Tensor:
    """A (B, 3K, 3K) float32 or bfloat16; v0, target (B, K, 3); diag_inv
    (B, K, 3, 3); mu, active, lam_cap (B, K). Returns lam (B, K, 3)."""
    B, K = mu.shape
    bf16 = A.dtype == torch.bfloat16
    A32 = A.float()
    lam = torch.zeros(B, K, 3, device=A.device)
    for _ in range(iterations):
        lam_in = lam.reshape(B, -1, 1)
        if bf16:
            lam_in = lam_in.to(torch.bfloat16).float()
        r = v0 + torch.bmm(A32, lam_in).reshape(B, K, 3)
        dlam = torch.einsum("bkij,bkj->bki", diag_inv, target - r)
        lam3 = lam + omega * dlam
        ln = torch.clamp(lam3[..., 0], min=0.0)
        if lam_cap is not None:
            ln = torch.minimum(ln, lam_cap)
        lt = lam3[..., 1:3]
        lt_norm = torch.linalg.norm(lt, dim=-1) + 1e-9
        scale = torch.clamp(mu * ln / lt_norm, max=1.0)
        lam = torch.cat([ln[..., None], lt * scale[..., None]], dim=-1) * active[..., None]
    return lam


def solve_jacobi(A, v0, target, diag_inv, mu, active, iterations: int, omega: float,
                 lam_cap=None) -> torch.Tensor:
    """The solver the contact solve calls: ``solve_jacobi_xla``. The
    reference's ``ASE_TPU_SOLVER_SOA`` escape to a component-grouped
    variant, which sums in another order, is not ported."""
    return solve_jacobi_xla(A, v0, target, diag_inv, mu, active, iterations, omega, lam_cap)
