"""Batched Cholesky + triangular solves for the engine's Z-form substep:
the plain tensor-op versions of ``ase_tpu_torch/ops/chol.py``, on any
device (the reference launches no hand-written kernel)."""

from __future__ import annotations

import torch


def chol_forward(M, rhs, rhs2=None):
    """Factor M = L L^T and forward-substitute Y = L^-1 rhs (and rhs2)."""
    return chol_forward_plain(M, rhs, rhs2)


def back_solve(L, y):
    """Solve L^T x = y."""
    return back_solve_plain(L, y)


# -- plain versions: the kernels' arithmetic as tensor ops -------------------

def chol_forward_plain(M, rhs, rhs2=None):
    """Right-looking Cholesky fused with forward substitution (the TPU
    kernel's loop, ``pallas_chol.py:122-142``) on batch-last tensors."""
    n = M.shape[0]
    L = M.clone()
    Y = rhs.clone()
    Y2 = rhs2.clone() if rhs2 is not None else None
    for k in range(n):
        akk = L[k, k].clone()
        dinv = torch.rsqrt(akk)
        L[k, k] = akk * dinv
        yk = Y[k] * dinv
        Y[k] = yk
        if Y2 is not None:
            y2k = Y2[k] * dinv
            Y2[k] = y2k
        if k + 1 < n:
            col = L[k + 1:, k] * dinv
            L[k + 1:, k] = col
            L[k + 1:, k + 1:] -= col[:, None, :] * col[None, :, :]
            Y[k + 1:] -= col[:, None, :] * yk[None, :, :]
            if Y2 is not None:
                Y2[k + 1:] -= col[:, None, :] * y2k[None, :, :]
    L = L * torch.tril(torch.ones(n, n, dtype=L.dtype, device=L.device))[:, :, None]
    return (L, Y) if rhs2 is None else (L, Y, Y2)


def back_solve_plain(L, y):
    """x = L^-T y by right-looking backward substitution
    (``pallas_chol.py:145-154``)."""
    n = L.shape[0]
    x = y.clone()
    for k in range(n - 1, -1, -1):
        dinv = torch.rsqrt(L[k, k] * L[k, k])
        xk = x[k] * dinv
        x[k] = xk
        if k > 0:
            x[:k] -= L[k, :k][:, None, :] * xk[None, :, :]
    return x
