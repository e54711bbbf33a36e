"""Batched Cholesky + triangular solves for the engine's Z-form substep.

Port of ``ase_tpu/ops/pallas_chol.py``. Layouts stay batch-last -- M
(n, n, B), right-hand sides (n, m, B) -- so the port's tests hold these
functions against the JAX ones like with like.

Each public function is a kernel wrapper:

* on a CUDA tensor it launches the hand-written Hopper kernel of
  ``csrc/chol.cu`` (built by nvcc, bound with ctypes) or raises;
* on a CPU tensor it takes the plain PyTorch version beside it, which
  repeats the kernel's arithmetic with tensor ops.

``LAUNCHES`` counts kernel launches per kernel (never plain-version calls),
so a run can show that its main path went through the kernels.

Kernels and the TPU kernels they replace:

=================  ==========================================================
``chol_forward2``  ``_chol_forward2_kernel`` (``pallas_chol.py:122``), reached
                   as ``chol_forward(M, rhs, rhs2)`` -- the engine's call
``chol_forward``   ``_chol_forward_kernel`` (``pallas_chol.py:105``): the same
                   CUDA kernel with no second right-hand side
``back_solve``     ``_back_solve_kernel`` (``pallas_chol.py:145``)
=================  ==========================================================

Bounds at the engine's shapes (n = 37, m = 72, m2 = 1, B = 4096):
``chol_forward2`` reads M's lower triangle, rhs and rhs2 and writes L, Y
and Y2: ~122 MB for ~0.5 GFLOP, so it is memory-bound, a floor of ~37 us at
the H100 SXM's data-sheet 3.35 TB/s (700 W); ``back_solve`` reads L's lower
triangle and y and writes x: ~12.7 MB, a floor of ~3.8 us.

Designs (``csrc/chol.cu`` has the details; PERF.md the measured times):
``chol_forward`` runs 32 envs x 32 warps per block and factors left-looking
in shared memory. ``back_solve`` runs 32 envs x 8 warps per block: all
threads stage L's lower triangle by ``cp.async`` with every copy in flight
at once, then pairs of warps solve columns of y, two lanes per env. The
copies are 16 bytes when L's ``data_ptr`` is 16-byte aligned and B % 4 ==
0, else 4 bytes; the launcher chooses, so every contiguous L is taken.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ase_tpu_torch.ops import cuda_build

LAUNCHES = {"chol_forward2": 0, "chol_forward": 0, "back_solve": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, x: torch.Tensor, n: int, B: int, device) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: float32 required, got {x.dtype}")
    if x.dim() != 3 or x.shape[0] != n or x.shape[2] != B:
        raise ValueError(f"{name}: want shape ({n}, m, {B}), got {tuple(x.shape)}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, M on {device}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (batch-last layout)")


def _check_square(M: torch.Tensor) -> None:
    if M.dim() != 3 or M.shape[0] != M.shape[1]:
        raise ValueError(f"M: want (n, n, B), got {tuple(M.shape)}")
    _check("M", M, M.shape[0], M.shape[2], M.device)


def _lib():
    lib = cuda_build.load("chol")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ase_chol_forward.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
        lib.ase_chol_forward.restype = i
        lib.ase_back_solve.argtypes = [p, p, p, i, i, i, p]
        lib.ase_back_solve.restype = i
        lib.ase_chol_max_n.argtypes = []
        lib.ase_chol_max_n.restype = i
        lib.ase_chol_init.argtypes = []
        lib.ase_chol_init.restype = i
        pi = ctypes.POINTER(i)
        for layout in (lib.ase_chol_forward_layout, lib.ase_back_solve_layout):
            layout.argtypes = [i, pi, pi, pi]
            layout.restype = i
        lib.max_n = lib.ase_chol_max_n()
        lib._typed = True
    return lib


_ready = set()   # indices of the devices whose kernels ase_chol_init set up


def _cuda_lib(device: torch.device, n: int):
    if device.type != "cuda":
        raise RuntimeError(f"chol kernels run on cuda or cpu tensors, got {device}")
    lib = _lib()
    if device.index not in _ready:
        with torch.cuda.device(device):
            _raise_on(lib.ase_chol_init(), "chol kernel set-up")
        _ready.add(device.index)
    if n > lib.max_n:
        raise ValueError(f"chol kernel takes n <= {lib.max_n}, got {n}")
    return lib


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {err}")


def chol_forward(M: torch.Tensor, rhs: torch.Tensor,
                 rhs2: Optional[torch.Tensor] = None):
    """Factor M = L L^T and forward-substitute Y = L^-1 rhs, fused.

    M (n, n, B) SPD, rhs (n, m, B), optional rhs2 (n, m2, B), all float32,
    batch-last, contiguous. Returns (L, Y) or (L, Y, Y2); L is lower with
    zeros above the diagonal."""
    _check_square(M)
    n, B = M.shape[0], M.shape[2]
    _check("rhs", rhs, n, B, M.device)
    if rhs2 is not None:
        _check("rhs2", rhs2, n, B, M.device)
    if M.device.type == "cpu":
        return chol_forward_plain(M, rhs, rhs2)
    lib = _cuda_lib(M.device, n)
    L = torch.empty_like(M)
    Y = torch.empty_like(rhs)
    Y2 = torch.empty_like(rhs2) if rhs2 is not None else None
    stream = torch.cuda.current_stream(M.device).cuda_stream
    with torch.cuda.device(M.device):   # the launch goes to the current device's context
        err = lib.ase_chol_forward(
            M.data_ptr(), rhs.data_ptr(), rhs2.data_ptr() if rhs2 is not None else None,
            L.data_ptr(), Y.data_ptr(), Y2.data_ptr() if Y2 is not None else None,
            n, rhs.shape[1], 0 if rhs2 is None else rhs2.shape[1], B, stream)
    _raise_on(err, "chol_forward")
    if rhs2 is None:
        LAUNCHES["chol_forward"] += 1
        return L, Y
    LAUNCHES["chol_forward2"] += 1
    return L, Y, Y2


def back_solve(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y (backward substitution). L (n, n, B), y (n, m, B),
    float32, batch-last, contiguous; only L's lower triangle is read. An L
    that is not 16-byte aligned, or a B that is not a multiple of 4, takes
    the kernel's 4-byte staging copies instead of its 16-byte ones."""
    _check_square(L)
    n, B = L.shape[0], L.shape[2]
    _check("y", y, n, B, L.device)
    if L.device.type == "cpu":
        return back_solve_plain(L, y)
    lib = _cuda_lib(L.device, n)
    x = torch.empty_like(y)
    stream = torch.cuda.current_stream(L.device).cuda_stream
    with torch.cuda.device(L.device):
        err = lib.ase_back_solve(L.data_ptr(), y.data_ptr(), x.data_ptr(),
                                 n, y.shape[1], B, stream)
    _raise_on(err, "back_solve")
    LAUNCHES["back_solve"] += 1
    return x


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
