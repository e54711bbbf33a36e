"""Spatial (6D) vector algebra (port of ``ase_tpu/ops/spatial.py``).

Spatial vectors are ``[angular(3), linear(3)]``. A transform from frame A
to frame B is ``(E, r)``: E (3x3) takes A coordinates to B coordinates, r
is B's origin in A coordinates (RBDA's ``plx(E, r)``).
"""

from __future__ import annotations

import torch


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def motion_cross(v, w):
    """v x_m w for spatial motion vectors."""
    vw, vl = v[..., 0:3], v[..., 3:6]
    ww, wl = w[..., 0:3], w[..., 3:6]
    return torch.cat([_cross(vw, ww), _cross(vw, wl) + _cross(vl, ww)], dim=-1)


def force_cross(v, f):
    """v x_f f for spatial force vectors (dual of motion_cross)."""
    vw, vl = v[..., 0:3], v[..., 3:6]
    fw, fl = f[..., 0:3], f[..., 3:6]
    return torch.cat([_cross(vw, fw) + _cross(vl, fl), _cross(vw, fl)], dim=-1)


def xform(E, r):
    """Motion transform X (...,6,6) from (E, r): v_B = X v_A."""
    Erx = E @ skew(r)
    top = torch.cat([E, torch.zeros_like(E)], dim=-1)
    bot = torch.cat([-Erx, E], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _mv(E, v):
    return (E @ v[..., None])[..., 0]


def _mtv(E, v):
    return (E.transpose(-1, -2) @ v[..., None])[..., 0]


def xform_motion(E, r, v):
    """X v without materializing the 6x6."""
    w, lin = v[..., 0:3], v[..., 3:6]
    return torch.cat([_mv(E, w), _mv(E, lin - _cross(r, w))], dim=-1)


def xform_motion_inv(E, r, v):
    """X^-1 v: a motion from frame B back to frame A."""
    w, lin = v[..., 0:3], v[..., 3:6]
    Etw = _mtv(E, w)
    return torch.cat([Etw, _mtv(E, lin) + _cross(r, Etw)], dim=-1)


def xform_force_to_parent(E, r, f):
    """X^T f: a force from the child frame B back to the parent frame A."""
    n, lin = f[..., 0:3], f[..., 3:6]
    Etl = _mtv(E, lin)
    return torch.cat([_mtv(E, n) + _cross(r, Etl), Etl], dim=-1)


def spatial_inertia(mass, com, inertia_com):
    """Spatial inertia (...,6,6) at the body frame origin."""
    cx = skew(com)
    m = mass[..., None, None]
    top_left = inertia_com + m * (cx @ cx.transpose(-1, -2))
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([top_left, m * cx], dim=-1)
    bot = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)
