"""Quaternion / rotation functions on tensors (port of ``ase_tpu/ops/quat.py``).

Quaternions are ``(x, y, z, w)`` on the last axis. Every function broadcasts
over leading dims and is guarded at its singular points exactly as the
reference is, so the two agree to float32 rounding.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def _unit_axis(ref: torch.Tensor, k: int) -> torch.Tensor:
    e = torch.zeros_like(ref[..., 0:3])
    e[..., k] = 1.0
    return e


def quat_identity(shape=(), device=None) -> torch.Tensor:
    q = torch.zeros(tuple(shape) + (4,), device=device)
    q[..., 3] = 1.0
    return q


def quat_unit(q):
    norm = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(norm, min=_EPS)


def quat_conjugate(q):
    return torch.cat([-q[..., 0:3], q[..., 3:4]], dim=-1)


def quat_mul(a, b):
    ax, ay, az, aw = a.unbind(-1)
    bx, by, bz, bw = b.unbind(-1)
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by + ay * bw + az * bx - ax * bz
    z = aw * bz + az * bw + ax * by - ay * bx
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_mul_norm(a, b):
    return quat_unit(quat_mul(a, b))


def quat_rotate(q, v):
    qvec = q[..., 0:3]
    w = q[..., 3:4]
    t = 2.0 * _cross(qvec, v)
    return v + w * t + _cross(qvec, t)


def quat_rotate_inverse(q, v):
    return quat_rotate(quat_conjugate(q), v)


def quat_abs_positive(q):
    """Flip the sign so that w >= 0 (the canonical hemisphere)."""
    return q * torch.where(q[..., 3:4] < 0.0, -1.0, 1.0)


def normalize_angle(x):
    return torch.atan2(torch.sin(x), torch.cos(x))


def quat_from_angle_axis(angle, axis):
    half = 0.5 * angle
    xyz = axis * torch.sin(half)[..., None]
    w = torch.cos(half)[..., None].expand(xyz.shape[:-1] + (1,))
    return torch.cat([xyz, w], dim=-1)


def quat_to_angle_axis(q):
    min_theta = 1e-5
    w = torch.clamp(q[..., 3], -1.0, 1.0)
    sin_theta = torch.sqrt(torch.clamp(1.0 - w * w, min=0.0))
    angle = normalize_angle(2.0 * torch.acos(w))
    mask = sin_theta > min_theta
    safe_sin = torch.where(mask, sin_theta, torch.ones_like(sin_theta))
    axis = q[..., 0:3] / safe_sin[..., None]
    angle = torch.where(mask, angle, torch.zeros_like(angle))
    axis = torch.where(mask[..., None], axis, _unit_axis(q, 2))
    return angle, axis


def angle_axis_to_exp_map(angle, axis):
    return angle[..., None] * axis


def quat_to_exp_map(q):
    angle, axis = quat_to_angle_axis(q)
    return angle_axis_to_exp_map(angle, axis)


def exp_map_to_angle_axis(exp_map):
    min_theta = 1e-5
    sq = torch.sum(exp_map * exp_map, dim=-1)
    angle = torch.sqrt(torch.clamp(sq, min=_EPS))
    mask = angle > min_theta
    safe_angle = torch.where(mask, angle, torch.ones_like(angle))
    axis = exp_map / safe_angle[..., None]
    wrapped = normalize_angle(angle)
    out_angle = torch.where(mask, wrapped, torch.zeros_like(wrapped))
    out_axis = torch.where(mask[..., None], axis, _unit_axis(exp_map, 2))
    return out_angle, out_axis


def exp_map_to_quat(exp_map):
    angle, axis = exp_map_to_angle_axis(exp_map)
    return quat_from_angle_axis(angle, axis)


def quat_to_tan_norm(q):
    tan = quat_rotate(q, _unit_axis(q, 0))
    norm = quat_rotate(q, _unit_axis(q, 2))
    return torch.cat([tan, norm], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw):
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quat_to_rotation_matrix(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_rotation_matrix(m):
    """(...,3,3) -> (...,4) xyzw: of the four Shepperd candidates, the one
    with the largest pivot."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp(1.0 + tr, min=_EPS)) / 2.0
    qx = torch.sqrt(torch.clamp(1.0 + m00 - m11 - m22, min=_EPS)) / 2.0
    qy = torch.sqrt(torch.clamp(1.0 - m00 + m11 - m22, min=_EPS)) / 2.0
    qz = torch.sqrt(torch.clamp(1.0 - m00 - m11 + m22, min=_EPS)) / 2.0
    c0 = torch.stack([(m21 - m12) / (4.0 * qw), (m02 - m20) / (4.0 * qw),
                      (m10 - m01) / (4.0 * qw), qw], dim=-1)
    c1 = torch.stack([qx, (m01 + m10) / (4.0 * qx),
                      (m02 + m20) / (4.0 * qx), (m21 - m12) / (4.0 * qx)], dim=-1)
    c2 = torch.stack([(m01 + m10) / (4.0 * qy), qy,
                      (m12 + m21) / (4.0 * qy), (m02 - m20) / (4.0 * qy)], dim=-1)
    c3 = torch.stack([(m02 + m20) / (4.0 * qz), (m12 + m21) / (4.0 * qz),
                      qz, (m10 - m01) / (4.0 * qz)], dim=-1)
    idx = torch.argmax(torch.stack([qw, qx, qy, qz], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)                   # (..., 4, 4)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))
    return quat_unit(q[..., 0, :])


def slerp(q0, q1, t):
    """Spherical interpolation; t broadcasts with trailing dim 1."""
    # the dot product as elementwise ops in a fixed order (that of a CPU
    # reduction and of the reference's eager sum): the branches below must
    # take the same side on every device, and near sin_half = 1e-3 one ulp
    # of cos_half moves sin_half by 6% of that threshold; a reduction on the
    # card sums in another order
    p = q0 * q1
    cos_half = ((p[..., 0] + p[..., 1]) + p[..., 2]) + p[..., 3]
    q1 = torch.where(cos_half[..., None] < 0.0, -q1, q1)
    cos_half = torch.abs(cos_half)[..., None]
    cos_half_c = torch.clamp(cos_half, 0.0, 1.0)

    half_theta = torch.acos(cos_half_c)
    sin_half = torch.sqrt(torch.clamp(1.0 - cos_half_c * cos_half_c, min=0.0))
    small = torch.abs(sin_half) < 1e-3
    safe_sin = torch.where(small, torch.ones_like(sin_half), sin_half)

    ratio_a = torch.sin((1.0 - t) * half_theta) / safe_sin
    ratio_b = torch.sin(t * half_theta) / safe_sin
    out = ratio_a * q0 + ratio_b * q1

    out = torch.where(small, 0.5 * q0 + 0.5 * q1, out)
    out = torch.where(cos_half >= 1.0, q0, out)
    return out


def calc_heading(q):
    rot_dir = quat_rotate(q, _unit_axis(q, 0))
    return torch.atan2(rot_dir[..., 1], rot_dir[..., 0])


def calc_heading_quat(q):
    """Rotation about z by the heading of q."""
    return quat_from_angle_axis(calc_heading(q), _unit_axis(q, 2))


def calc_heading_quat_inv(q):
    """Rotation about z that undoes the heading of q."""
    return quat_from_angle_axis(-calc_heading(q), _unit_axis(q, 2))


def quat_integrate(q, omega, dt):
    """q' = exp(dt*omega/2) (x) q, omega in the world frame."""
    dq = exp_map_to_quat(omega * dt)
    return quat_unit(quat_mul(dq, q))


def quat_integrate_local(q, omega_local, dt):
    """Integrate by angular velocity expressed in the child (local) frame."""
    dq = exp_map_to_quat(omega_local * dt)
    return quat_unit(quat_mul(q, dq))


def quat_diff_rad(a, b):
    """Angle of the relative rotation between two quaternions."""
    d = quat_mul(a, quat_conjugate(b))
    return 2.0 * torch.acos(torch.clamp(torch.abs(d[..., 3]), 0.0, 1.0))
