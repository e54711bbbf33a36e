"""Batch-last dynamics assembly and component-form FK (port of
``ase_tpu/physics/dynamics2.py``: ``fk_batched`` and
``compute_dynamics_batch_last``).

Every vector / matrix entry is its own ``(n, B)`` tensor (bodies or dofs
first, envs last), spatial inertias use their (m, h, I) form, and the mass
matrix comes out in the (nu, nu, B) layout the Cholesky kernel takes. The
arithmetic and its order are the reference's, so the two agree to float32
rounding. The domain-randomization knobs are the reference's too: mass per
env or per body, gravity and damping per env (damping also per dof), and
the actor's geometric scale (link offsets x s, mass x s^3, rotational
inertia x s^5).
"""

from __future__ import annotations

import numpy as np
import torch

from h100_bench.reference.ase_ref.ops import quat as rot_ops
from h100_bench.reference.ase_ref.physics import dynamics
from h100_bench.reference.ase_ref.physics import model as M


class DynStatic:
    """Static tables of the assembly for one model, on its device."""

    def __init__(self, model: M.Model):
        nb, nu = model.nb, model.nu
        dev = model.device
        db = dynamics.dof_body(model)
        A, Wm, both, S = dynamics.crba_masks(model)

        db_rot = db.copy()
        joint_axis = model.np("joint_axis")
        axloc = np.zeros((nu, 3), np.float32)
        e_lin = np.zeros((nu, 3), np.float32)
        is_ang = np.zeros((nu, 1), np.float32)
        is_joint = np.zeros((nu, 1), np.float32)
        for b in range(nb):
            jt = model.jtype[b]
            off = model.dof_offset[b]
            if jt == M.FREE:
                for k in range(3):
                    e_lin[off + k, k] = 1.0
                    axloc[off + 3 + k, k] = 1.0
                    is_ang[off + 3 + k] = 1.0
                    db_rot[off + k] = nb
                    db_rot[off + 3 + k] = nb
            elif jt == M.SPHERICAL:
                for k in range(3):
                    axloc[off + k, k] = 1.0
                    is_ang[off + k] = 1.0
                    is_joint[off + k] = 1.0
            elif jt == M.REVOLUTE:
                axloc[off] = joint_axis[b]
                is_ang[off] = 1.0
                is_joint[off] = 1.0

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

        mass = model.np("mass")[:nb].astype(np.float32)
        inertia = model.np("inertia")[:nb]
        self.db_dyn = t(db, torch.long)
        self.db_rot = t(db_rot, torch.long)
        self.ax = tuple(t(axloc[:, k])[:, None] for k in range(3))
        self.e_lin = tuple(t(e_lin[:, k])[:, None] for k in range(3))
        self.is_ang = t(is_ang)
        self.is_joint = t(is_joint)
        self.Wm = t(Wm)[:, :, None]
        self.both = t(both)[:, :, None]
        self.S = t(S)
        self.A = t(A)
        self.At = t(A.T)
        self.mass = t(mass)[:, None]
        self.msub_d = t((S @ mass)[db])[:, None]
        self.Ii = tuple(t(inertia[:, i, j])[:, None] for i in range(3) for j in range(3))
        self.gravity = tuple(float(g) for g in model.np("gravity"))
        self.ident = tuple(torch.full((1, 1), v, device=dev)
                           for v in (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0))

        # FK constants (python floats, as the reference's static numpy values)
        self.iq = model.np("body_iquat").astype(np.float64).tolist()
        self.ip = model.np("body_ipos").astype(np.float64).tolist()
        self.axis = model.np("joint_axis").astype(np.float64).tolist()
        self.com = model.np("com")[:nb].astype(np.float64).tolist()
        self.sph = dynamics.sph_ids(model)
        self.hinge = dynamics.hinge_ids(model)

    def diag(self, model: M.Model, dt: float) -> torch.Tensor:
        """(nu, nu, 1) armature + SPD implicit damping diagonal."""
        rd = model.root_dofs
        diag = np.zeros(model.nu, np.float32)
        diag[rd:] = model.np("armature")
        if rd == 6:
            diag[3:6] += dt * float(model.np("ang_damping"))
        damp = np.zeros(model.nu, np.float32)
        damp[rd:] = dt * model.np("damping")
        eye = np.eye(model.nu, dtype=np.float32) * (diag + damp)[None, :]
        return torch.as_tensor(eye, device=model.device)[:, :, None]

    def diag_parts(self, model: M.Model, dt: float):
        """The diagonal split for damping randomization: ((nu, nu, 1)
        armature + root angular damping, (nu, 1) dt x joint damping)."""
        rd = model.root_dofs
        diag = np.zeros(model.nu, np.float32)
        diag[rd:] = model.np("armature")
        if rd == 6:
            diag[3:6] += dt * float(model.np("ang_damping"))
        damp = np.zeros(model.nu, np.float32)
        damp[rd:] = dt * model.np("damping")
        eye = np.eye(model.nu, dtype=np.float32) * diag[None, :]
        return (torch.as_tensor(eye, device=model.device)[:, :, None],
                torch.as_tensor(damp, device=model.device)[:, None])


def _mm_multi(mat, comps):
    """One (m, n) matrix applied to k (n, B) planes in a single matmul."""
    k = len(comps)
    out = mat @ torch.cat(comps, dim=1)
    return tuple(torch.chunk(out, k, dim=1))


def _quat_R(q4):
    x, y, z, w = q4
    x2, y2, z2 = x + x, y + y, z + z
    xx, yy, zz = x * x2, y * y2, z * z2
    xy, xz, yz = x * y2, x * z2, y * z2
    wx, wy, wz = w * x2, w * y2, w * z2
    return (
        1.0 - (yy + zz), xy - wz, xz + wy,
        xy + wz, 1.0 - (xx + zz), yz - wx,
        xz - wy, yz + wx, 1.0 - (xx + yy),
    )


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _symprod_RIR(Rc, Ii):
    """6 upper components of R I R^T (I static, broadcast over lanes)."""
    T = []
    for i in range(3):
        for j in range(3):
            T.append(Rc[3 * i] * Ii[j] + Rc[3 * i + 1] * Ii[3 + j] + Rc[3 * i + 2] * Ii[6 + j])

    def ent(i, j):
        return T[3 * i] * Rc[3 * j] + T[3 * i + 1] * Rc[3 * j + 1] + T[3 * i + 2] * Rc[3 * j + 2]

    return ent(0, 0), ent(0, 1), ent(0, 2), ent(1, 1), ent(1, 2), ent(2, 2)


def _sym_mv(Ssym, v):
    xx, xy, xz, yy, yz, zz = Ssym
    return (
        xx * v[0] + xy * v[1] + xz * v[2],
        xy * v[0] + yy * v[1] + yz * v[2],
        xz * v[0] + yz * v[1] + zz * v[2],
    )


def compute_dynamics_batch_last(model: M.Model, st: DynStatic, states, kin,
                                diag: torch.Tensor, mass_scale=None, gravity_scale=None,
                                damping_scale=None, actor_scale=None, diag_parts=None):
    """(M_bl (nu, nu, B), bias (B, nu), Phi (B, nu, 6)); ``diag`` is
    ``st.diag(model, dt)``.

    Domain-randomization knobs (``dynamics2.py:163``): ``mass_scale`` per
    env (B,), which scales M before the armature and the bias, or per body
    (B, nb), folded into the body masses and inertias before assembly;
    ``gravity_scale`` (B,); ``damping_scale`` (B,) or per dof (B, nd),
    which scales the dt x damping part of the implicit diagonal and needs
    ``diag_parts = st.diag_parts(model, dt)``; ``actor_scale`` (B,), with
    ``kin`` from the same scaled FK: mass x s^3 and rotational inertia
    x s^5, folded into the per-body path."""
    B = states.root_pos.shape[0]
    nb = model.nb
    per_body_mass = mass_scale is not None and mass_scale.dim() == 2
    ms_bl = mass_scale.T if per_body_mass else None          # (nb, B)
    isym_extra = None
    if actor_scale is not None:
        s_bl = actor_scale[None, :]
        s3 = s_bl * s_bl * s_bl
        if ms_bl is None:
            ms_bl = s3 if mass_scale is None else mass_scale[None, :] * s3
            ms_bl = ms_bl.expand(nb, B)
        else:
            ms_bl = ms_bl * s3
        per_body_mass = True
        isym_extra = s_bl * s_bl

    q = kin.body_quat                                   # (B, nb, 4)
    Rc = _quat_R(tuple(q[..., k].T for k in range(4)))  # 9 x (nb, B)
    p = tuple(kin.body_pos[..., k].T for k in range(3))
    w = tuple(kin.body_vel[..., k].T for k in range(3))
    vl = tuple(kin.body_vel[..., 3 + k].T for k in range(3))
    cw = tuple(kin.com_world[..., k].T for k in range(3))
    origin = tuple(states.root_pos[:, k][None, :] for k in range(3))

    # motion subspace Phi = [ang, lin], (nu, B) components
    Rext = tuple(torch.cat([Rc[k], st.ident[k].expand(1, B)], dim=0) for k in range(9))
    dbr, dbd = st.db_rot, st.db_dyn
    ax = st.ax
    a = (
        Rext[0][dbr] * ax[0] + Rext[1][dbr] * ax[1] + Rext[2][dbr] * ax[2],
        Rext[3][dbr] * ax[0] + Rext[4][dbr] * ax[1] + Rext[5][dbr] * ax[2],
        Rext[6][dbr] * ax[0] + Rext[7][dbr] * ax[1] + Rext[8][dbr] * ax[2],
    )
    pd = tuple(c[dbd] for c in p)
    lever = tuple(o - c for o, c in zip(origin, pd))
    phi_a = tuple(c * st.is_ang for c in a)
    axl = _cross(a, lever)
    phi_l = tuple(c * st.is_ang + e for c, e in zip(axl, st.e_lin))

    wd = tuple(c[dbd] for c in w)
    vo = tuple(v[dbd] + cr for v, cr in zip(vl, _cross(wd, lever)))
    dphi_a = tuple(c * st.is_joint for c in _cross(wd, phi_a))
    dphi_l = tuple((c1 + c2) * st.is_ang
                   for c1, c2 in zip(_cross(wd, phi_l), _cross(vo, phi_a)))

    # spatial inertias, (m, h, I) form, (nb, B)
    Isym = _symprod_RIR(Rc, st.Ii)
    c_off = tuple(cc - o for cc, o in zip(cw, origin))
    mass = st.mass
    if per_body_mass:
        mass = mass * ms_bl
        i_f = ms_bl if isym_extra is None else ms_bl * isym_extra
        Isym = tuple(c * i_f for c in Isym)
    h = tuple(mass * c for c in c_off)
    c2 = _dot(c_off, c_off)
    TL = (
        Isym[0] + mass * (c2 - c_off[0] * c_off[0]),
        Isym[1] - mass * c_off[0] * c_off[1],
        Isym[2] - mass * c_off[0] * c_off[2],
        Isym[3] + mass * (c2 - c_off[1] * c_off[1]),
        Isym[4] - mass * c_off[1] * c_off[2],
        Isym[5] + mass * (c2 - c_off[2] * c_off[2]),
    )

    # composite (subtree) inertias
    Sc = _mm_multi(st.S, TL + h)
    TLc, hc = Sc[:6], Sc[6:]

    TLd = tuple(t[dbd] for t in TLc)
    hd = tuple(t[dbd] for t in hc)
    md = (st.S @ mass)[dbd] if per_body_mass else st.msub_d
    F_a = tuple(s + c for s, c in zip(_sym_mv(TLd, phi_a), _cross(hd, phi_l)))
    F_l = tuple(c + md * pl for c, pl in zip(_cross(phi_a, hd), phi_l))

    G = sum(Fk[:, None, :] * Pk[None, :, :]
            for Fk, Pk in zip(F_a + F_l, phi_a + phi_l))
    WG = st.Wm * G
    M_bl = WG + WG.permute(1, 0, 2) - st.both * G

    # bias forces
    u = states.u[:, :model.nu].T                        # (nu, B)
    Ac = _mm_multi(st.A, tuple(c * u for c in dphi_a) + tuple(c * u for c in dphi_l)
                   + tuple(c * u for c in phi_a + phi_l))
    ab_a, ab_l = Ac[0:3], Ac[3:6]
    vs_a, vs_l = Ac[6:9], Ac[9:12]

    Iv_a = tuple(s + c for s, c in zip(_sym_mv(TL, vs_a), _cross(h, vs_l)))
    Iv_l = tuple(c + mass * vlk for c, vlk in zip(_cross(vs_a, h), vs_l))
    fv_a = tuple(c1 + c2 for c1, c2 in zip(_cross(vs_a, Iv_a), _cross(vs_l, Iv_l)))
    fv_l = _cross(vs_a, Iv_l)
    fb_a = tuple(s + c + f for s, c, f in zip(_sym_mv(TL, ab_a), _cross(h, ab_l), fv_a))
    fb_l = tuple(c + mass * ak + f for c, ak, f in zip(_cross(ab_a, h), ab_l, fv_l))
    if gravity_scale is not None:
        Fg = tuple(mass * gk * gravity_scale[None, :] for gk in st.gravity)
    else:
        Fg = tuple(mass * gk for gk in st.gravity)
    tau_g = _cross(c_off, Fg)
    ft_a = tuple(f - t for f, t in zip(fb_a, tau_g))
    ft_l = tuple(f - t for f, t in zip(fb_l, Fg))

    Fd = _mm_multi(st.At, ft_a + ft_l)
    bias = sum(p_ * f_ for p_, f_ in zip(phi_a + phi_l, Fd[:3] + Fd[3:]))

    if mass_scale is not None and not per_body_mass:
        M_bl = M_bl * mass_scale[None, None, :]
        bias = bias * mass_scale[None, :]

    if damping_scale is None:
        M_bl = M_bl + diag
    else:
        # only the dt x damping part of the diagonal scales
        arm, damp = diag_parts
        rd = model.root_dofs
        if damping_scale.dim() == 2:
            ds = torch.ones(model.nu, B, device=damping_scale.device)
            ds[rd:] = damping_scale.T
        else:
            ds = damping_scale[None, :]
        M_bl = M_bl + arm
        M_bl.diagonal(dim1=0, dim2=1).add_((damp * ds).T)
    Phi = torch.stack([c.T for c in phi_a + phi_l], dim=-1)   # (B, nu, 6)
    return M_bl, bias.T, Phi


# -- component-form batched FK --------------------------------------------------

def _qmul_c(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return (aw * bx + ax * bw + ay * bz - az * by,
            aw * by + ay * bw + az * bx - ax * bz,
            aw * bz + az * bw + ax * by - ay * bx,
            aw * bw - ax * bx - ay * by - az * bz)


def _qrot_c(q, v):
    """v + 2 w (q x v) + 2 q x (q x v), component form."""
    x, y, z, w = q
    vx, vy, vz = v
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    return (vx + w * tx + (y * tz - z * ty),
            vy + w * ty + (z * tx - x * tz),
            vz + w * tz + (x * ty - y * tx))


def fk_batched(model: M.Model, st: DynStatic, states, actor_scale=None) -> dynamics.Kin:
    """Batched position + velocity FK (``dynamics2.fk_batched``,
    ``dynamics2.py:409``). ``actor_scale`` (B,) multiplies every body
    offset and COM offset (domain randomization's geometric scale)."""
    nb = model.nb
    if actor_scale is None:
        def S(c3):
            return c3
    else:
        def S(c3):
            return tuple(actor_scale * x for x in c3)
    rq = tuple(states.root_quat[:, k] for k in range(4))
    rp = tuple(states.root_pos[:, k] for k in range(3))
    u = states.u
    B = u.shape[0]
    zero = torch.zeros(B, device=u.device)

    quats, ps = [], []
    for b in range(nb):
        jt = model.jtype[b]
        if jt == M.FREE:
            jq = rq
        elif jt == M.SPHERICAL:
            s = st.sph.index(b)
            jq = tuple(states.joint_q[:, s, k] for k in range(4))
        elif jt == M.REVOLUTE:
            half = 0.5 * states.hinge_q[:, st.hinge.index(b)]
            sn, cs = torch.sin(half), torch.cos(half)
            axb = st.axis[b]
            jq = (axb[0] * sn, axb[1] * sn, axb[2] * sn, cs)
        else:
            jq = (zero, zero, zero, torch.ones(B, device=u.device))
        lq = _qmul_c(tuple(st.iq[b]), jq)

        p = model.parents[b]
        if p == -1:
            quats.append(lq)
            if jt == M.FREE:
                ps.append(rp)
            else:
                ps.append(tuple(rp[k] + off for k, off in enumerate(S(tuple(st.ip[b])))))
        else:
            quats.append(_qmul_c(quats[p], lq))
            step = S(_qrot_c(quats[p], tuple(st.ip[b])))
            ps.append(tuple(ps[p][k] + step[k] for k in range(3)))

    vels = [None] * nb
    for b in range(nb):
        p = model.parents[b]
        if p == -1:
            if model.jtype[b] == M.FREE:
                w = (u[:, 3], u[:, 4], u[:, 5])
                v = (u[:, 0], u[:, 1], u[:, 2])
            else:
                w = v = (zero, zero, zero)
        else:
            wp, vp = vels[p]
            d = tuple(ps[b][k] - ps[p][k] for k in range(3))
            v = (vp[0] + wp[1] * d[2] - wp[2] * d[1],
                 vp[1] + wp[2] * d[0] - wp[0] * d[2],
                 vp[2] + wp[0] * d[1] - wp[1] * d[0])
            off = model.dof_offset[b]
            if model.jtype[b] == M.SPHERICAL:
                dw = _qrot_c(quats[b], (u[:, off], u[:, off + 1], u[:, off + 2]))
                w = tuple(wp[k] + dw[k] for k in range(3))
            elif model.jtype[b] == M.REVOLUTE:
                aw = _qrot_c(quats[b], tuple(st.axis[b]))
                w = tuple(wp[k] + aw[k] * u[:, off] for k in range(3))
            else:
                w = wp
        vels[b] = (w, v)

    body_quat = torch.stack([torch.stack(q, dim=-1) for q in quats], dim=1)
    body_pos = torch.stack([torch.stack(pp, dim=-1) for pp in ps], dim=1)
    body_vel = torch.stack([torch.stack(w + v, dim=-1) for (w, v) in vels], dim=1)
    R = rot_ops.quat_to_rotation_matrix(body_quat)
    com_c = [S(_qrot_c(quats[b], tuple(st.com[b]))) for b in range(nb)]
    com_w = body_pos + torch.stack([torch.stack(c, dim=-1) for c in com_c], dim=1)
    return dynamics.Kin(R, body_pos, body_quat, body_vel, com_w)
