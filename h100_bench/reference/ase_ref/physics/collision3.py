"""Batched narrow phase with sort-free contact selection (port of
``ase_tpu/physics/collision3.py``).

Same candidate set and the same arithmetic as the reference: each vector is
kept as per-component ``(B, n)`` tensors, candidates are enumerated from
static tables (plane features, sphere/capsule/box pair groups), and the
active contacts are compacted into a fixed budget K with a cumsum rank --
penetrating contacts claim slots first, speculative (gap) contacts within
``margin`` fill the rest, unfilled slots are all zero. The reference builds
the compaction as a one-hot matmul (fast on a TPU's matrix unit); here it is
a scatter of candidate indices plus a gather, which selects exactly the same
rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from h100_bench.reference.ase_ref.ops import quat as rot
from h100_bench.reference.ase_ref.physics import model as M
from h100_bench.reference.ase_ref.physics.collision import Contacts, collision_pairs

_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    dtype=np.float32,
)


# -- component-tuple helpers: v = (x, y, z), each (B, n) ----------------------

def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _safe_unit(a):
    """Unit vector with a +z fallback for degenerate directions."""
    d = _norm(a)
    safe = d > 1e-6
    inv = torch.where(safe, 1.0 / torch.where(safe, d, torch.ones_like(d)),
                      torch.zeros_like(d))
    return (a[0] * inv, a[1] * inv, a[2] * inv + (~safe).to(d.dtype)), d


def _mat_vec(Rc, v):
    return (
        Rc[0] * v[0] + Rc[1] * v[1] + Rc[2] * v[2],
        Rc[3] * v[0] + Rc[4] * v[1] + Rc[5] * v[2],
        Rc[6] * v[0] + Rc[7] * v[1] + Rc[8] * v[2],
    )


def _mat_t_vec(Rc, v):
    return (
        Rc[0] * v[0] + Rc[3] * v[1] + Rc[6] * v[2],
        Rc[1] * v[0] + Rc[4] * v[1] + Rc[7] * v[2],
        Rc[2] * v[0] + Rc[5] * v[1] + Rc[8] * v[2],
    )


def _mat_mat(A, Bc):
    out = []
    for i in range(3):
        for j in range(3):
            out.append(A[3 * i] * Bc[j] + A[3 * i + 1] * Bc[3 + j] + A[3 * i + 2] * Bc[6 + j])
    return tuple(out)


def _col(Rc, k):
    return (Rc[k], Rc[3 + k], Rc[6 + k])


def _gather(comps, idx):
    return tuple(c[:, idx] for c in comps)


def _quat_mat_comps(q4):
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


# -- static tables --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SoATables:
    """Static candidate tables (host numpy), field for field the
    reference's ``collision3.SoATables``."""

    pl_geom: np.ndarray
    pl_body: np.ndarray
    pl_off: np.ndarray
    pl_radius: np.ndarray
    pl_cyl: np.ndarray
    pl_mu: np.ndarray
    ss_i: np.ndarray
    ss_j: np.ndarray
    sc_s: np.ndarray
    sc_c: np.ndarray
    sc_flip: np.ndarray
    cc_i: np.ndarray
    cc_j: np.ndarray
    bo_box: np.ndarray
    bo_oth: np.ndarray
    bo_t: np.ndarray
    bo_sign: np.ndarray
    bo_a: np.ndarray
    bo_b: np.ndarray
    bb_src: np.ndarray
    bb_dst: np.ndarray
    bb_corner: np.ndarray
    bb_sign: np.ndarray
    bb_i: np.ndarray
    bb_j: np.ndarray
    g_rot_local: np.ndarray


def build_soa_tables(model: M.Model, enable_self: bool) -> SoATables:
    gt = model.geom_types
    size = model.np("geom_size")
    fric = model.np("geom_friction")
    plane_mu = float(model.np("plane_friction"))

    pl_geom, pl_body, pl_off, pl_radius, pl_cyl = [], [], [], [], []
    for g in range(model.ng):
        b = model.geom_body[g]

        def add(off, r, is_cyl=0.0):
            pl_geom.append(g)
            pl_body.append(b)
            pl_off.append(off)
            pl_radius.append(r)
            pl_cyl.append(is_cyl)

        if gt[g] == M.GEOM_SPHERE:
            add(np.zeros(3), size[g][0])
        elif gt[g] == M.GEOM_CAPSULE:
            add(np.array([0, 0, size[g][1]]), size[g][0])
            add(np.array([0, 0, -size[g][1]]), size[g][0])
        elif gt[g] == M.GEOM_BOX:
            for c in _BOX_CORNERS:
                add(c * size[g], 0.0)
        elif gt[g] == M.GEOM_CYLINDER:
            add(np.array([0, 0, size[g][1]]), size[g][0], 1.0)
            add(np.array([0, 0, -size[g][1]]), size[g][0], 1.0)

    pairs = collision_pairs(model, enable_self)
    caplike = (M.GEOM_CAPSULE, M.GEOM_CYLINDER)
    ss, sc, cc, bo, bb = [], [], [], [], []
    for (i, j) in pairs:
        ti, tj = gt[i], gt[j]
        if ti == M.GEOM_SPHERE and tj == M.GEOM_SPHERE:
            ss.append((i, j))
        elif ti == M.GEOM_SPHERE and tj in caplike:
            sc.append((i, j, 0.0))
        elif tj == M.GEOM_SPHERE and ti in caplike:
            sc.append((j, i, 1.0))
        elif ti in caplike and tj in caplike:
            cc.append((i, j))
        elif ti == M.GEOM_BOX and tj == M.GEOM_BOX:
            for (src, dst, src_is_i) in ((i, j, 1.0), (j, i, -1.0)):
                for c in _BOX_CORNERS:
                    bb.append((src, dst, c, src_is_i, i, j))
        elif ti == M.GEOM_BOX:
            for t in (-1.0, 0.0, 1.0):
                bo.append((i, j, t, -1.0, i, j))
        elif tj == M.GEOM_BOX:
            for t in (-1.0, 0.0, 1.0):
                bo.append((j, i, t, 1.0, i, j))
        else:
            raise ValueError(f"unhandled pair types {ti},{tj}")

    def col(lst, k, dtype=np.int32):
        return np.asarray([e[k] for e in lst], dtype) if lst else np.zeros(0, dtype)

    pl_geom_a = np.asarray(pl_geom, np.int32)
    return SoATables(
        pl_geom=pl_geom_a,
        pl_body=np.asarray(pl_body, np.int32),
        pl_off=np.asarray(pl_off, np.float32).reshape(-1, 3),
        pl_radius=np.asarray(pl_radius, np.float32),
        pl_cyl=np.asarray(pl_cyl, np.float32),
        pl_mu=np.sqrt(np.maximum(fric[pl_geom_a] * plane_mu, 0.0)).astype(np.float32)
        if pl_geom else np.zeros(0, np.float32),
        ss_i=col(ss, 0), ss_j=col(ss, 1),
        sc_s=col(sc, 0), sc_c=col(sc, 1), sc_flip=col(sc, 2, np.float32),
        cc_i=col(cc, 0), cc_j=col(cc, 1),
        bo_box=col(bo, 0), bo_oth=col(bo, 1), bo_t=col(bo, 2, np.float32),
        bo_sign=col(bo, 3, np.float32), bo_a=col(bo, 4), bo_b=col(bo, 5),
        bb_src=col(bb, 0), bb_dst=col(bb, 1),
        bb_corner=np.asarray([e[2] for e in bb], np.float32).reshape(-1, 3),
        bb_sign=col(bb, 3, np.float32), bb_i=col(bb, 4), bb_j=col(bb, 5),
        g_rot_local=rot.quat_to_rotation_matrix(
            torch.as_tensor(model.np("geom_quat"))).numpy().astype(np.float32),
    )


class DetectConsts:
    """Device-resident constants of ``detect_batched`` for one model: the
    static tables' index and per-candidate rows, uploaded once so a tick
    issues no host-to-device copies."""

    def __init__(self, model: M.Model, tables: SoATables, device):
        T = tables
        self.device = torch.device(device)
        gb = np.asarray(model.geom_body, np.int64)
        size = model.np("geom_size")
        mu_g = model.np("geom_friction")

        def t(x, dtype=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

        def row(x):
            return t(x)[None, :]

        def mu_of(i, j):
            return row(np.sqrt(np.maximum(mu_g[i] * mu_g[j], 0.0)))

        self.gb = t(gb, torch.long)
        self.humanoid_geom = t(gb < model.nb, torch.bool)   # actor-scaled geoms
        gq = T.g_rot_local
        self.gloc = tuple(row(gq[:, i, j]) for i in range(3) for j in range(3))
        goff = model.np("geom_pos")
        self.goff = tuple(row(goff[:, k]) for k in range(3))
        g: Dict[str, object] = {}
        ba, bb = [], []
        if T.pl_geom.size:
            g["pl"] = dict(
                gi=t(T.pl_geom, torch.long),
                off=tuple(row(T.pl_off[:, k]) for k in range(3)),
                cyl=row(T.pl_cyl), rad=row(T.pl_radius), mu=row(T.pl_mu))
            ba.append(T.pl_body)
            bb.append(np.full(T.pl_body.shape, -1, np.int32))
        if T.ss_i.size:
            i, j = T.ss_i, T.ss_j
            g["ss"] = dict(i=t(i, torch.long), j=t(j, torch.long),
                           ri=row(size[i, 0]), rj=row(size[j, 0]), mu=mu_of(i, j))
            ba.append(gb[i])
            bb.append(gb[j])
        if T.sc_s.size:
            s, c = T.sc_s, T.sc_c
            g["sc"] = dict(s=t(s, torch.long), c=t(c, torch.long),
                           rs=row(size[s, 0]), rc=row(size[c, 0]),
                           half=row(size[c, 1]), flip=row(T.sc_flip), mu=mu_of(s, c))
            ba.append(np.where(T.sc_flip > 0, gb[c], gb[s]))
            bb.append(np.where(T.sc_flip > 0, gb[s], gb[c]))
        if T.cc_i.size:
            i, j = T.cc_i, T.cc_j
            g["cc"] = dict(i=t(i, torch.long), j=t(j, torch.long),
                           ri=row(size[i, 0]), rj=row(size[j, 0]),
                           hi=row(size[i, 1]), hj=row(size[j, 1]), mu=mu_of(i, j))
            ba.append(gb[i])
            bb.append(gb[j])
        if T.bo_box.size:
            bx, ot = T.bo_box, T.bo_oth
            is_cap = np.asarray(
                [model.geom_types[int(o)] != M.GEOM_SPHERE for o in ot], np.float32)
            g["bo"] = dict(
                bx=t(bx, torch.long), ot=t(ot, torch.long),
                half=tuple(row(size[bx, k]) for k in range(3)),
                amp=row(size[ot, 1] * is_cap * T.bo_t), r=row(size[ot, 0]),
                sign=row(T.bo_sign), mu=mu_of(T.bo_a, T.bo_b))
            ba.append(gb[T.bo_a])
            bb.append(gb[T.bo_b])
        if T.bb_src.size:
            src, dst = T.bb_src, T.bb_dst
            g["bb"] = dict(
                src=t(src, torch.long), dst=t(dst, torch.long),
                corner=tuple(row(T.bb_corner[:, k] * size[src, k]) for k in range(3)),
                half=tuple(row(size[dst, k]) for k in range(3)),
                sign=row(T.bb_sign), mu=mu_of(T.bb_i, T.bb_j))
            ba.append(gb[T.bb_i])
            bb.append(gb[T.bb_j])
        self.groups = g
        self.body_a = t(np.concatenate(ba), torch.long)     # (C,)
        self.body_b = t(np.concatenate(bb), torch.long)
        # per-shape friction columns of each candidate's bodies; the plane
        # (body -1) reads the extra column nb + np, which holds 1
        nbp = model.nb + model.num_props
        self.fric_a = t(np.where(np.concatenate(ba) < 0, nbp, np.concatenate(ba)), torch.long)
        self.fric_b = t(np.where(np.concatenate(bb) < 0, nbp, np.concatenate(bb)), torch.long)
        self.num_candidates = int(self.body_a.shape[0])


def _point_box(c, half):
    """Point in box (box frame): (depth, n_local, surf_local); depth > 0
    inside (to the nearest face), -distance outside."""
    d0 = half[0] - torch.abs(c[0])
    d1 = half[1] - torch.abs(c[1])
    d2 = half[2] - torch.abs(c[2])
    inside = (d0 > 0) & (d1 > 0) & (d2 > 0)

    cl = (
        torch.clamp(c[0], -half[0], half[0]),
        torch.clamp(c[1], -half[1], half[1]),
        torch.clamp(c[2], -half[2], half[2]),
    )
    out = _sub(c, cl)
    out_dist = _norm(out) + 1e-9
    n_out = _scale(out, 1.0 / out_dist)

    def sgn(x):
        return torch.where(x < 0, -torch.ones_like(x), torch.ones_like(x))

    zero = torch.zeros_like(d0)
    use0 = (d0 <= d1) & (d0 <= d2)
    use1 = (~use0) & (d1 <= d2)
    use2 = ~(use0 | use1)
    n_in = (
        torch.where(use0, sgn(c[0]), zero),
        torch.where(use1, sgn(c[1]), zero),
        torch.where(use2, sgn(c[2]), zero),
    )
    depth_in = torch.where(use0, d0, torch.where(use1, d1, d2))

    depth = torch.where(inside, depth_in, -out_dist)
    n = tuple(torch.where(inside, a, b) for a, b in zip(n_in, n_out))
    surf = tuple(
        torch.where(inside, cc + nn * depth_in, cl_k)
        for cc, nn, cl_k in zip(c, n_in, cl)
    )
    return depth, n, surf


def detect_batched(consts: DetectConsts, body_quat: torch.Tensor,
                   body_pos: torch.Tensor, prop_quat: torch.Tensor,
                   prop_pos: torch.Tensor, max_contacts: int,
                   margin: float = 0.0, friction_scale: torch.Tensor = None,
                   actor_scale: torch.Tensor = None) -> Contacts:
    """Contacts (B, K) for bodies at (body_quat (B, nb, 4), body_pos
    (B, nb, 3)) and free props at (prop_quat (B, np, 4), prop_pos
    (B, np, 3)) -- ``collision3.detect_batched`` (``collision3.py:304``).
    A prop's geoms hang off body nb + k, so the geom gather runs over the
    bodies and props concatenated.

    Domain randomization: ``friction_scale`` (B, nb + np) multiplies each
    candidate's friction by sqrt(s_a s_b) before selection (the plane's
    scale is 1); ``actor_scale`` (B,) scales the humanoid's geom offsets
    and sizes, not the props'."""
    D = consts
    G = D.groups
    B = body_pos.shape[0]
    gb = D.gb
    if actor_scale is None:
        def sg(row, idx):
            return row
    else:
        s_geom = torch.where(D.humanoid_geom[None, :], actor_scale[:, None],
                             torch.ones((), device=actor_scale.device))      # (B, ng)

        def sg(row, idx):
            return row * s_geom[:, idx]
    if prop_pos.shape[1]:
        body_quat = torch.cat([body_quat, prop_quat], dim=1)
        body_pos = torch.cat([body_pos, prop_pos], dim=1)

    qg = body_quat[:, gb]                                  # (B, ng, 4)
    Rb = _quat_mat_comps(qg.unbind(-1))
    pb = tuple(body_pos[:, gb, k] for k in range(3))
    Rg = _mat_mat(Rb, D.gloc)                              # geom world rotation
    goff = D.goff if actor_scale is None else tuple(c * s_geom for c in D.goff)
    gp = _add(pb, _mat_vec(Rb, goff))

    depths, normals, poss, mus = [], [], [], []

    def emit(depth, n, pos, mu):
        depths.append(depth)
        normals.append(n)
        poss.append(pos)
        mus.append(mu.expand(depth.shape))

    if "pl" in G:
        c = G["pl"]
        Rc = _gather(Rg, c["gi"])
        off = tuple(sg(x, c["gi"]) for x in c["off"])
        p = _add(_gather(gp, c["gi"]), _mat_vec(Rc, off))
        axis = _col(Rc, 2)
        tdir = (axis[0] * axis[2], axis[1] * axis[2], axis[2] * axis[2] - 1.0)
        tn = torch.clamp(_norm(tdir), min=1e-6)
        cyl, rad = c["cyl"], sg(c["rad"], c["gi"])
        px = p[0] + cyl * tdir[0] / tn * rad
        py = p[1] + cyl * tdir[1] / tn * rad
        pz = p[2] + cyl * tdir[2] / tn * rad - (1.0 - cyl) * rad
        zero = torch.zeros_like(px)
        emit(-pz, (zero, zero, zero + 1.0), (px, py, pz), c["mu"])

    if "ss" in G:
        c = G["ss"]
        ri, rj = sg(c["ri"], c["i"]), sg(c["rj"], c["j"])
        d = _sub(_gather(gp, c["i"]), _gather(gp, c["j"]))
        n, dist = _safe_unit(d)
        depth = ri + rj - dist
        pos = _add(_gather(gp, c["j"]), _scale(n, rj - 0.5 * depth))
        emit(depth, n, pos, c["mu"])

    if "sc" in G:
        c = G["sc"]
        Rc = _gather(Rg, c["c"])
        axis = _col(Rc, 2)
        half = sg(c["half"], c["c"])
        rs, rc = sg(c["rs"], c["s"]), sg(c["rc"], c["c"])
        cpos = _gather(gp, c["c"])
        spos = _gather(gp, c["s"])
        a0 = _sub(cpos, _scale(axis, half))
        seg = _scale(axis, 2.0 * half)
        t = _dot(_sub(spos, a0), seg) / torch.clamp(_dot(seg, seg), min=1e-9)
        q = _add(a0, _scale(seg, torch.clamp(t, 0.0, 1.0)))
        n, dist = _safe_unit(_sub(spos, q))
        depth = rs + rc - dist
        pos = _add(q, _scale(n, rc - 0.5 * depth))
        n = _scale(n, 1.0 - 2.0 * c["flip"])
        emit(depth, n, pos, c["mu"])

    if "cc" in G:
        c = G["cc"]
        Ri, Rj = _gather(Rg, c["i"]), _gather(Rg, c["j"])
        ri, rj = sg(c["ri"], c["i"]), sg(c["rj"], c["j"])
        ai = _scale(_col(Ri, 2), sg(c["hi"], c["i"]))
        aj = _scale(_col(Rj, 2), sg(c["hj"], c["j"]))
        pi, pj = _gather(gp, c["i"]), _gather(gp, c["j"])
        a0, d1 = _sub(pi, ai), _scale(ai, 2.0)
        b0, d2 = _sub(pj, aj), _scale(aj, 2.0)
        r = _sub(a0, b0)
        a = _dot(d1, d1)
        e = _dot(d2, d2)
        f = _dot(d2, r)
        cdot = _dot(d1, r)
        b = _dot(d1, d2)
        denom = a * e - b * b
        ok = torch.abs(denom) > 1e-9
        s = torch.where(ok, (b * f - cdot * e) / torch.where(ok, denom, torch.ones_like(denom)),
                        torch.zeros_like(denom))
        s = torch.clamp(s, 0.0, 1.0)
        t = (b * s + f) / torch.clamp(e, min=1e-9)
        t_cl = torch.clamp(t, 0.0, 1.0)
        s = torch.where(t != t_cl,
                        torch.clamp((b * t_cl - cdot) / torch.clamp(a, min=1e-9), 0.0, 1.0), s)
        pa = _add(a0, _scale(d1, s))
        pb_ = _add(b0, _scale(d2, t_cl))
        n, dist = _safe_unit(_sub(pa, pb_))
        depth = ri + rj - dist
        pos = _add(pb_, _scale(n, rj - 0.5 * depth))
        emit(depth, n, pos, c["mu"])

    if "bo" in G:
        c = G["bo"]
        Rb_ = _gather(Rg, c["bx"])
        pbox = _gather(gp, c["bx"])
        axis = _col(_gather(Rg, c["ot"]), 2)
        sample = _add(_gather(gp, c["ot"]), _scale(axis, sg(c["amp"], c["ot"])))
        c_local = _mat_t_vec(Rb_, _sub(sample, pbox))
        dpt, n_l, surf_l = _point_box(c_local, tuple(sg(x, c["bx"]) for x in c["half"]))
        n_w = _mat_vec(Rb_, n_l)
        pos = _add(pbox, _mat_vec(Rb_, surf_l))
        emit(dpt + sg(c["r"], c["ot"]), _scale(n_w, c["sign"]), pos, c["mu"])

    if "bb" in G:
        c = G["bb"]
        Rs, Rd = _gather(Rg, c["src"]), _gather(Rg, c["dst"])
        ps_, pd_ = _gather(gp, c["src"]), _gather(gp, c["dst"])
        cw = _add(ps_, _mat_vec(Rs, tuple(sg(x, c["src"]) for x in c["corner"])))
        c_local = _mat_t_vec(Rd, _sub(cw, pd_))
        dpt, n_l, surf_l = _point_box(c_local, tuple(sg(x, c["dst"]) for x in c["half"]))
        n_w = _mat_vec(Rd, n_l)
        pos = _add(pd_, _mat_vec(Rd, surf_l))
        emit(dpt, _scale(n_w, c["sign"]), pos, c["mu"])

    depth = torch.cat(depths, dim=1)                        # (B, C)
    C = depth.shape[1]
    mu = torch.cat(mus, 1)
    if friction_scale is not None:
        # the combined friction is a geometric mean, so per-shape scales
        # combine as sqrt(s_a s_b); the plane's scale is 1
        fs = torch.cat([friction_scale, torch.ones_like(friction_scale[:, :1])], dim=1)
        mu = mu * torch.sqrt(fs[:, D.fric_a] * fs[:, D.fric_b])
    ba = D.body_a.to(depth.dtype).expand(B, C)
    bb_ = D.body_b.to(depth.dtype).expand(B, C)
    # (B, 10, C+1) features; the extra zero column feeds unfilled slots
    feats = torch.stack([
        depth,
        torch.cat([p[0] for p in poss], 1), torch.cat([p[1] for p in poss], 1),
        torch.cat([p[2] for p in poss], 1),
        torch.cat([n[0] for n in normals], 1), torch.cat([n[1] for n in normals], 1),
        torch.cat([n[2] for n in normals], 1),
        mu, ba, bb_,
    ], dim=1)
    feats = torch.cat([feats, feats.new_zeros(B, feats.shape[1], 1)], dim=2)

    # sort-free selection (see the reference's notes): penetrating contacts
    # take slots 0.., gap candidates within `margin` follow them
    k = min(max_contacts, C)
    pen = depth > 0.0
    slot = torch.where(pen, torch.cumsum(pen.to(torch.int32), dim=1) - 1,
                       torch.full_like(depth, k, dtype=torch.int32))
    if margin > 0.0:
        gap = (depth <= 0.0) & (depth > -margin)
        n_pen = pen.sum(dim=1, dtype=torch.int32)[:, None]
        rank_g = torch.cumsum(gap.to(torch.int32), dim=1) - 1 + n_pen
        slot = torch.where(gap, rank_g, slot)
    slot = torch.clamp(slot, max=k).to(torch.long)           # overflow -> bin k
    src = torch.arange(C, device=depth.device).expand(B, C)
    idx = torch.full((B, k + 1), C, dtype=torch.long, device=depth.device)
    idx.scatter_(1, slot, src)    # a slot < k receives exactly one candidate
    idx = idx[:, :k]
    sel = torch.gather(feats, 2, idx[:, None, :].expand(B, feats.shape[1], k))
    return Contacts(
        pos=sel[:, 1:4, :].transpose(1, 2),
        normal=sel[:, 4:7, :].transpose(1, 2),
        depth=sel[:, 0, :],
        body_a=torch.round(sel[:, 8, :]).to(torch.long),
        body_b=torch.round(sel[:, 9, :]).to(torch.long),
        friction=sel[:, 7, :],
    )
