"""Table-driven narrow phase, the engine's parity oracle (port of
``ase_tpu/physics/collision2.py``).

The static candidate tables (host numpy, equal to the reference's) group
the geom pairs by primitive combination; ``detect`` runs each group as
batched tensor ops over the candidates. It is an independent formulation
of the contact set that ``collision3.detect_batched`` builds for the
engine: full rotation matrices instead of quaternion components, and the
box tests through ``collision._point_box_depth``. Every tensor takes a
leading batch dim, so the same code runs one env or thousands; the engine
never calls it.

The reference's ``ASE_TPU_SORT_SELECT`` switch (a top-k selection in
place of the compaction) is left out: it is an A/B escape, and the
compaction is the semantics ``collision3`` keeps.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ase_tpu_torch.ops import quat as rot
from ase_tpu_torch.physics import model as M
from ase_tpu_torch.physics.collision import (
    Contacts,
    _point_box_depth,
    _segment_segment,
    collision_pairs,
)

_BOX_CORNERS = np.array(
    [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
    dtype=np.float32,
)


class PlaneTable(NamedTuple):
    """Static per-candidate tables for geom-vs-ground contacts."""

    geom: np.ndarray       # (C,) geom index
    body: np.ndarray       # (C,) body index
    local_off: np.ndarray  # (C, 3) offset in the geom frame
    radius: np.ndarray     # (C,) subtracted along world -z
    friction_idx: np.ndarray
    cyl: np.ndarray        # (C,) 1 for a cylinder rim candidate (direction at run time)
    cyl_sign: np.ndarray   # (C,) which face


def build_plane_table(model: M.Model) -> PlaneTable:
    geom, body, local_off, radius, cyl, cyl_sign = [], [], [], [], [], []
    sizes = model.np("geom_size")
    for g in range(model.ng):
        gt = model.geom_types[g]
        b = model.geom_body[g]
        size = np.asarray(sizes[g])

        def add(off, r, is_cyl=0, sign=0.0):
            geom.append(g)
            body.append(b)
            local_off.append(off)
            radius.append(r)
            cyl.append(is_cyl)
            cyl_sign.append(sign)

        if gt == M.GEOM_SPHERE:
            add(np.zeros(3), size[0])
        elif gt == M.GEOM_CAPSULE:
            add(np.array([0, 0, size[1]]), size[0])
            add(np.array([0, 0, -size[1]]), size[0])
        elif gt == M.GEOM_BOX:
            for c in _BOX_CORNERS:
                add(c * size, 0.0)
        elif gt == M.GEOM_CYLINDER:
            add(np.array([0, 0, size[1]]), size[0], 1, 1.0)
            add(np.array([0, 0, -size[1]]), size[0], 1, -1.0)
    return PlaneTable(
        geom=np.asarray(geom, np.int32),
        body=np.asarray(body, np.int32),
        local_off=np.asarray(local_off, np.float32),
        radius=np.asarray(radius, np.float32),
        friction_idx=np.asarray(geom, np.int32),
        cyl=np.asarray(cyl, np.float32),
        cyl_sign=np.asarray(cyl_sign, np.float32),
    )


class PairTables(NamedTuple):
    """Pair lists grouped by primitive combination (static)."""

    cc: np.ndarray          # (n, 2) capsule-like vs capsule-like (cylinders as capsules)
    sc: np.ndarray          # (n, 2) (sphere geom, capsule-like geom)
    sc_flip: np.ndarray     # (n,) 1 if the sphere is geom j (the normal flips)
    ss: np.ndarray          # (n, 2)
    box_other: np.ndarray   # (n, 3) (box geom, other geom, box is geom i)
    box_box: List[Tuple[int, int]]


def build_pair_tables(model: M.Model, enable_self: bool) -> PairTables:
    pairs = collision_pairs(model, enable_self)
    cc, sc, sc_flip, ss = [], [], [], []
    box_other, box_box = [], []
    caplike = (M.GEOM_CAPSULE, M.GEOM_CYLINDER)
    for (i, j) in pairs:
        ti, tj = model.geom_types[i], model.geom_types[j]
        if ti == M.GEOM_SPHERE and tj == M.GEOM_SPHERE:
            ss.append((i, j))
        elif ti == M.GEOM_SPHERE and tj in caplike:
            sc.append((i, j))
            sc_flip.append(0)
        elif tj == M.GEOM_SPHERE and ti in caplike:
            sc.append((j, i))
            sc_flip.append(1)
        elif ti in caplike and tj in caplike:
            cc.append((i, j))
        elif ti == M.GEOM_BOX and tj == M.GEOM_BOX:
            box_box.append((i, j))
        elif ti == M.GEOM_BOX:
            box_other.append((i, j, 1))
        elif tj == M.GEOM_BOX:
            box_other.append((j, i, 0))
        else:
            raise ValueError(f"unhandled pair {ti},{tj}")
    return PairTables(
        cc=np.asarray(cc, np.int32).reshape(-1, 2),
        sc=np.asarray(sc, np.int32).reshape(-1, 2),
        sc_flip=np.asarray(sc_flip, np.float32),
        ss=np.asarray(ss, np.int32).reshape(-1, 2),
        box_other=np.asarray(box_other, np.int32).reshape(-1, 3),
        box_box=box_box,
    )


class CollisionTables(NamedTuple):
    plane: PlaneTable
    pairs: PairTables
    soa: object = None      # collision3.SoATables, the engine's narrow phase's


def build_tables(model: M.Model, enable_self: bool) -> CollisionTables:
    from ase_tpu_torch.physics import collision3

    return CollisionTables(
        build_plane_table(model),
        build_pair_tables(model, enable_self),
        collision3.build_soa_tables(model, enable_self),
    )


def geom_world_pose(model: M.Model, body_R, body_pos, prop_R, prop_pos):
    """World positions (..., ng, 3) and rotations (..., ng, 3, 3) of the
    geoms, from the body (..., nb, 3, 3), (..., nb, 3) and prop (..., np,
    3, 3), (..., np, 3) transforms."""
    gb = torch.as_tensor(np.asarray(model.geom_body, np.int64), device=body_pos.device)
    if model.num_props > 0:
        all_R = torch.cat([body_R, prop_R], dim=-3)
        all_p = torch.cat([body_pos, prop_pos], dim=-2)
    else:
        all_R, all_p = body_R, body_pos
    Rb = all_R[..., gb, :, :]
    g_pos = all_p[..., gb, :] + (Rb @ model.geom_pos[..., None])[..., 0]
    g_rot = Rb @ rot.quat_to_rotation_matrix(model.geom_quat)
    return g_pos, g_rot


def _safe_dir(d):
    dist = torch.linalg.norm(d, dim=-1)
    safe = dist > 1e-6
    up = torch.zeros_like(d)
    up[..., 2] = 1.0
    n = torch.where(safe[..., None], d / torch.where(safe, dist, torch.ones_like(dist))[..., None],
                    up)
    return n, dist + 1e-9


def detect(model: M.Model, tables: CollisionTables, body_R, body_pos, prop_R, prop_pos,
           max_contacts: int, margin: float = 0.0) -> Contacts:
    """The contact set (``collision2.py:164``) of the pose given by the body
    rotations (..., nb, 3, 3) and positions (..., nb, 3) and the props'
    (..., np, 3, 3), (..., np, 3): at most ``max_contacts`` candidates,
    the penetrating ones first, then those within ``margin`` of touching,
    each group in candidate order; unfilled slots are zero (inactive in
    the solver)."""
    lead = body_pos.shape[:-2]
    Bn = int(np.prod(lead)) if lead else 1
    body_R = body_R.reshape(Bn, model.nb, 3, 3)
    body_pos = body_pos.reshape(Bn, model.nb, 3)
    prop_R = prop_R.reshape(Bn, model.num_props, 3, 3)
    prop_pos = prop_pos.reshape(Bn, model.num_props, 3)
    dev = body_pos.device

    def ix(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=dev)

    g_pos, g_rot = geom_world_pose(model, body_R, body_pos, prop_R, prop_pos)
    size = model.geom_size
    mu_g = model.geom_friction
    gb_np = np.asarray(model.geom_body, np.int64)
    pts, depths, normals, bas, bbs, mus = [], [], [], [], [], []

    def add(pos, n, d, ba, bb, mu):
        C = d.shape[-1]
        pts.append(pos)
        depths.append(d)
        normals.append(n)
        bas.append(ix(ba).expand(Bn, C))
        bbs.append(ix(bb).expand(Bn, C))
        mus.append(mu.expand(Bn, C))

    def pair_mu(i, j):
        return torch.sqrt(torch.clamp(mu_g[ix(i)] * mu_g[ix(j)], min=0.0))

    # ---- plane candidates ----
    T = tables.plane
    gi = ix(T.geom)
    Rg = g_rot[:, gi]
    p = g_pos[:, gi] + (Rg @ torch.as_tensor(T.local_off, device=dev)[..., None])[..., 0]
    axis = Rg[..., :, 2]
    down = torch.tensor([0.0, 0.0, -1.0], device=dev)
    tdir = down + axis * axis[..., 2:3]
    tdir = tdir / torch.clamp(torch.linalg.norm(tdir, dim=-1, keepdim=True), min=1e-6)
    cyl = torch.as_tensor(T.cyl, device=dev)[:, None]
    radius = torch.as_tensor(T.radius, device=dev)[:, None]
    vertical = torch.cat([torch.zeros(radius.shape[0], 2, device=dev), -radius], dim=-1)
    p = p + cyl * tdir * radius + (1.0 - cyl) * vertical
    up = torch.zeros_like(p)
    up[..., 2] = 1.0
    add(p, up, -p[..., 2], T.body, np.full(len(T.geom), -1),
        torch.sqrt(torch.clamp(mu_g[gi] * model.plane_friction, min=0.0)))

    P = tables.pairs
    # ---- sphere-sphere ----
    if P.ss.shape[0]:
        i, j = P.ss[:, 0], P.ss[:, 1]
        n, dist = _safe_dir(g_pos[:, ix(i)] - g_pos[:, ix(j)])
        depth = size[ix(i), 0] + size[ix(j), 0] - dist
        pos = g_pos[:, ix(j)] + n * (size[ix(j), 0] - 0.5 * depth)[..., None]
        add(pos, n, depth, gb_np[i], gb_np[j], pair_mu(i, j))

    # ---- sphere vs capsule-like ----
    if P.sc.shape[0]:
        si, ci = P.sc[:, 0], P.sc[:, 1]
        axis = g_rot[:, ix(ci)][..., :, 2]
        half = size[ix(ci), 1][:, None]
        a0 = g_pos[:, ix(ci)] - axis * half
        seg = 2.0 * axis * half
        t = (((g_pos[:, ix(si)] - a0) * seg).sum(-1)
             / torch.clamp((seg * seg).sum(-1), min=1e-9))
        q = a0 + torch.clamp(t, 0.0, 1.0)[..., None] * seg
        n, dist = _safe_dir(g_pos[:, ix(si)] - q)
        depth = size[ix(si), 0] + size[ix(ci), 0] - dist
        pos = q + n * (size[ix(ci), 0] - 0.5 * depth)[..., None]
        flip = P.sc_flip > 0
        n_signed = n * torch.as_tensor(1.0 - 2.0 * P.sc_flip, device=dev)[:, None]
        gi_idx = np.where(flip, ci, si)
        gj_idx = np.where(flip, si, ci)
        add(pos, n_signed, depth, gb_np[gi_idx], gb_np[gj_idx], pair_mu(gi_idx, gj_idx))

    # ---- capsule-like vs capsule-like ----
    if P.cc.shape[0]:
        i, j = P.cc[:, 0], P.cc[:, 1]
        ai = g_rot[:, ix(i)][..., :, 2] * size[ix(i), 1][:, None]
        aj = g_rot[:, ix(j)][..., :, 2] * size[ix(j), 1][:, None]
        gpi, gpj = g_pos[:, ix(i)], g_pos[:, ix(j)]
        pa, pb = _segment_segment(gpi - ai, gpi + ai, gpj - aj, gpj + aj)
        n, dist = _safe_dir(pa - pb)
        depth = size[ix(i), 0] + size[ix(j), 0] - dist
        pos = pb + n * (size[ix(j), 0] - 0.5 * depth)[..., None]
        add(pos, n, depth, gb_np[i], gb_np[j], pair_mu(i, j))

    # ---- box vs sphere / capsule: three sample spheres along the other's axis ----
    if P.box_other.shape[0]:
        bi, oi = P.box_other[:, 0], P.box_other[:, 1]
        box_is_i = P.box_other[:, 2].astype(np.float32)
        half = size[ix(bi)]                                         # (n, 3)
        Rb, pb = g_rot[:, ix(bi)], g_pos[:, ix(bi)]
        is_caplike = torch.as_tensor(
            [float(model.geom_types[int(o)] != M.GEOM_SPHERE) for o in oi], device=dev)
        axis = g_rot[:, ix(oi)][..., :, 2] * (size[ix(oi), 1] * is_caplike)[:, None]
        r = size[ix(oi), 0]
        go = g_pos[:, ix(oi)]
        samples = torch.stack([go - axis, go, go + axis], dim=2)    # (B, n, 3 samples, 3)
        c_local = torch.einsum("bnji,bnsj->bnsi", Rb, samples - pb[:, :, None])
        dpt, n_l, surf_l = _point_box_depth(c_local, half[:, None, :])
        n_w = torch.einsum("bnij,bnsj->bnsi", Rb, n_l)
        depth = dpt + r[:, None]
        pos = pb[:, :, None] + torch.einsum("bnij,bnsj->bnsi", Rb, surf_l)
        sign = torch.as_tensor(1.0 - 2.0 * box_is_i, device=dev)[:, None, None]
        gi_idx = np.where(box_is_i > 0, bi, oi)
        gj_idx = np.where(box_is_i > 0, oi, bi)
        add(pos.reshape(Bn, -1, 3), (sign * n_w).reshape(Bn, -1, 3), depth.reshape(Bn, -1),
            np.repeat(gb_np[gi_idx], 3), np.repeat(gb_np[gj_idx], 3),
            torch.repeat_interleave(pair_mu(bi, oi), 3))

    # ---- box vs box: corners of each in the other, the 4 deepest each way ----
    corners_l = torch.as_tensor(_BOX_CORNERS, device=dev)
    for (i, j) in P.box_box:
        for (src, dst, src_is_i) in ((i, j, True), (j, i, False)):
            Rs, ps = g_rot[:, src], g_pos[:, src]
            Rd, pd = g_rot[:, dst], g_pos[:, dst]
            corners = torch.einsum("bij,cj->bci", Rs, corners_l * size[src]) + ps[:, None]
            c_local = torch.einsum("bji,bcj->bci", Rd, corners - pd[:, None])
            dpths, n_ls, surf_ls = _point_box_depth(c_local, size[dst])
            # a stable sort: among equal depths the lower corner first, as top_k
            order = torch.sort(dpths, dim=-1, descending=True, stable=True).indices[:, :4]
            sel_d = torch.gather(dpths, 1, order)
            o3 = order[..., None].expand(Bn, 4, 3)
            sel_n = torch.einsum("bij,bcj->bci", Rd, torch.gather(n_ls, 1, o3))
            sel_p = pd[:, None] + torch.einsum("bij,bcj->bci", Rd, torch.gather(surf_ls, 1, o3))
            sign = 1.0 if src_is_i else -1.0
            add(sel_p, sign * sel_n, sel_d, np.full(4, gb_np[i]), np.full(4, gb_np[j]),
                pair_mu([i], [j]))

    pos = torch.cat(pts, dim=1)
    depth = torch.cat(depths, dim=1)
    normal = torch.cat(normals, dim=1)
    ba = torch.cat(bas, dim=1)
    bb = torch.cat(bbs, dim=1)
    mu = torch.cat(mus, dim=1)

    # the compaction: penetrating candidates first, then the speculative
    # ones within the margin, each in candidate order; past k, dropped
    C = pos.shape[1]
    k = min(max_contacts, C)
    pen = depth > 0.0
    rank = torch.cumsum(pen.to(torch.int64), dim=1) - 1
    slot = torch.where(pen, rank, torch.full_like(rank, k))
    if margin > 0.0:
        gap = (depth <= 0.0) & (depth > -margin)
        rank_g = (torch.cumsum(gap.to(torch.int64), dim=1) - 1
                  + pen.to(torch.int64).sum(1, keepdim=True))
        slot = torch.where(gap, torch.clamp(rank_g, max=k), slot)
    slot = torch.clamp(slot, max=k)      # slot k collects what is dropped
    idx = torch.full((Bn, k + 1), C, dtype=torch.int64, device=dev)
    idx = idx.scatter(1, slot, torch.arange(C, device=dev).expand(Bn, C))[:, :k]
    valid = idx < C
    ic = torch.clamp(idx, max=C - 1)
    z3 = valid[..., None].to(pos.dtype)
    ic3 = ic[..., None].expand(Bn, k, 3)
    zero = torch.zeros_like(ic)
    out = Contacts(
        pos=torch.gather(pos, 1, ic3) * z3,
        normal=torch.gather(normal, 1, ic3) * z3,
        depth=torch.where(valid, torch.gather(depth, 1, ic), torch.zeros_like(depth[:, :k])),
        body_a=torch.where(valid, torch.gather(ba, 1, ic), zero),
        body_b=torch.where(valid, torch.gather(bb, 1, ic), zero),
        friction=torch.where(valid, torch.gather(mu, 1, ic), torch.zeros_like(mu[:, :k])),
    )
    return Contacts(*(x.reshape(lead + x.shape[1:]) for x in out))
