"""Shared collision types, static pair filtering and primitive tests (port
of ``ase_tpu/physics/collision.py``): the fixed-size ``Contacts`` contract
the solver consumes, the articulation-filtered geom pair list, and the
closed-form segment-segment and point-in-box tests of ``collision2``'s
narrow phase, on tensors with any leading batch dims."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from ase_tpu_torch.physics import model as M


class Contacts(NamedTuple):
    pos: torch.Tensor       # (B, K, 3) world contact point
    normal: torch.Tensor    # (B, K, 3) unit, from body_b into body_a
    depth: torch.Tensor     # (B, K) penetration (>0 touching)
    body_a: torch.Tensor    # (B, K) int64 body index
    body_b: torch.Tensor    # (B, K) int64; -1 = ground
    friction: torch.Tensor  # (B, K)


def _weld_group(model: M.Model, b: int) -> int:
    """Nearest self-or-ancestor body carrying a joint (welds merge)."""
    while b < model.nb and model.jtype[b] == -1:
        b = model.parents[b]
    return b


def collision_pairs(model: M.Model, enable_self: bool = True) -> List[Tuple[int, int]]:
    """Geom index pairs to test: excludes same/welded bodies and
    parent-child pairs."""
    pairs = []
    nb = model.nb
    for i in range(model.ng):
        for j in range(i + 1, model.ng):
            bi, bj = model.geom_body[i], model.geom_body[j]
            both_char = bi < nb and bj < nb
            if both_char and not enable_self:
                continue
            if both_char:
                gi, gj = _weld_group(model, bi), _weld_group(model, bj)
                if gi == gj:
                    continue
                if model.parents[gi] >= 0 and _weld_group(model, model.parents[gi]) == gj:
                    continue
                if model.parents[gj] >= 0 and _weld_group(model, model.parents[gj]) == gi:
                    continue
            pairs.append((i, j))
    return pairs


def _dot(x, y):
    return (x * y).sum(-1)


def _segment_segment(a0, a1, b0, b1):
    """Closest points (pa, pb) between segments a0-a1 and b0-b1 (the
    standard clamped solve), each (..., 3)."""
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = _dot(d1, d1)
    e = _dot(d2, d2)
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    ok = torch.abs(denom) > 1e-9
    s = torch.where(ok, (b * f - c * e) / torch.where(ok, denom, torch.ones_like(denom)),
                    torch.zeros_like(denom))
    s = torch.clamp(s, 0.0, 1.0)
    t = (b * s + f) / torch.clamp(e, min=1e-9)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(t != t_cl, torch.clamp((b * t_cl - c) / torch.clamp(a, min=1e-9), 0.0, 1.0),
                    s)
    return a0 + d1 * s[..., None], b0 + d2 * t_cl[..., None]


def _point_box_depth(p_local, half):
    """Penetration of points into boxes, in the box frame: p_local
    (..., 3), half-extents broadcasting against it. Returns (depth (...),
    normal_local (..., 3), surface_point_local (..., 3)); depth > 0 inside
    (pushed out through the nearest face), else minus the distance."""
    half = half.expand_as(p_local)
    d_faces = half - torch.abs(p_local)
    inside = torch.all(d_faces > 0, dim=-1)
    clamped = torch.maximum(torch.minimum(p_local, half), -half)
    out_vec = p_local - clamped
    out_dist = torch.linalg.norm(out_vec, dim=-1) + 1e-9
    k = torch.argmin(d_faces, dim=-1, keepdim=True)
    sign = torch.gather(torch.sign(p_local), -1, k)
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    n_in = torch.zeros_like(p_local).scatter(-1, k, sign)
    depth_in = torch.gather(d_faces, -1, k)[..., 0]
    n_out = out_vec / out_dist[..., None]
    n = torch.where(inside[..., None], n_in, n_out)
    depth = torch.where(inside, depth_in, -out_dist)
    surf = torch.where(inside[..., None], p_local + n_in * depth_in[..., None], clamped)
    return depth, n, surf
