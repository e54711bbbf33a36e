"""Shared collision types, static pair filtering and primitive tests (port
of ``ase_tpu/physics/collision.py``): the fixed-size ``Contacts`` contract
the solver consumes and the articulation-filtered geom pair list, on
tensors with any leading batch dims."""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from h100_bench.reference.ase_ref.physics import model as M


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


