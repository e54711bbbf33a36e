"""Carry AMP / ASE weights between the reference's flax layout and the
port's modules (the read side of ``ase_tpu/learning/checkpoint.py``, and
its inverse for the parity tests).

A checkpoint key is the JAX tree path of a train-state leaf, e.g.
``.params['params']['actor_mlp']['Dense_0']['kernel']``. The loader reads
the policy parameters (``.params['params'][...]``), the observation
normalizer (``.obs_rms.*``) and the AMP normalizer
(``.extra['amp_rms'].*``); nothing is converted on disk. flax ``Dense``
kernels are (in, out) and become ``nn.Linear`` weights (out, in).
``export_ase`` writes the same tree back, with ``value_rms`` beside the
normalizers. Saving and resuming a training run are not ported yet.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

from ase_tpu_torch.learning.running_mean_std import RunningMeanStd

_TOKEN = re.compile(r"\['([^']+)'\]|\.(\w+)")


def _parse_key(key: str):
    return tuple(a or b for a, b in _TOKEN.findall(key))


def read_npz_tree(path: str) -> dict:
    """The ``params``, ``obs_rms``, ``value_rms`` and ``amp_rms`` subtrees of
    a checkpoint, as nested dicts of numpy arrays (only those keys are
    read)."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = _parse_key(key)
            if parts[:2] == ("params", "params"):
                parts = ("params",) + parts[2:]
            elif parts[:2] == ("extra", "amp_rms"):
                parts = ("amp_rms",) + parts[2:]
            elif parts[0] not in ("obs_rms", "value_rms"):
                continue
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = np.asarray(data[key])
    return tree


_RMS_FIELDS = ("mean", "var", "count")


def _linears(net):
    """(flax path, nn.Linear) of every dense layer of an AMP or ASE network."""
    out = []
    for name in ("actor_mlp", "critic_mlp", "disc_mlp"):
        out += [((name, f"Dense_{i}"), layer) for i, layer in enumerate(getattr(net, name).layers)]
    if hasattr(net, "style_net"):
        style = net.style_net.mlp.layers
        out += [(("style_net", f"Dense_{i}"), layer) for i, layer in enumerate(style)]
        out.append((("style_net", f"Dense_{len(style)}"), net.style_net.out))
    for name in ("mu", "value", "disc_logits", "enc_head"):
        if hasattr(net, name):
            out.append(((name,), getattr(net, name)))
    return out


def _get(tree: Mapping, path):
    for k in path:
        tree = tree[k]
    return tree


def _tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=like.dtype).to(like.device)


@torch.no_grad()
def load_ase(tree: Mapping, net, obs_rms: RunningMeanStd = None,
             amp_rms: RunningMeanStd = None, value_rms: RunningMeanStd = None) -> None:
    """Copy a reference AMP or ASE tree -- ``{"params": flax params,
    "obs_rms": {...}, "amp_rms": {...}, "value_rms": {...}}``, numpy
    leaves, as ``read_npz_tree`` returns or as a JAX params tree turned into
    numpy -- into the port's modules. A normalizer is read when it is
    passed."""
    p = tree["params"]
    for path, layer in _linears(net):
        d = _get(p, path)
        layer.weight.copy_(_tensor(np.asarray(d["kernel"]).T, layer.weight))
        layer.bias.copy_(_tensor(d["bias"], layer.bias))
    net.sigma.copy_(_tensor(p["sigma"], net.sigma))
    for key, rms in (("obs_rms", obs_rms), ("amp_rms", amp_rms), ("value_rms", value_rms)):
        if rms is not None:
            for f in _RMS_FIELDS:
                getattr(rms, f).copy_(_tensor(tree[key][f], getattr(rms, f)))


def export_ase(net, obs_rms: RunningMeanStd = None, amp_rms: RunningMeanStd = None,
               value_rms: RunningMeanStd = None) -> dict:
    """The inverse of ``load_ase``: the port's modules as a tree of numpy
    arrays in the reference's flax layout."""
    def arr(t):
        return t.detach().cpu().numpy().copy()

    params: dict = {"sigma": arr(net.sigma)}
    for path, layer in _linears(net):
        node = params
        for k in path:
            node = node.setdefault(k, {})
        node["kernel"] = arr(layer.weight).T.copy()
        node["bias"] = arr(layer.bias)
    tree = {"params": params}
    for key, rms in (("obs_rms", obs_rms), ("amp_rms", amp_rms), ("value_rms", value_rms)):
        if rms is not None:
            tree[key] = {f: arr(getattr(rms, f)) for f in _RMS_FIELDS}
    return tree
