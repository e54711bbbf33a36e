"""Checkpoints in the reference's layout (port of
``ase_tpu/learning/checkpoint.py``).

A checkpoint is an npz keyed by the JAX tree path of a train-state leaf,
e.g. ``.params['params']['actor_mlp']['Dense_0']['kernel']`` or
``.opt_state[0].mu['params']['mu']['bias']``; the port reads and writes
the same keys and shapes, so either package resumes or plays the other's
files. The port describes its state as a flat mapping from such a key to a
``Leaf``: the reference's shape, a getter that returns the value in the
reference's layout and dtype, and a setter that writes such an array back.
flax ``Dense`` kernels are (in, out) and ``nn.Linear`` weights (out, in),
so kernels (and their Adam moments) are transposed; index tensors are
int64 in the port and int32 on disk. Keys the reference does not have (the
port's ``torch.Generator`` states, under ``.torch_generator``) are ignored
by its restore.

``restore`` matches the reference's: strict (training resume) raises on a
missing key or a shape mismatch unless the key contains one of
``allow_missing``; non-strict (players) keeps the port's value for missing
keys and for per-env shapes. Nothing is set unless every key checks out.
Only the reading side is copied: saving is not.
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from h100_bench.reference.ase_ref.learning.running_mean_std import RunningMeanStd

_TOKEN = re.compile(r"\['([^']+)'\]|\.(\w+)")
_DISK_DTYPE = {torch.float32: np.float32, torch.float64: np.float64, torch.int64: np.int32,
               torch.int32: np.int32, torch.bool: np.bool_, torch.uint8: np.uint8}
GENERATOR_KEY = ".torch_generator"
_RMS_FIELDS = ("mean", "var", "count")


def _contiguous(a) -> np.ndarray:
    """``a`` in C order, keeping 0-d arrays 0-d."""
    return np.asarray(a, order="C")


class Leaf(NamedTuple):
    shape: Tuple[int, ...]
    get: Callable[[], np.ndarray]
    set: Callable[[np.ndarray], None]


def slot_leaf(box, name: str, transpose: bool = False) -> Leaf:
    """The tensor at ``box[name]`` (a dict) or ``box.name``, read at call
    time. Setting copies into an ``nn.Parameter`` in place and replaces any
    other tensor."""
    is_dict = isinstance(box, dict)

    def cur() -> torch.Tensor:
        return box[name] if is_dict else getattr(box, name)

    t0 = cur()
    shape = tuple(t0.shape[::-1]) if transpose else tuple(t0.shape)
    disk = _DISK_DTYPE[t0.dtype]

    def get():
        a = cur().detach().cpu().numpy()
        return _contiguous(a.T if transpose else a).astype(disk, copy=False)

    @torch.no_grad()
    def set_(a):
        t = cur()
        new = torch.as_tensor(_contiguous(a.T if transpose else a)).to(t.device, t.dtype)
        if isinstance(t, nn.Parameter):
            t.copy_(new)
        elif is_dict:
            box[name] = new
        else:
            setattr(box, name, new)

    return Leaf(shape, get, set_)


# -- the port's modules as leaves -------------------------------------------------

def _linears(net):
    """(flax path, nn.Linear) of every dense layer of an AMP, ASE or HRL
    network."""
    out = []
    for name in ("actor_mlp", "critic_mlp", "disc_mlp", "enc_mlp"):
        if getattr(net, name, None) is not None:
            out += [((name, f"Dense_{i}"), layer)
                    for i, layer in enumerate(getattr(net, name).layers)]
    if hasattr(net, "style_net"):
        style = net.style_net.mlp.layers
        out += [(("style_net", f"Dense_{i}"), layer) for i, layer in enumerate(style)]
        out.append((("style_net", f"Dense_{len(style)}"), net.style_net.out))
    for name in ("mu", "value", "disc_logits", "enc_head"):
        if hasattr(net, name):
            out.append(((name,), getattr(net, name)))
    return out


def _path_key(path) -> str:
    return "".join(f"['{p}']" for p in path)


def _params(net):
    """(flax params path, parameter, is_kernel) of every leaf of ``net``."""
    out = []
    for path, layer in _linears(net):
        out.append((path + ("kernel",), layer.weight, True))
        out.append((path + ("bias",), layer.bias, False))
    out.append((("sigma",), net.sigma, False))
    return out


def network_leaves(net, prefix: str = "") -> Dict[str, Leaf]:
    """``net``'s parameters under ``prefix + "['params']..."``."""
    return {prefix + "['params']" + _path_key(path): _param_leaf(p, kernel)
            for path, p, kernel in _params(net)}


def _param_leaf(p: nn.Parameter, transpose: bool) -> Leaf:
    return slot_leaf({"p": p}, "p", transpose)


def rms_leaves(rms: RunningMeanStd, prefix: str) -> Dict[str, Leaf]:
    return {f"{prefix}.{f}": slot_leaf(rms, f) for f in _RMS_FIELDS}


# -- files ----------------------------------------------------------------------------


def restore(path: str, leaves: Mapping[str, Leaf], prefix: str = "", strict: bool = True,
            allow_missing: tuple = ()) -> list:
    """Set each leaf from the checkpoint key ``prefix + key``. With
    ``strict``, a missing key or a shape mismatch raises unless the key
    contains one of ``allow_missing``; without it such leaves keep their
    value. Returns the keys that were set."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        found = {}
        for key, leaf in leaves.items():
            full = prefix + key
            skippable = (not strict) or any(x in full for x in allow_missing)
            if full not in data.files:
                if not skippable:
                    raise KeyError(f"checkpoint missing {full}")
                continue
            arr = data[full]
            if tuple(arr.shape) != tuple(leaf.shape):
                if not skippable:
                    raise ValueError(f"{full}: shape {arr.shape} != template {leaf.shape}")
                continue
            found[key] = arr
    for key, arr in found.items():
        leaves[key].set(arr)
    return list(found)


def restore_subtree(path: str, leaves: Mapping[str, Leaf], key_prefix: str) -> list:
    """Strict restore of leaves whose checkpoint keys start with
    ``key_prefix`` (e.g. ``.params`` or ``.extra['amp_rms']``)."""
    return restore(path, leaves, prefix=key_prefix)


# -- env states -------------------------------------------------------------------------


# -- the reference's params tree, for the parity tests ----------------------------------


