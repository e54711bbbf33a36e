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
``read_npz_tree`` / ``load_ase`` / ``export_ase`` carry a network between
the reference's params tree and the port's modules (the parity tests).
"""

from __future__ import annotations

import os
import re
from typing import Callable, Dict, Mapping, NamedTuple, Tuple

import numpy as np
import torch
from torch import nn

from ase_tpu_torch.learning.running_mean_std import RunningMeanStd

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


def rows_leaf(box: dict, name: str, mesh) -> Leaf:
    """A per-env tensor ``box[name]`` holding one rank's envs of a
    data-parallel run, as the leaf of all of them: reading gathers every
    rank's rows in rank order (a collective: every rank reads), setting
    keeps this rank's."""
    t0 = box[name]
    n = t0.shape[0]
    disk = _DISK_DTYPE[t0.dtype]

    def get():
        return mesh.all_gather_rows(box[name]).cpu().numpy().astype(disk, copy=False)

    def set_(a):
        t = box[name]
        rows = _contiguous(a)[mesh.rank * n:(mesh.rank + 1) * n]
        box[name] = torch.as_tensor(rows).to(t.device, t.dtype)

    return Leaf((n * mesh.world,) + tuple(t0.shape[1:]), get, set_)


def number_leaf(obj, name: str, dtype) -> Leaf:
    """A Python number attribute, stored as a 0-d array of ``dtype``."""
    kind = type(getattr(obj, name))
    return Leaf((), lambda: np.asarray(getattr(obj, name), dtype),
                lambda a: setattr(obj, name, kind(np.asarray(a).item())))


def generator_leaf(gen: torch.Generator) -> Leaf:
    shape = tuple(gen.get_state().shape)
    return Leaf(shape, lambda: gen.get_state().numpy(),
                lambda a: gen.set_state(torch.as_tensor(np.asarray(a, np.uint8))))


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


def buffer_leaves(buf, prefix: str) -> Dict[str, Leaf]:
    return {f"{prefix}.{f}": slot_leaf(buf, f)
            for f in ("data", "head", "total_count", "perm", "cursor")}


def adam_leaves(optimizer: torch.optim.Adam, net, prefix: str) -> Dict[str, Leaf]:
    """Adam's moments and step count as optax's ``ScaleByAdamState`` under
    ``prefix`` (``.opt_state[0]`` for ``optax.adam``): ``.count``, and
    ``.mu`` / ``.nu`` over the params tree. A parameter that has not taken a
    step yet has zero moments, as optax's initial state."""
    state = optimizer.state
    params = _params(net)

    def moment(p, field, transpose):
        def get():
            t = state[p][field] if field in state[p] else torch.zeros_like(p)
            a = t.detach().cpu().numpy()
            return _contiguous(a.T if transpose else a)

        @torch.no_grad()
        def set_(a):
            st = state[p]
            if not st:
                st.update(step=torch.tensor(0.0), exp_avg=torch.zeros_like(p),
                          exp_avg_sq=torch.zeros_like(p))
            st[field] = torch.as_tensor(_contiguous(a.T if transpose else a)).to(
                p.device, p.dtype)

        return Leaf(tuple(p.shape[::-1]) if transpose else tuple(p.shape), get, set_)

    def get_count():
        st = state[params[0][1]]
        return np.asarray(int(st["step"]) if "step" in st else 0, np.int32)

    def set_count(a):
        for _, p, _ in params:
            st = state[p]
            if not st:
                st.update(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p))
            st["step"] = torch.tensor(float(np.asarray(a).item()))

    out = {f"{prefix}.count": Leaf((), get_count, set_count)}
    for name, field in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        for path, p, kernel in params:
            out[f"{prefix}.{name}['params']{_path_key(path)}"] = moment(p, field, kernel)
    return out


# -- files ----------------------------------------------------------------------------

def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def load_dict(path: str) -> dict:
    """Every array of a checkpoint by key (``checkpoint.py:67``); ``path``
    may leave out the ``.npz`` of a file that has it."""
    if not path.endswith(".npz") and os.path.exists(path + ".npz"):
        path = path + ".npz"
    with np.load(path) as data:
        return dict(data)


def save(path: str, leaves: Mapping[str, Leaf], exclude: tuple = (), write: bool = True) -> str:
    """Write the leaves whose key contains none of ``exclude`` to an npz
    (``.npz`` is appended when missing); returns the file's path. With
    ``write`` false the leaves are read (a data-parallel rank's part of
    the gathers) and nothing is written."""
    path = _npz(path)
    arrays = {k: leaf.get() for k, leaf in leaves.items() if not any(x in k for x in exclude)}
    if not write:
        return path
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    return path


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

def env_state_leaves(env, state):
    """An env state's tensors as leaves (``.obs``, ``.phys.root_pos``,
    ``.aux['amp_obs']``, ...) plus the env's generator, over a shallow copy
    of ``state``; returns (leaves, rebuild), where ``rebuild()`` gives the
    state with whatever was set."""
    fields = {k: v for k, v in vars(state).items() if k not in ("phys", "aux")}
    phys = state.phys._asdict()
    aux = dict(state.aux)
    leaves = {f".{k}": slot_leaf(fields, k) for k in fields}
    leaves.update({f".phys.{k}": slot_leaf(phys, k) for k in phys})
    leaves.update({f".aux['{k}']": slot_leaf(aux, k) for k in aux})
    leaves[GENERATOR_KEY] = generator_leaf(env.gen)

    def rebuild():
        return type(state)(phys=type(state.phys)(**phys), aux=aux, **fields)

    return leaves, rebuild


def save_env_state(path: str, env, state) -> str:
    return save(path, env_state_leaves(env, state)[0])


def restore_env_state(path: str, env, template, strict: bool = True):
    """A new env state from ``template`` with every leaf of the checkpoint;
    sets the env's generator too."""
    leaves, rebuild = env_state_leaves(env, template)
    restore(path, leaves, strict=strict)
    return rebuild()


# -- the reference's params tree, for the parity tests ----------------------------------

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


def _get(tree: Mapping, path):
    for k in path:
        tree = tree[k]
    return tree


def _tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=like.dtype).to(like.device)


@torch.no_grad()
def load_ase(tree: Mapping, net, obs_rms: RunningMeanStd = None,
             amp_rms: RunningMeanStd = None, value_rms: RunningMeanStd = None) -> None:
    """Copy a reference AMP, ASE or HRL tree -- ``{"params": flax params,
    "obs_rms": {...}, "amp_rms": {...}, "value_rms": {...}}``, numpy
    leaves, as ``read_npz_tree`` returns or as a JAX params tree turned into
    numpy -- into the port's modules. A normalizer is read when it is
    passed."""
    p = tree["params"]
    for path, param, kernel in _params(net):
        a = np.asarray(_get(p, path))
        param.copy_(_tensor(a.T if kernel else a, param))
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

    params: dict = {}
    for path, param, kernel in _params(net):
        node = params
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = arr(param).T.copy() if kernel else arr(param)
    tree = {"params": params}
    for key, rms in (("obs_rms", obs_rms), ("amp_rms", amp_rms), ("value_rms", value_rms)):
        if rms is not None:
            tree[key] = {f: arr(getattr(rms, f)) for f in _RMS_FIELDS}
    return tree
