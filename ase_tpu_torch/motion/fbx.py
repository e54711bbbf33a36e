"""Pure-Python FBX binary reader for mocap import — no Autodesk SDK needed
(port of ``ase_tpu/motion/fbx.py``: host-side numpy, as the reference).

The reference's FBX path (``ase/poselib/poselib/skeleton/backend/fbx/
fbx_backend.py``) shells into the closed-source Autodesk FBX Python SDK and
samples ``EvaluateLocalTransform`` per joint per frame. That SDK cannot be
redistributed, so here the Kaydara FBX *binary* container (versions 7.0-7.5)
is parsed directly and the local-transform evaluation is reimplemented from
the documented FBX transformation pipeline:

    L = T · R_pre · R_euler · R_post^{-1} · S

(rotation/scaling pivots and offsets are honored when present; mocap exports
leave them at identity). Animation is read from the AnimationCurveNode /
AnimationCurve object graph (``KeyTime`` in 1/46,186,158,000 s ticks,
``KeyValueFloat``) and sampled with linear interpolation — mocap clips are
densely keyed per frame, so interpolation flags are immaterial.

Behavior parity with the reference backend (``fbx_backend.py:19-120``):

* the skeleton root is the animated node with the longest curve (breadth-
  first from the scene root) unless ``root_joint`` names one explicitly;
* the skeleton is the root plus all its Model descendants;
* per-frame local transforms are divided by the node's (uniform) local
  scale; non-uniform scaling raises, as in the reference;
* sampling runs from the animation-stack local start to stop at the file's
  native frame rate unless ``fps`` overrides it.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC = b"Kaydara FBX Binary  \x00\x1a\x00"
KTIME_PER_SEC = 46186158000  # FbxTime ticks per second (documented constant)


# ---------------------------------------------------------------------------
# low-level record parser
# ---------------------------------------------------------------------------

@dataclass
class FbxNode:
    """One record in the FBX node tree."""

    name: str
    props: List[object] = field(default_factory=list)
    children: List["FbxNode"] = field(default_factory=list)

    def child(self, name: str) -> Optional["FbxNode"]:
        for c in self.children:
            if c.name == name:
                return c
        return None

    def find_all(self, name: str) -> List["FbxNode"]:
        return [c for c in self.children if c.name == name]


def _read_props(buf: memoryview, pos: int, count: int) -> Tuple[List[object], int]:
    props: List[object] = []
    for _ in range(count):
        code = chr(buf[pos]); pos += 1
        if code == "Y":
            props.append(struct.unpack_from("<h", buf, pos)[0]); pos += 2
        elif code == "C":
            props.append(bool(buf[pos])); pos += 1
        elif code == "I":
            props.append(struct.unpack_from("<i", buf, pos)[0]); pos += 4
        elif code == "F":
            props.append(struct.unpack_from("<f", buf, pos)[0]); pos += 4
        elif code == "D":
            props.append(struct.unpack_from("<d", buf, pos)[0]); pos += 8
        elif code == "L":
            props.append(struct.unpack_from("<q", buf, pos)[0]); pos += 8
        elif code in "fdlib":
            n, enc, clen = struct.unpack_from("<III", buf, pos); pos += 12
            dtype = {"f": "<f4", "d": "<f8", "l": "<i8", "i": "<i4", "b": "<i1"}[code]
            if enc == 0:
                nbytes = n * np.dtype(dtype).itemsize
                raw = bytes(buf[pos : pos + nbytes]); pos += nbytes
            else:
                raw = zlib.decompress(bytes(buf[pos : pos + clen])); pos += clen
            props.append(np.frombuffer(raw, dtype=dtype).copy())
        elif code == "S":
            n = struct.unpack_from("<I", buf, pos)[0]; pos += 4
            props.append(bytes(buf[pos : pos + n]).decode("utf-8", "replace")); pos += n
        elif code == "R":
            n = struct.unpack_from("<I", buf, pos)[0]; pos += 4
            props.append(bytes(buf[pos : pos + n])); pos += n
        else:
            raise ValueError(f"unknown FBX property type code {code!r} at {pos}")
    return props, pos


def _read_node(buf: memoryview, pos: int, big: bool) -> Tuple[Optional[FbxNode], int]:
    if big:
        end, nprops, _plen = struct.unpack_from("<QQQ", buf, pos); pos += 24
    else:
        end, nprops, _plen = struct.unpack_from("<III", buf, pos); pos += 12
    nlen = buf[pos]; pos += 1
    if end == 0:  # null record terminates a child list
        return None, pos + nlen
    name = bytes(buf[pos : pos + nlen]).decode("ascii", "replace"); pos += nlen
    props, pos = _read_props(buf, pos, nprops)
    node = FbxNode(name, props)
    while pos < end:
        child, pos = _read_node(buf, pos, big)
        if child is None:
            break
        node.children.append(child)
    return node, end


def parse_fbx(path: str) -> Tuple[FbxNode, int]:
    """Parse an FBX binary file into its root node list. Returns (root, version)."""
    data = open(path, "rb").read()
    if not data.startswith(_MAGIC):
        raise ValueError(
            f"{path}: not an FBX binary file (ASCII FBX is not supported; "
            "re-export as binary)"
        )
    version = struct.unpack_from("<I", data, 23)[0]
    big = version >= 7500  # 64-bit record headers from FBX 2016 on
    buf = memoryview(data)
    pos = 27
    root = FbxNode("(root)")
    while pos < len(data):
        node, pos = _read_node(buf, pos, big)
        if node is None:
            break
        root.children.append(node)
    return root, version


# ---------------------------------------------------------------------------
# scene graph
# ---------------------------------------------------------------------------

def _props70(obj: FbxNode) -> Dict[str, List[object]]:
    out: Dict[str, List[object]] = {}
    p70 = obj.child("Properties70")
    if p70 is not None:
        for p in p70.find_all("P"):
            out[p.props[0]] = p.props[4:]
    return out


def _vec3(props: Dict[str, List[object]], key: str, default=(0.0, 0.0, 0.0)):
    v = props.get(key)
    if v is None or len(v) < 3:
        return np.asarray(default, dtype=np.float64)
    return np.asarray(v[:3], dtype=np.float64)


@dataclass
class _Model:
    uid: int
    name: str
    subtype: str
    props: Dict[str, List[object]]
    parent: Optional[int] = None
    children: List[int] = field(default_factory=list)


@dataclass
class _Curve:
    times: np.ndarray   # (K,) int64 KTime ticks
    values: np.ndarray  # (K,) float32


class FbxScene:
    """Object/connection view of a parsed FBX document."""

    def __init__(self, root: FbxNode):
        self.models: Dict[int, _Model] = {}
        self.curve_nodes: Dict[int, Dict[str, float]] = {}   # uid -> channel defaults
        self.curves: Dict[int, _Curve] = {}
        self.stacks: Dict[int, Dict[str, List[object]]] = {}
        objects = root.child("Objects")
        if objects is None:
            raise ValueError("FBX file has no Objects section")
        for obj in objects.children:
            uid = obj.props[0] if obj.props else 0
            if obj.name == "Model":
                # props[1] is b"Name\x00\x01Model"-style; keep the short name
                raw = obj.props[1]
                name = raw.split("\x00")[0] if isinstance(raw, str) else str(raw)
                self.models[uid] = _Model(uid, name, obj.props[2], _props70(obj))
            elif obj.name == "AnimationCurveNode":
                p = _props70(obj)
                self.curve_nodes[uid] = {
                    k[-1]: float(v[0]) for k, v in p.items()
                    if k in ("d|X", "d|Y", "d|Z") and v
                }
            elif obj.name == "AnimationCurve":
                kt = obj.child("KeyTime")
                kv = obj.child("KeyValueFloat")
                if kt is not None and kv is not None:
                    self.curves[uid] = _Curve(
                        np.asarray(kt.props[0], dtype=np.int64),
                        np.asarray(kv.props[0], dtype=np.float32),
                    )
            elif obj.name == "AnimationStack":
                self.stacks[uid] = _props70(obj)

        # connections
        self.obj_children: Dict[int, List[int]] = {}
        # model uid -> {"Lcl Translation": curve_node_uid, ...}
        self.model_anim: Dict[int, Dict[str, int]] = {}
        # curve_node uid -> {"X": curve_uid, ...}
        self.curve_node_channels: Dict[int, Dict[str, int]] = {}
        conns = root.child("Connections")
        for c in conns.find_all("C") if conns is not None else []:
            kind, src, dst = c.props[0], c.props[1], c.props[2]
            if kind == "OO":
                if src in self.models and (dst in self.models or dst == 0):
                    self.models[src].parent = dst if dst in self.models else None
                    self.obj_children.setdefault(dst, []).append(src)
            elif kind == "OP":
                prop = c.props[3]
                if src in self.curve_nodes and dst in self.models:
                    self.model_anim.setdefault(dst, {})[prop] = src
                elif src in self.curves and dst in self.curve_nodes:
                    self.curve_node_channels.setdefault(dst, {})[prop[-1]] = src

        self.global_settings = {}
        gs = root.child("GlobalSettings")
        if gs is not None:
            self.global_settings = _props70(gs)

    # -- animation ---------------------------------------------------------

    def time_span(self) -> Tuple[int, int]:
        """(start, stop) in KTime ticks: animation-stack local span, falling
        back to the min/max key time over all curves."""
        for p in self.stacks.values():
            start = p.get("LocalStart"); stop = p.get("LocalStop")
            if stop and int(stop[0]) > 0:
                return int(start[0]) if start else 0, int(stop[0])
        times = [c.times for c in self.curves.values() if c.times.size]
        if not times:
            raise ValueError("FBX file contains no animation keys")
        return (
            int(min(t[0] for t in times)),
            int(max(t[-1] for t in times)),
        )

    def native_fps(self, start: int, stop: int) -> float:
        """Frame rate from key density of the longest curve (mocap files are
        keyed every frame, matching the SDK's frame count over the span)."""
        best = max(self.curves.values(), key=lambda c: c.times.size, default=None)
        if best is None or best.times.size < 2 or stop <= start:
            return 30.0
        span_s = (stop - start) / KTIME_PER_SEC
        return round((best.times.size - 1) / span_s) if span_s > 0 else 30.0

    def longest_curve_len(self, uid: int) -> int:
        """Longest animation-curve key count attached to a model (reference
        fbx_backend.py:177-210 root-search criterion)."""
        best = 0
        for cn_uid in self.model_anim.get(uid, {}).values():
            for cv_uid in self.curve_node_channels.get(cn_uid, {}).values():
                best = max(best, self.curves[cv_uid].times.size)
        return best

    def sample_channel(
        self, model_uid: int, prop: str, t_ticks: np.ndarray
    ) -> Optional[np.ndarray]:
        """Sample a 3-vector property ('Lcl Translation'/'Lcl Rotation'/
        'Lcl Scaling') at the given tick times → (T, 3) or None if static."""
        cn_uid = self.model_anim.get(model_uid, {}).get(prop)
        if cn_uid is None:
            return None
        defaults = self.curve_nodes.get(cn_uid, {})
        static = _vec3(self.models[model_uid].props, prop)
        out = np.empty((t_ticks.size, 3), dtype=np.float64)
        for i, ax in enumerate("XYZ"):
            cv_uid = self.curve_node_channels.get(cn_uid, {}).get(ax)
            if cv_uid is None:
                out[:, i] = defaults.get(ax, static[i])
                continue
            c = self.curves[cv_uid]
            if c.times.size == 1:
                out[:, i] = c.values[0]
            else:
                out[:, i] = np.interp(
                    t_ticks.astype(np.float64),
                    c.times.astype(np.float64),
                    c.values.astype(np.float64),
                )
        return out


# ---------------------------------------------------------------------------
# rotation math (numpy, xyzw)
# ---------------------------------------------------------------------------

_AXIS = {"X": 0, "Y": 1, "Z": 2}
# FbxEuler::EOrder enum values 0..5
_ROT_ORDERS = ["XYZ", "XZY", "YZX", "YXZ", "ZXY", "ZYX"]


def _axis_quats(deg: np.ndarray, axis: int) -> np.ndarray:
    half = np.deg2rad(deg) * 0.5
    q = np.zeros(deg.shape + (4,), dtype=np.float64)
    q[..., axis] = np.sin(half)
    q[..., 3] = np.cos(half)
    return q


def _qmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return np.stack(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ],
        axis=-1,
    )


def _qconj(q: np.ndarray) -> np.ndarray:
    return q * np.asarray([-1.0, -1.0, -1.0, 1.0])


def euler_to_quat(deg: np.ndarray, order: str = "XYZ") -> np.ndarray:
    """FBX Euler angles (degrees, rotations applied in `order`) → xyzw quat.

    FBX composes column-vector style: for order XYZ the matrix is
    Rz·Ry·Rx (X applied first), so q = qZ ⊗ qY ⊗ qX.
    """
    qs = [_axis_quats(deg[..., _AXIS[ax]], _AXIS[ax]) for ax in order]
    q = qs[0]
    for nxt in qs[1:]:
        q = _qmul(nxt, q)
    return q


# ---------------------------------------------------------------------------
# mocap import (reference fbx_backend.fbx_to_npy behavior)
# ---------------------------------------------------------------------------

def load_mocap(
    path: str,
    fps: Optional[float] = None,
    root_joint: Optional[str] = None,
) -> Tuple[List[str], List[int], np.ndarray, np.ndarray, np.ndarray, float]:
    """Read an FBX mocap file.

    Returns (joint_names, parent_indices, local_rotation (T,J,4) xyzw,
    local_translation (T,J,3), root_translation (T,3), fps). Translations are
    in the file's native units, matching the SDK's EvaluateLocalTransform
    (the reference backend does not convert units either).
    """
    root, _version = parse_fbx(path)
    scene = FbxScene(root)

    # root joint: explicit name, else the animated model with the longest
    # curve reachable breadth-first from the scene root (reference
    # fbx_backend.py:43-77)
    root_uid = None
    if root_joint:
        for uid, m in scene.models.items():
            if m.name == root_joint:
                root_uid = uid
                break
        if root_uid is None:
            raise ValueError(f"root joint {root_joint!r} not found in {path}")
    else:
        best_len = 0
        order = scene.obj_children.get(0, list(scene.models))
        queue = [u for u in order if u in scene.models]
        while queue:
            uid = queue.pop(0)
            n = scene.longest_curve_len(uid)
            if n > best_len:
                best_len, root_uid = n, uid
            queue.extend(
                u for u in scene.obj_children.get(uid, []) if u in scene.models
            )
        if root_uid is None:
            raise ValueError(f"no animated joint found in {path}")

    # skeleton = root + all Model descendants, depth-first (reference
    # _get_skeleton ordering: parent before children)
    joint_uids: List[int] = []
    parents: List[int] = []

    def _walk(uid: int, parent_idx: int) -> None:
        idx = len(joint_uids)
        joint_uids.append(uid)
        parents.append(parent_idx)
        for ch in scene.obj_children.get(uid, []):
            if ch in scene.models:
                _walk(ch, idx)

    _walk(root_uid, -1)
    names = [scene.models[u].name for u in joint_uids]

    # sample times
    start, stop = scene.time_span()
    native = scene.native_fps(start, stop)
    out_fps = float(fps) if fps else float(native)
    n_frames = max(int(round((stop - start) / KTIME_PER_SEC * out_fps)), 1)
    t_ticks = start + (np.arange(n_frames, dtype=np.float64)
                       * (KTIME_PER_SEC / out_fps))

    J = len(joint_uids)
    local_rot = np.zeros((n_frames, J, 4), dtype=np.float64)
    local_t = np.zeros((n_frames, J, 3), dtype=np.float64)
    for j, uid in enumerate(joint_uids):
        m = scene.models[uid]
        rot_order = _ROT_ORDERS[int(m.props.get("RotationOrder", [0])[0]) % 6]
        pre = euler_to_quat(_vec3(m.props, "PreRotation"), "XYZ")
        post = euler_to_quat(_vec3(m.props, "PostRotation"), "XYZ")

        r = scene.sample_channel(uid, "Lcl Rotation", t_ticks)
        if r is None:
            r = np.broadcast_to(_vec3(m.props, "Lcl Rotation"), (n_frames, 3))
        t = scene.sample_channel(uid, "Lcl Translation", t_ticks)
        if t is None:
            t = np.broadcast_to(_vec3(m.props, "Lcl Translation"), (n_frames, 3))
        s = scene.sample_channel(uid, "Lcl Scaling", t_ticks)
        if s is None:
            s = np.broadcast_to(_vec3(m.props, "Lcl Scaling", (1.0, 1.0, 1.0)),
                                (n_frames, 3))
        if not np.allclose(s, s[..., :1]):
            raise ValueError(
                f"{path}: joint {m.name} has non-uniform scaling; unsupported "
                "(reference backend raises the same way, fbx_backend.py:104-111)"
            )

        q = _qmul(pre, _qmul(euler_to_quat(r, rot_order), _qconj(post)))
        local_rot[:, j] = q
        # the reference divides the whole local transform by the uniform
        # scale (fbx_backend.py:113-115), which scales translation by 1/s
        local_t[:, j] = t / np.where(s[..., :1] == 0.0, 1.0, s[..., :1])

    root_translation = local_t[:, 0, :].copy()
    return (
        names,
        parents,
        local_rot.astype(np.float32),
        local_t.astype(np.float32),
        root_translation.astype(np.float32),
        out_fps,
    )
