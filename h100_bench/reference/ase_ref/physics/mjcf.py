"""MJCF -> Model builder (port of ``ase_tpu/physics/mjcf.py``; host-side,
runs once at env construction).

Parses the subset of MuJoCo XML the humanoid assets use: nested bodies with
free/hinge joints, sphere/capsule/box/cylinder geoms with densities, default
classes and motor actuators. Consecutive x,y,z hinges collapse into one
spherical joint.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench.reference.ase_ref.physics import model as M

DEG2RAD = np.pi / 180.0


def _parse_vec(s: Optional[str], default=None):
    if s is None:
        return None if default is None else np.asarray(default, dtype=np.float64)
    return np.asarray([float(x) for x in s.split()], dtype=np.float64)


def _merge_attrib(base: Dict[str, str], elem: ET.Element) -> Dict[str, str]:
    out = dict(base)
    out.update(elem.attrib)
    return out


class _Defaults:
    """Resolves MJCF <default> class inheritance for joint/geom/motor tags."""

    def __init__(self, root: ET.Element):
        self.classes: Dict[str, Dict[str, Dict[str, str]]] = {"": {}}
        for d in root.findall("default"):
            self._walk(d, "", {})

    def _walk(self, elem: ET.Element, parent_cls: str, inherited: Dict[str, Dict[str, str]]):
        cls = elem.get("class", parent_cls)
        merged = {k: dict(v) for k, v in inherited.items()}
        for child in elem:
            if child.tag == "default":
                continue
            merged.setdefault(child.tag, {})
            merged[child.tag].update(child.attrib)
        self.classes[cls] = merged
        for child in elem.findall("default"):
            self._walk(child, cls, merged)

    def resolve(self, tag: str, elem: ET.Element, active_class: str) -> Dict[str, str]:
        cls = elem.get("class", active_class)
        base = self.classes.get(cls, {}).get(tag, {})
        return _merge_attrib(base, elem)


def _quat_between_z(axis: np.ndarray) -> np.ndarray:
    """xyzw quaternion rotating local +z onto `axis` (unit)."""
    z = np.array([0.0, 0.0, 1.0])
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    c = float(np.dot(z, a))
    if c > 1.0 - 1e-10:
        return np.array([0.0, 0.0, 0.0, 1.0])
    if c < -1.0 + 1e-10:
        return np.array([1.0, 0.0, 0.0, 0.0])  # 180° about x
    v = np.cross(z, a)
    s = np.sqrt((1.0 + c) * 2.0)
    return np.array([v[0] / s, v[1] / s, v[2] / s, s / 2.0])


def _np_quat_to_mat(q):
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


class _BodyAccum:
    def __init__(self):
        self.names: List[str] = []
        self.parents: List[int] = []
        self.jtype: List[int] = []
        self.ipos: List[np.ndarray] = []
        self.iquat: List[np.ndarray] = []
        self.axis: List[np.ndarray] = []
        self.mass_parts: List[list] = []
        self.joints_per_body: List[list] = []  # per-body list of joint dicts
        self.geoms: List[dict] = []


def _parse_geom(attrib: Dict[str, str], body_id: int) -> Optional[dict]:
    gtype = attrib.get("type", "capsule")
    density = float(attrib.get("density", 1000.0))
    friction = _parse_vec(attrib.get("friction"), [1.0, 0.005, 0.0001])[0]
    pos = _parse_vec(attrib.get("pos"), [0, 0, 0])
    quat = np.array([0.0, 0.0, 0.0, 1.0])
    size = _parse_vec(attrib.get("size"), [0.0, 0.0, 0.0])
    fromto = _parse_vec(attrib.get("fromto"))

    if gtype == "plane":
        return None  # modeled analytically as the ground

    if fromto is not None and gtype in ("capsule", "cylinder"):
        p1, p2 = fromto[:3], fromto[3:]
        pos = 0.5 * (p1 + p2)
        d = p2 - p1
        half = 0.5 * np.linalg.norm(d)
        quat = _quat_between_z(d) if half > 1e-9 else quat
        radius = size[0]
        out_size = np.array([radius, half, 0.0])
        mtype = M.GEOM_CAPSULE if gtype == "capsule" else M.GEOM_CYLINDER
        if gtype == "capsule":
            m, I = M.capsule_mass_inertia(radius, half, density)
        else:
            m, I = M.cylinder_mass_inertia(radius, half, density)
    elif gtype == "sphere":
        mtype = M.GEOM_SPHERE
        radius = size[0]
        out_size = np.array([radius, 0.0, 0.0])
        m, I = M.sphere_mass_inertia(radius, density)
    elif gtype == "box":
        mtype = M.GEOM_BOX
        half = size[:3]
        out_size = half.copy()
        m, I = M.box_mass_inertia(half, density)
    elif gtype == "capsule":
        # capsule given as size="r half" + pos
        mtype = M.GEOM_CAPSULE
        out_size = np.array([size[0], size[1], 0.0])
        m, I = M.capsule_mass_inertia(size[0], size[1], density)
    elif gtype == "cylinder":
        mtype = M.GEOM_CYLINDER
        out_size = np.array([size[0], size[1], 0.0])
        m, I = M.cylinder_mass_inertia(size[0], size[1], density)
    else:
        raise ValueError(f"unsupported geom type {gtype}")

    R = _np_quat_to_mat(quat)
    I_body = M.rotate_inertia(R, I)
    return {
        "type": mtype,
        "body": body_id,
        "pos": pos,
        "quat": quat,
        "size": out_size,
        "friction": friction,
        "mass": m,
        "com": pos,
        "inertia": I_body,
    }


def _walk_body(elem: ET.Element, parent: int, acc: _BodyAccum, defaults: _Defaults, active_class: str):
    active_class = elem.get("childclass", active_class)
    body_id = len(acc.names)
    acc.names.append(elem.get("name", f"body{body_id}"))
    acc.parents.append(parent)
    acc.ipos.append(_parse_vec(elem.get("pos"), [0, 0, 0]))
    quat_attr = _parse_vec(elem.get("quat"))
    if quat_attr is not None:  # MJCF order wxyz -> xyzw
        acc.iquat.append(np.array([quat_attr[1], quat_attr[2], quat_attr[3], quat_attr[0]]))
    else:
        acc.iquat.append(np.array([0.0, 0.0, 0.0, 1.0]))
    acc.mass_parts.append([])
    acc.joints_per_body.append([])
    acc.jtype.append(-1)
    acc.axis.append(np.array([0.0, 1.0, 0.0]))

    if elem.find("freejoint") is not None:
        acc.jtype[body_id] = M.FREE

    for j in elem.findall("joint"):
        a = defaults.resolve("joint", j, active_class)
        jt = a.get("type", "hinge")
        if jt == "free":
            acc.jtype[body_id] = M.FREE
            continue
        if jt != "hinge":
            raise ValueError(f"unsupported joint type {jt}")
        rng = _parse_vec(a.get("range"), [-180.0, 180.0]) * DEG2RAD
        acc.joints_per_body[body_id].append(
            {
                "name": j.get("name", ""),
                "axis": _parse_vec(a.get("axis"), [0, 0, 1]),
                "range": rng,
                "stiffness": float(a.get("stiffness", 0.0)),
                "damping": float(a.get("damping", 0.0)),
                "armature": float(a.get("armature", 0.0)),
            }
        )

    for g in elem.findall("geom"):
        a = defaults.resolve("geom", g, active_class)
        parsed = _parse_geom(a, body_id)
        if parsed is not None:
            acc.geoms.append(parsed)
            acc.mass_parts[body_id].append((parsed["mass"], parsed["com"], parsed["inertia"]))

    for child in elem.findall("body"):
        _walk_body(child, body_id, acc, defaults, active_class)


def load_mjcf(path: str, device="cuda") -> M.Model:
    tree = ET.parse(path)
    root = tree.getroot()
    defaults = _Defaults(root)
    world = root.find("worldbody")

    acc = _BodyAccum()
    for body in world.findall("body"):
        _walk_body(body, -1, acc, defaults, "")

    nb = len(acc.names)

    # classify joints per body; build dof layout
    jtype = []
    joint_axis = np.tile(np.array([0.0, 1.0, 0.0]), (nb, 1))
    dof_offset = []
    stiffness, damping, armature, lo, hi = [], [], [], [], []
    joint_names_per_dof: List[str] = []
    dof_body_ids, dof_offsets = [], [0]
    nu = 0

    for b in range(nb):
        joints = acc.joints_per_body[b]
        dof_offset.append(nu)
        if acc.jtype[b] == M.FREE:
            if joints:
                raise ValueError("free body with extra joints unsupported")
            jtype.append(M.FREE)
            nu += 6
            continue
        if b == 0 and not joints:
            # fixed-base articulation (welded to the world)
            jtype.append(-1)
            continue
        if len(joints) == 0:
            jtype.append(-1)  # fixed weld to parent
            continue
        if len(joints) == 3:
            axes = np.stack([j["axis"] for j in joints])
            expected = np.eye(3)
            if not np.allclose(axes, expected, atol=1e-6):
                raise ValueError(
                    f"3-hinge cluster in body {acc.names[b]} must be x,y,z ordered")
            jtype.append(M.SPHERICAL)
            for j in joints:
                stiffness.append(j["stiffness"])
                damping.append(j["damping"])
                armature.append(j["armature"])
                lo.append(j["range"][0])
                hi.append(j["range"][1])
                joint_names_per_dof.append(j["name"])
            dof_body_ids.append(b)
            dof_offsets.append(dof_offsets[-1] + 3)
            nu += 3
        elif len(joints) == 1:
            j = joints[0]
            jtype.append(M.REVOLUTE)
            joint_axis[b] = j["axis"] / np.linalg.norm(j["axis"])
            stiffness.append(j["stiffness"])
            damping.append(j["damping"])
            armature.append(j["armature"])
            lo.append(j["range"][0])
            hi.append(j["range"][1])
            joint_names_per_dof.append(j["name"])
            dof_body_ids.append(b)
            dof_offsets.append(dof_offsets[-1] + 1)
            nu += 1
        else:
            raise ValueError(f"body {acc.names[b]} has {len(joints)} hinges (want 0,1,3)")

    # mass properties per body
    mass = np.zeros(nb)
    com = np.zeros((nb, 3))
    inertia = np.zeros((nb, 3, 3))
    for b in range(nb):
        m, c, I = M.combine_inertias(acc.mass_parts[b])
        mass[b], com[b], inertia[b] = m, c, I
        if m <= 0:
            # massless connector bodies destabilize dynamics; give a tiny mass
            mass[b] = 0.01
            inertia[b] = np.eye(3) * 1e-5

    # actuator gears by joint name → per-dof
    gears = {}
    act = root.find("actuator")
    if act is not None:
        for motor in act.findall("motor"):
            a = defaults.resolve("motor", motor, "")
            gears[a.get("joint")] = float(a.get("gear", 1.0))
    motor_gear = np.array([gears.get(n, 0.0) for n in joint_names_per_dof])

    geoms = acc.geoms

    def f32(x):
        return torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)

    return M.Model(
        body_names=tuple(acc.names),
        parents=tuple(acc.parents),
        jtype=tuple(jtype),
        dof_offset=tuple(dof_offset),
        nu=nu,
        dof_body_ids=tuple(dof_body_ids),
        dof_offsets=tuple(dof_offsets),
        num_props=0,
        geom_types=tuple(g["type"] for g in geoms),
        geom_body=tuple(g["body"] for g in geoms),
        body_ipos=f32(np.stack(acc.ipos)),
        body_iquat=f32(np.stack(acc.iquat)),
        joint_axis=f32(joint_axis),
        mass=f32(mass),
        com=f32(com),
        inertia=f32(inertia),
        stiffness=f32(stiffness),
        damping=f32(damping),
        armature=f32(armature),
        dof_limit_lo=f32(lo),
        dof_limit_hi=f32(hi),
        motor_gear=f32(motor_gear),
        geom_pos=f32(np.stack([g["pos"] for g in geoms])),
        geom_quat=f32(np.stack([g["quat"] for g in geoms])),
        geom_size=f32(np.stack([g["size"] for g in geoms])),
        geom_friction=f32([g["friction"] for g in geoms]),
        gravity=f32([0.0, 0.0, -9.81]),
        plane_friction=f32(1.0),
        ang_damping=f32(0.01),
        max_ang_vel=f32(100.0),
    )


def find_asset(asset_root: str, asset_file: str) -> str:
    """An explicit existing asset_root takes precedence over the vendored
    tree under data/assets."""
    from h100_bench.reference.ase_ref.utils import paths

    for c in (os.path.join(asset_root, asset_file),
              os.path.join(paths.asset_root(), asset_file)):
        if os.path.exists(c):
            return c
    raise FileNotFoundError(f"asset {asset_file} not found under {asset_root}")
