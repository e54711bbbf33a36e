"""Physics model description (port of ``ase_tpu/physics/model.py``).

A plain dataclass in place of the reference's ``flax.struct`` pytree: static
topology as tuples, numeric parameters as float32 tensors on one device.
Joint model and generalized layout are the reference's: a FREE root
(7 pos / 6 vel), 3-hinge clusters as SPHERICAL joints with exp-map dof
coordinates, single hinges as REVOLUTE joints; u =
``[root_lin_world(3), root_ang_world(3), joint dofs..., props 6k]``.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

FREE = 0
SPHERICAL = 1
REVOLUTE = 2

GEOM_SPHERE = 0
GEOM_CAPSULE = 1
GEOM_BOX = 2
GEOM_CYLINDER = 3
GEOM_PLANE = 4

_TENSOR_FIELDS = (
    "body_ipos", "body_iquat", "joint_axis", "mass", "com", "inertia",
    "stiffness", "damping", "armature", "dof_limit_lo", "dof_limit_hi",
    "motor_gear", "geom_pos", "geom_quat", "geom_size", "geom_friction",
    "gravity", "plane_friction", "ang_damping", "max_ang_vel",
)


@dataclasses.dataclass(frozen=True)
class Model:
    body_names: Tuple[str, ...]
    parents: Tuple[int, ...]
    jtype: Tuple[int, ...]
    dof_offset: Tuple[int, ...]
    nu: int
    dof_body_ids: Tuple[int, ...]
    dof_offsets: Tuple[int, ...]
    num_props: int
    geom_types: Tuple[int, ...]
    geom_body: Tuple[int, ...]

    body_ipos: torch.Tensor       # (nb, 3) joint anchor in parent frame
    body_iquat: torch.Tensor      # (nb, 4) static rotation offset
    joint_axis: torch.Tensor      # (nb, 3) hinge axis (child frame)
    mass: torch.Tensor            # (nb + np,)
    com: torch.Tensor             # (nb + np, 3)
    inertia: torch.Tensor         # (nb + np, 3, 3)
    stiffness: torch.Tensor       # (nd,)
    damping: torch.Tensor
    armature: torch.Tensor
    dof_limit_lo: torch.Tensor
    dof_limit_hi: torch.Tensor
    motor_gear: torch.Tensor
    geom_pos: torch.Tensor        # (ng, 3)
    geom_quat: torch.Tensor       # (ng, 4)
    geom_size: torch.Tensor       # (ng, 3)
    geom_friction: torch.Tensor   # (ng,)
    gravity: torch.Tensor         # (3,)
    plane_friction: torch.Tensor  # ()
    ang_damping: torch.Tensor     # ()
    max_ang_vel: torch.Tensor     # ()

    @property
    def nb(self) -> int:
        return len(self.body_names)

    @property
    def root_dofs(self) -> int:
        return 6 if self.jtype[0] == FREE else 0

    @property
    def nd(self) -> int:
        return self.nu - self.root_dofs

    @property
    def nv(self) -> int:
        return self.nu + 6 * self.num_props

    @property
    def ng(self) -> int:
        return len(self.geom_types)

    @property
    def device(self) -> torch.device:
        return self.mass.device

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def replace(self, **kw) -> "Model":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Model":
        return self.replace(**{k: getattr(self, k).to(device) for k in _TENSOR_FIELDS})

    def np(self, field: str) -> np.ndarray:
        """Host copy of a numeric field (static tables are built from it)."""
        return getattr(self, field).detach().cpu().numpy()


# -- inertia helpers (host-side numpy; used by the MJCF builder) -------------

def sphere_mass_inertia(radius: float, density: float):
    m = density * 4.0 / 3.0 * np.pi * radius**3
    i = 2.0 / 5.0 * m * radius**2
    return m, np.diag([i, i, i])


def box_mass_inertia(half: np.ndarray, density: float):
    full = 2.0 * np.asarray(half)
    m = density * full[0] * full[1] * full[2]
    ix = m / 12.0 * (full[1] ** 2 + full[2] ** 2)
    iy = m / 12.0 * (full[0] ** 2 + full[2] ** 2)
    iz = m / 12.0 * (full[0] ** 2 + full[1] ** 2)
    return m, np.diag([ix, iy, iz])


def cylinder_mass_inertia(radius: float, half_height: float, density: float):
    h = 2.0 * half_height
    m = density * np.pi * radius**2 * h
    ixy = m / 12.0 * (3.0 * radius**2 + h**2)
    iz = 0.5 * m * radius**2
    return m, np.diag([ixy, ixy, iz])


def capsule_mass_inertia(radius: float, half_height: float, density: float):
    r, h = radius, 2.0 * half_height
    m_cyl = density * np.pi * r**2 * h
    m_sph = density * 4.0 / 3.0 * np.pi * r**3
    m = m_cyl + m_sph
    ixy_c = m_cyl * (h**2 / 12.0 + r**2 / 4.0)
    iz_c = 0.5 * m_cyl * r**2
    i_s = 2.0 / 5.0 * (m_sph / 2.0) * r**2
    d = half_height + 3.0 / 8.0 * r
    ixy_s = 2.0 * (i_s + (m_sph / 2.0) * d**2)
    iz_s = 2.0 * i_s
    return m, np.diag([ixy_c + ixy_s, ixy_c + ixy_s, iz_c + iz_s])


def rotate_inertia(R: np.ndarray, I: np.ndarray) -> np.ndarray:
    return R @ I @ R.T


def shift_inertia(I_com: np.ndarray, mass: float, offset: np.ndarray) -> np.ndarray:
    d = np.asarray(offset)
    return I_com + mass * (np.dot(d, d) * np.eye(3) - np.outer(d, d))


def combine_inertias(parts):
    """parts: list of (mass, com, I_com). Returns total (mass, com, I_com)."""
    total_m = sum(p[0] for p in parts)
    if total_m <= 0:
        return 0.0, np.zeros(3), np.zeros((3, 3))
    com = sum(p[0] * np.asarray(p[1]) for p in parts) / total_m
    I = np.zeros((3, 3))
    for m, c, Ic in parts:
        I += shift_inertia(Ic, m, np.asarray(c) - com)
    return total_m, com, I
