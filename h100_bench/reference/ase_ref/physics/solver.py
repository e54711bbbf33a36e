"""The contact solver's settings (port of ``ase_tpu/physics/solver.py``).
The solve itself, projected block-Jacobi in the component-grouped Z-form,
is ``physics/solver2.py``'s; the reference follows no configuration that
runs the sequential ``pgs`` scheme, so its solver is not copied here.
"""

from __future__ import annotations

from typing import NamedTuple

SCHEMES = ("jacobi", "pgs")


class SolverConfig(NamedTuple):
    iterations: int = 16
    relaxation: float = 0.35           # Jacobi under-relaxation
    scheme: str = "jacobi"             # "jacobi" | "pgs"
    baumgarte: float = 0.2
    slop: float = 0.002
    max_depenetration_velocity: float = 10.0
    impulse_cap_velocity: float = 25.0
    regularization: float = 1e-6
    matvec_bf16: bool = True           # bf16 Delassus product and matvec,
                                       # f32 accumulation (the reference default)
    contact_offset: float = 0.02


def check_scheme(scheme: str) -> None:
    """Raise on a scheme other than ``SCHEMES`` (the reference runs PGS for
    any string but "jacobi")."""
    if scheme not in SCHEMES:
        raise ValueError(f"unknown contact solver scheme {scheme!r}; known: {SCHEMES}")


