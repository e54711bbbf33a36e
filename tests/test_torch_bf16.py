"""Port parity of the bf16 Delassus path (``SolverConfig.matvec_bf16``,
the default on the card): one engine tick with the bf16 operator and
iterates on both sides.

Tolerance, from bf16 rounding: the Delassus operator A = Z Z^T and each
Jacobi iterate enter the matvec rounded to bf16 (8 significand bits:
relative rounding error <= 2^-9), with float32 accumulation. The two
packages form A's float32 inputs in different summation orders, so an
element that lies within an ulp of a bf16 rounding boundary may round
to neighbouring bf16 values on the two sides: 2^-8 relative of that
element. Such a difference enters every one of the 16 Jacobi iterations
once, so the impulses, and the velocity changes they make, may differ by
up to 16 x 2^-8 = 1/16 of their scale. Velocities and contact forces are
held to 1/16 of their largest magnitude; positions integrate velocities
over h = 1/120 s, so they are held to 1/16 x max|u| / 120. Identical
rounding on both sides gives much less; the test also reports it.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ase_tpu.physics import engine as je
from ase_tpu.physics import solver as jsol
from ase_tpu_torch.physics import engine as te
from ase_tpu_torch.physics.solver import SolverConfig
from tests.test_torch_physics import (  # noqa: F401  (fixtures and the autouse thread pin)
    B, _one_torch_thread, models, random_state, tables)

BF16_REL = 16 * 2.0 ** -8      # 16 Jacobi iterations x one bf16 ulp


def test_one_tick_with_bf16_delassus_matches_reference(models, tables):
    jcfg = je.SimConfig(solver=jsol.SolverConfig(matvec_bf16=True))
    tcfg = te.SimConfig(solver=SolverConfig(matvec_bf16=True))
    assert tcfg.solver.matvec_bf16 and jcfg.solver.matvec_bf16
    js, ts = random_state(models, 21, height=(0.2, 0.6))
    act = np.random.default_rng(21).uniform(-1, 1, size=(B, 31)).astype(np.float32)
    jo = jax.jit(partial(je.step_batched, models[0], jcfg, tables[0]))(js, jnp.asarray(act))
    to = te.step_batched(models[1], tcfg, tables[1], ts, torch.as_tensor(act))
    u_scale = float(np.abs(np.asarray(jo.state.u)).max())
    errs = {}
    for f in ("root_pos", "root_quat", "joint_q", "hinge_q", "u"):
        ref = np.asarray(getattr(jo.state, f), np.float64)
        errs[f] = float(np.abs(ref - getattr(to.state, f).numpy()).max())
        tol = BF16_REL * (u_scale if f == "u" else u_scale / 120.0)
        assert errs[f] <= tol, (f, errs[f], tol)
    ref = np.asarray(jo.contact_forces, np.float64)
    errs["contact_forces"] = float(np.abs(ref - to.contact_forces.numpy()).max())
    assert errs["contact_forces"] <= BF16_REL * float(np.abs(ref).max())
    assert float(np.abs(ref).max()) > 0          # the tick had contacts
    print("bf16 tick errors:", errs, "u scale", u_scale)
