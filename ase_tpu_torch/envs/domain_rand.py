"""Domain randomization (port of ``ase_tpu/envs/domain_rand.py``).

The ``task.randomization_params`` block of an env config, as the
reference reads it:

* scheduled (constant or linear-ramp) gaussian or uniform noise on
  observations and actions, additive or scaling;
* per-env physics knobs resampled at reset every ``frequency`` resets of
  an env: friction per shape ``(B, nb + np)``, mass per body ``(B, nb)``,
  stiffness and damping per dof ``(B, nd)``, and per env the actor's
  geometric scale, gravity and the plane's restitution; a ``setup_only``
  knob is drawn once, at an env's first reset;
* an ``actor_params_generator`` (``cfg.task.actor_params_generator``, set
  in code): a callable ``(gen: torch.Generator, n) -> {knob: (n,) or
  (n, k) tensor}`` whose samples override the knobs it names on every due
  resample.

Nothing here draws: the env draws the unit numbers (standard normals, or
uniforms on [0, 1)) through its ``_draw_*`` methods and hands them in, so
a caller can substitute the numbers of another random stream. The knob
state is a flat dict of per-env tensors plus a 0-d ``step_count``, the
global control-step counter that drives the schedules.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

KNOBS = ("friction_scale", "mass_scale", "stiffness_scale", "damping_scale",
         "gravity_scale", "restitution", "actor_scale")


class NoiseSpec:
    """One ``{range, operation, distribution, schedule, schedule_steps,
    setup_only}`` entry."""

    def __init__(self, cfg: Dict[str, Any]):
        self.lo, self.hi = [float(x) for x in cfg.get("range", [0.0, 0.0])]
        self.operation = cfg.get("operation", "additive")
        self.distribution = cfg.get("distribution", "gaussian")
        self.schedule = cfg.get("schedule", None)
        self.schedule_steps = int(cfg.get("schedule_steps", 1))
        self.setup_only = bool(cfg.get("setup_only", False))

    def ramp(self, step_count: torch.Tensor) -> torch.Tensor:
        """The schedule's scale at ``step_count``: min(step / steps, 1) for
        a linear ramp, else 1."""
        if self.schedule == "linear":
            return torch.clamp(step_count / float(max(self.schedule_steps, 1)), max=1.0)
        return torch.ones_like(step_count)

    def apply(self, unit: torch.Tensor, x: torch.Tensor, step_count: torch.Tensor) -> torch.Tensor:
        """``x`` with noise made from ``unit``: standard normals for a
        gaussian spec, uniforms on [0, 1) for a uniform one."""
        s = self.ramp(step_count)
        if self.distribution == "gaussian":
            noise = self.lo + (self.hi * s) * unit
        else:
            if self.operation == "additive":
                lo, hi = self.lo * s, self.hi * s
            else:
                lo, hi = 1.0 + (self.lo - 1.0) * s, 1.0 + (self.hi - 1.0) * s
            noise = torch.maximum(lo, unit * (hi - lo) + lo)
        return x * noise if self.operation == "scaling" else x + noise


class DomainRandomizer:
    """The parsed block; ``enabled`` is False without one."""

    def __init__(self, cfg: Optional[Dict[str, Any]], generator: Optional[Callable] = None):
        cfg = cfg or {}
        self.enabled = bool(cfg)
        self.generator = generator
        self.frequency = int(cfg.get("frequency", 600))
        self.obs_spec = NoiseSpec(cfg["observations"]) if "observations" in cfg else None
        self.act_spec = NoiseSpec(cfg["actions"]) if "actions" in cfg else None
        actor = cfg.get("actor_params", {}).get("humanoid", {})
        rb = actor.get("rigid_body_properties", {})
        rs = actor.get("rigid_shape_properties", {})
        dof = actor.get("dof_properties", {})
        sim = cfg.get("sim_params", {})
        specs = {"friction_scale": rs.get("friction"), "mass_scale": rb.get("mass"),
                 "stiffness_scale": dof.get("stiffness"), "damping_scale": dof.get("damping"),
                 "gravity_scale": sim.get("gravity"), "restitution": rs.get("restitution"),
                 "actor_scale": actor.get("scale")}
        # the knobs that are sampled, in the reference's key order
        self.specs = {k: NoiseSpec(v) for k, v in specs.items() if v is not None}

    # -- per-step noise --------------------------------------------------------------

    def randomize_actions(self, unit, actions, step_count):
        return self.act_spec.apply(unit, actions, step_count) if self.act_spec else actions

    def randomize_observations(self, unit, obs, step_count):
        return self.obs_spec.apply(unit, obs, step_count) if self.obs_spec else obs

    # -- per-env knobs ------------------------------------------------------------------

    def init_scales(self, B: int, base_restitution: float, num_bodies: int, num_shapes: int,
                    num_dofs: int, device) -> Dict[str, torch.Tensor]:
        """Every knob at its base: scales 1, the plane's restitution;
        ``dr_count`` 0 resets per env and ``step_count`` 0."""
        self.base_restitution = float(base_restitution)

        def ones(*shape):
            return torch.ones(*shape, device=device)

        return {
            "friction_scale": ones(B, num_shapes),
            "mass_scale": ones(B, num_bodies),
            "actor_scale": ones(B),
            "stiffness_scale": ones(B, num_dofs),
            "damping_scale": ones(B, num_dofs),
            "gravity_scale": ones(B),
            "restitution": torch.full((B,), self.base_restitution, device=device),
            "dr_count": torch.zeros(B, dtype=torch.int32, device=device),
            "step_count": torch.zeros((), device=device),
        }

    def tick(self, scales: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {**scales, "step_count": scales["step_count"] + 1.0}

    def resample_scales(self, units: Dict[str, torch.Tensor], scales: Dict[str, torch.Tensor],
                        mask: torch.Tensor, generated: Optional[Dict[str, torch.Tensor]] = None
                        ) -> Dict[str, torch.Tensor]:
        """Knobs redrawn for the envs in ``mask`` whose reset count is a
        multiple of ``frequency`` (``setup_only`` knobs: whose count is 0),
        from ``units`` (one unit draw per sampled knob, at its shape), and
        ``generated`` (the generator's samples) over them; restitution
        clipped to [0, 1], the actor scale to [0.1, 10]. ``dr_count``
        counts the envs' resets."""
        step_count = scales["step_count"]
        due = mask & (scales["dr_count"] % max(self.frequency, 1) == 0)
        due_setup = mask & (scales["dr_count"] == 0)
        out = dict(scales)

        def col(d, cur):
            return d.reshape(d.shape + (1,) * (cur.dim() - 1))

        for knob, spec in self.specs.items():
            cur = scales[knob]
            if knob == "restitution":
                base = torch.full_like(cur, self.base_restitution)
            else:
                base = torch.ones_like(cur)
            d = due_setup if spec.setup_only else due
            v = torch.where(col(d, cur), spec.apply(units[knob], base, step_count), cur)
            if knob == "restitution":
                v = torch.clamp(v, 0.0, 1.0)
            elif knob == "actor_scale":
                v = torch.clamp(v, 0.1, 10.0)
            out[knob] = v
        for knob, v in (generated or {}).items():
            if knob not in KNOBS:
                raise KeyError(f"actor_params_generator produced unknown property {knob!r}")
            cur = scales[knob]
            v = v.reshape(v.shape + (1,) * (cur.dim() - v.dim()))
            out[knob] = torch.where(col(due, cur), v.expand_as(cur), cur)
        out["dr_count"] = scales["dr_count"] + mask.to(torch.int32)
        return out
