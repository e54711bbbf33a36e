"""Active contacts per env on a flailing getup workload (port of ``scripts/contact_stats.py``).

Drives HumanoidAMPGetup (``humanoid_ase_sword_shield_getup.yaml``, the
default clip) at ``--envs`` (1024) for ``--steps`` (150) control steps: each
step ``reset_done``, then actions uniform in [-1, 1] from the tool's own
``torch.Generator``, then ``env.step`` (random flailing and ground impacts
make more simultaneous contacts than a trained policy does). The detection
budget is ``--max-contacts`` (64), set as the env config's ``maxContacts``,
so the engine runs its contact solve at m = 3 x 64 columns. After every
step ``active_contacts`` counts, per env, the candidates the solver acts on
(depth > -contact_offset, a penetration or the speculative gap, with a unit
normal). Prints the quantiles of that count and the overflow probability
P(active > K) for the budgets K in 12, 16, 20, 24, 32: the data behind the
shipped ``maxContacts: 24``.

    python -m ase_tpu_torch.tools.contact_stats [--envs 1024] [--steps 150] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ase_tpu_torch.tools import load_cfg
from ase_tpu_torch.utils import paths

QUANTILES = (50, 90, 99, 99.9, 99.99)
BUDGETS = (12, 16, 20, 24, 32)
SEED = 0                         # the env's seed; the actions draw from SEED + 1


def active_contacts(env, phys) -> torch.Tensor:
    """(B,) int64: contacts of ``phys`` (the env's FK and narrow phase at
    its budget) with depth > -contact_offset and |n.n - 1| < 0.1."""
    from ase_tpu_torch.physics import collision3, dynamics2

    T, cfg = env._tables, env.sim_cfg
    margin = cfg.solver.contact_offset
    kin = dynamics2.fk_batched(env.model, T.dyn, phys)
    c = collision3.detect_batched(T.detect, kin.body_quat, kin.body_pos, phys.prop_quat,
                                  phys.prop_pos, cfg.max_contacts, margin=margin)
    unit = torch.abs(torch.sum(torch.square(c.normal), dim=-1) - 1.0) < 0.1
    return torch.sum((c.depth > -margin) & unit, dim=1)


def stats(counts: np.ndarray) -> dict:
    """Quantiles, max and overflow probabilities of the counts."""
    counts = np.asarray(counts).ravel()
    return {"samples": int(counts.size),
            "quantiles": {f"p{q:g}": float(np.percentile(counts, q)) for q in QUANTILES},
            "max": int(counts.max()),
            "overflow": {str(k): float((counts > k).mean()) for k in BUDGETS}}


def main(argv=None, fall_states=None) -> dict:
    """Run the workload; returns ``stats`` of the counts with the run's
    settings. ``fall_states`` (a physics state of fall poses on the
    device) spares the env its fall-state drop."""
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.utils.config import torch_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=1024)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--max-contacts", type=int, default=64, help="the detection budget")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch_device(args.device)

    cfg = load_cfg("humanoid_ase_sword_shield_getup.yaml")
    cfg["env"]["numEnvs"] = args.envs
    cfg["env"]["motion_file"] = paths.default_clip()
    cfg["env"]["maxContacts"] = args.max_contacts
    cfg["seed"] = SEED
    env = parse_task("HumanoidAMPGetup", cfg, device=dev)
    if fall_states is not None:
        env._fall_states = fall_states
    margin = env.sim_cfg.solver.contact_offset
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    state = env.initial_state()
    counts = []
    for _ in range(args.steps):
        state = env.reset_done(state)
        a = torch.rand(args.envs, env.get_action_size(), generator=gen, device=dev) * 2.0 - 1.0
        state = env.step(state, a)
        counts.append(active_contacts(env, state.phys))
    out = stats(torch.stack(counts).cpu().numpy())
    out.update(envs=args.envs, steps=args.steps, max_contacts=args.max_contacts, margin=margin)
    print(f"samples: {out['samples']}  (envs={args.envs} steps={args.steps}, detection budget "
          f"{args.max_contacts}, margin={margin})")
    for k, v in out["quantiles"].items():
        print(f"  {k}: {v:.0f}")
    print(f"  max: {out['max']}")
    for k, p in out["overflow"].items():
        print(f"  overflow P(active > {k}): {p:.5f}", flush=True)
    return out


if __name__ == "__main__":
    main()
