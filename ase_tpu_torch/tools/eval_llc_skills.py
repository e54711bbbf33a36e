"""Quantitative skill-space evaluation of a low-level controller (port of
``scripts/eval_llc_skills.py``): the ASE paper's claim that a pretrained
LLC spans a diverse, reusable skill space (arXiv:2205.01906, section 6.1).

Three measurements on the LLC checkpoint:

1. latent sweep: N envs of HumanoidAMP, each pinned to one latent for the
   whole rollout (no scheduled resampling): per latent the mean
   discriminator reward (style) and encoder reward (is the latent
   recoverable from the motion it makes?);
2. trajectory diversity: per latent the mean root velocity; its spread
   over the latents (std and mean pairwise distance), also over the
   latents whose mean speed stays under 5 m/s;
3. getup success: HumanoidAMPGetup envs all started from the env's fall
   states, held in a long recovery window; the share of fallen starts
   (root below 0.5 m) whose root rises above 0.65 m in the last 30 steps.

Writes the stats and the per-latent arrays as JSON to ``--out``
(``output/validation_llc_skills.json`` by default) and prints the stats:

  python -m ase_tpu_torch.tools.eval_llc_skills [--envs 256] [--steps 300] \\
      [--getup-envs 512] [--getup-steps 150] [--device cpu]

The latents and the fall-state indices come through ``Evaluator``'s
``_draw_*`` methods, so a test can hand over another package's draws.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from ase_tpu_torch.tools import load_cfg, out_file
from ase_tpu_torch.utils import paths
from ase_tpu_torch.utils.config import torch_device

LLC_FILE = "ase_llc_reallusion_sword_shield.ckpt.npz"     # under data/models
SWEEP_CFG = "humanoid_ase_sword_shield.yaml"
GETUP_CFG = "humanoid_ase_sword_shield_getup.yaml"
STABLE_SPEED = 5.0       # m/s: a latent this fast has destabilised the solver
FALLEN_Z = 0.5           # m: a start below this root height is a fall
RECOVERED_Z = 0.65       # m: ... and one that rises above it got up
TAIL = 30                # steps at the end of the getup rollout that count


def build(task: str, cfg_env: str, num_envs: int, device="cuda"):
    """The env and an ASE agent over the dataset, for evaluation only: the
    training batch (horizon 4, one minibatch) divides at any env count."""
    from ase_tpu_torch.envs import parse_task
    from ase_tpu_torch.learning.ase_agent import ASEAgent

    cfg = load_cfg(cfg_env)
    cfg["env"]["numEnvs"] = num_envs
    cfg["env"]["motion_file"] = paths.default_dataset()
    cfg_train = load_cfg("train/rlg/ase_humanoid.yaml")
    c = cfg_train["params"]["config"]
    c["horizon_length"] = 4
    c["minibatch_size"] = num_envs * 4
    env = parse_task(task, cfg, device=device)
    return env, ASEAgent(env, cfg_train)


@torch.no_grad()
def fixed_latent_rollout(env, agent, z, steps: int, env_state=None, reset_done: bool = True):
    """``steps`` deterministic control steps with env i pinned to latent
    z[i] (``scripts/eval_llc_skills.py:63``). Returns (env state, per-env
    numpy arrays: mean disc and enc rewards, mean root xy velocity (B, 2),
    terminations counted, max root height, final root height, max root
    height over the last TAIL steps). ``reset_done=False`` leaves
    terminated envs rolling in place (the getup eval must not respawn
    them)."""
    if env_state is None:
        env_state = env.initial_state()
    B, dev = z.shape[0], z.device
    disc = torch.zeros(B, device=dev)
    enc = torch.zeros(B, device=dev)
    vel = torch.zeros(B, 2, device=dev)
    falls = torch.zeros(B, device=dev)
    max_z = torch.zeros(B, device=dev)
    root_z = []
    for _ in range(steps):
        if reset_done:
            env_state = env.reset_done(env_state)
        obs_n = agent.obs_rms.normalize(env_state.obs) if agent.normalize_input else env_state.obs
        mu, _ = agent.network.eval_actor(obs_n, z)
        env_state = env.step(env_state, torch.clamp(mu, -1.0, 1.0))
        amp_obs = env.amp_obs_flat(env_state)
        disc = disc + agent._calc_disc_rewards(amp_obs)[:, 0]
        enc = enc + agent._calc_enc_rewards(amp_obs, z)[:, 0]
        vel = vel + env_state.phys.u[:, 0:2]
        # terminations only (falls, contact failures): reset_buf also fires on
        # the episode-length timeout, which would count every latent
        falls = falls + (env_state.terminate_buf > 0).to(torch.float32)
        z_now = env_state.phys.root_pos[:, 2]
        max_z = torch.maximum(max_z, z_now)
        root_z.append(z_now)
    root_z_t = torch.stack(root_z).cpu().numpy()                  # (T, B)
    disc, enc, vel, falls, max_z = (x.cpu().numpy() for x in (disc, enc, vel, falls, max_z))
    return env_state, {
        "disc_reward": disc / steps,
        "enc_reward": enc / steps,
        "mean_vel": vel / steps,
        "fall_count": falls,
        "max_root_z": max_z,
        "final_root_z": root_z_t[-1],
        "tail_max_root_z": root_z_t[-TAIL:].max(axis=0),
    }


def _quantiles(x):
    return {"mean": float(np.mean(x)), "p10": float(np.percentile(x, 10)),
            "p50": float(np.percentile(x, 50)), "p90": float(np.percentile(x, 90))}


def sweep_stats(sweep: dict, steps: int) -> dict:
    """The latent sweep's summary (``scripts/eval_llc_skills.py:150-177``):
    reward quantiles, speed, the spread of the mean velocities over the
    latents, all of them and those under STABLE_SPEED, and the share of
    latents that fell."""
    disc, enc, vel = sweep["disc_reward"], sweep["enc_reward"], sweep["mean_vel"]
    n = vel.shape[0]
    speed = np.linalg.norm(vel, axis=-1)
    d = vel[:, None, :] - vel[None, :, :]
    pair = np.sqrt((d ** 2).sum(-1))
    iu = np.triu_indices(n, 1)
    stable = speed < STABLE_SPEED
    vs, ps = vel[stable], pair[np.ix_(stable, stable)]
    ius = np.triu_indices(int(stable.sum()), 1)
    return {
        "n_latents": n, "steps": steps,
        "disc_reward": _quantiles(disc), "enc_reward": _quantiles(enc),
        "speed": _quantiles(speed),
        "vel_std_over_latents": [float(s) for s in vel.std(axis=0)],
        "mean_pairwise_vel_dist": float(pair[iu].mean()),
        "n_unstable_latents_speed_gt_5": int((~stable).sum()),
        "stable_vel_std_over_latents": [float(s) for s in vs.std(axis=0)],
        "stable_mean_pairwise_vel_dist": float(ps[ius].mean()),
        "fall_frac": float((sweep["fall_count"] > 0).mean()),
    }


def getup_stats(start_z: np.ndarray, getup: dict, steps: int) -> dict:
    """The getup summary (``scripts/eval_llc_skills.py:212-222``)."""
    fallen0 = start_z < FALLEN_Z
    tail = getup["tail_max_root_z"]
    recovered = tail > RECOVERED_Z
    return {
        "n_fall_states": int(fallen0.sum()),
        "recovery_steps": steps,
        "success_rate_tail_root_z_gt_0.65":
            float(recovered[fallen0].mean()) if fallen0.any() else float("nan"),
        "median_start_root_z": float(np.median(start_z[fallen0])),
        "median_tail_max_root_z": float(np.median(tail[fallen0])),
    }


class Evaluator:
    """The three measurements on one LLC checkpoint. Its random numbers
    (the latents and the fall-state indices) come from ``_draw_*`` methods
    on one generator seeded with ``seed``."""

    def __init__(self, llc: Optional[str] = None, device="cuda", seed: int = 0):
        self.llc = llc or paths.data_path("models", LLC_FILE)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)

    def _draw_sweep_latents(self, n: int, dim: int) -> torch.Tensor:
        from ase_tpu_torch.models import networks

        return networks.sample_latents(self.gen, n, dim, self.device)

    def _draw_getup_latents(self, n: int, dim: int) -> torch.Tensor:
        from ase_tpu_torch.models import networks

        return networks.sample_latents(self.gen, n, dim, self.device)

    def _draw_fall_idx(self, n: int, n_fall: int) -> torch.Tensor:
        return torch.randint(0, n_fall, (n,), generator=self.gen, device=self.device)

    def sweep(self, envs: int, steps: int, env=None, agent=None):
        """The latent sweep on HumanoidAMP from its initial reset. Returns
        (stats, per-latent arrays)."""
        if env is None:
            env, agent = build("HumanoidAMP", SWEEP_CFG, envs, self.device)
            agent.restore(self.llc)
        z = self._draw_sweep_latents(envs, agent._latent_dim)
        _, out = fixed_latent_rollout(env, agent, z, steps)
        return sweep_stats(out, steps), out

    def getup_start(self, env, agent, steps: int):
        """The getup rollout's start: the initial reset, then every env on a
        fall state drawn by ``_draw_fall_idx``, progress 0 and the recovery
        window ``steps`` long. Returns (env state, root heights)."""
        st = env.initial_state()
        fs = env._fall_states
        idx = self._draw_fall_idx(env.num_envs, fs.root_pos.shape[0])
        st = env._refresh_kinematics(st.replace(phys=type(fs)(*(x[idx] for x in fs))))
        aux = dict(st.aux)
        if "recovery_counter" in aux:
            aux["recovery_counter"] = torch.full_like(aux["recovery_counter"], steps)
        st = st.replace(progress=torch.zeros_like(st.progress), aux=aux)
        return st, st.phys.root_pos[:, 2].cpu().numpy()

    def getup(self, envs: int, steps: int, fall_states=None, env=None, agent=None):
        """Getup success from the env's fall states (``fall_states``, if
        given, stand in for the 150-tick drop the env would run). Returns
        (stats, the rollout's arrays)."""
        if env is None:
            env, agent = build("HumanoidAMPGetup", GETUP_CFG, envs, self.device)
            agent.restore(self.llc)
        if fall_states is not None:
            env._fall_states = fall_states
        st, start_z = self.getup_start(env, agent, steps)
        z = self._draw_getup_latents(env.num_envs, agent._latent_dim)
        _, out = fixed_latent_rollout(env, agent, z, steps, env_state=st, reset_done=False)
        return getup_stats(start_z, out, steps), out


def main(argv=None, fall_states=None, evaluator: Optional[Evaluator] = None):
    """Run the three measurements; returns the stats. ``fall_states`` (a
    physics state of fall poses on the device) spares the getup env its
    fall-state drop."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--getup-envs", type=int, default=512)
    ap.add_argument("--getup-steps", type=int, default=150)
    ap.add_argument("--llc", type=str, default=paths.data_path("models", LLC_FILE))
    ap.add_argument("--out", type=str, default="output/validation_llc_skills.json")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = torch_device(args.device)
    ev = evaluator or Evaluator(args.llc, dev, args.seed)

    t0 = time.time()
    stats, sweep = ev.sweep(args.envs, args.steps)
    print(f"latent sweep done in {time.time() - t0:.0f}s", flush=True)
    t1 = time.time()
    stats["getup"], _ = ev.getup(args.getup_envs, args.getup_steps, fall_states)
    print(f"getup eval done in {time.time() - t1:.0f}s", flush=True)

    out = {"stats": stats,
           "per_latent": {"disc_reward": sweep["disc_reward"].tolist(),
                          "enc_reward": sweep["enc_reward"].tolist(),
                          "mean_vel": sweep["mean_vel"].tolist()}}
    with open(out_file(args.out), "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(stats, indent=1))
    return stats


if __name__ == "__main__":
    main()
