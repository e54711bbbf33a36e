"""Evaluation players (port of ``ase_tpu/learning/players.py``).

A player restores a checkpoint's weights and normalizers and plays
``games_num`` episodes in chunks of ``num_steps`` policy steps, printing
per-game-batch stats as the reference does. Each chunk keeps its tallies on
the device (finished games, their returns and lengths, end-of-episode
successes and in-episode success-time fractions) and reads them back once.
A step's success is ``success_fn(env_state)`` when given, else the task's
``aux['successes']`` when it publishes one. With ``debug_probes`` each
chunk ends with the model probes of env 0's live state: the AMP
discriminator's logit and reward, the ASE encoder reward, the HRL
low-level controller's discriminator reward. ``AMPPlayer``, ``ASEPlayer``
and ``HRLPlayer`` differ only in their probes: the latent schedule and the
HRL window run inside the agent's ``_pre_rollout_step`` and ``_env_step``.
With ``video_path``, each player step (an HRL decision for the HRL player)
keeps one env's body positions and task markers on the device; they are
copied to the host once per chunk with the tallies and rendered to a video
at the end.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch


class CommonPlayer:
    def __init__(self, agent, deterministic: bool = True, games_num: Optional[int] = None,
                 debug_probes: bool = False, print_stats: bool = True):
        self.agent = agent
        self.env = agent.env
        self.deterministic = deterministic
        pcfg = agent.config.get("player", {}) or {}
        self.games_num = int(games_num if games_num is not None
                             else pcfg.get("games_num", 2000))
        self.debug_probes = bool(debug_probes)
        self.print_stats = print_stats
        self.env_state = None
        self.roll = None
        self.last_actions = None
        self.last_rewards = None

    def restore(self, path: str) -> None:
        self.agent.restore(path)

    @torch.no_grad()
    def _policy_step(self, env_state, roll):
        agent = self.agent
        env_state = self.env.reset_done(env_state)
        env_state, roll = agent._pre_rollout_step(env_state, roll)
        obs_n = agent.obs_rms.normalize(env_state.obs) if agent.normalize_input else env_state.obs
        mu, log_sigma = agent._actor_sigma(obs_n, roll)
        if self.deterministic:
            actions = mu
        else:
            noise = torch.randn(mu.shape, generator=agent.gen, device=mu.device)
            actions = mu + torch.exp(log_sigma) * noise
        env_state, rewards, _ = agent._env_step(env_state, actions)
        return env_state, roll, rewards, actions

    _MARKER_KEYS = ("tar_dir", "tar_facing_dir", "tar_pos")

    def _frame(self, env_state, env_id: int) -> Dict[str, torch.Tensor]:
        """Env ``env_id``'s body positions and task markers (device copies)."""
        frame = {"body_pos": env_state.body_pos[env_id].clone()}
        for k in self._MARKER_KEYS:
            if k in env_state.aux:
                frame[k] = env_state.aux[k][env_id].clone()
        return frame

    def _probe(self, env_state, roll) -> Dict[str, torch.Tensor]:
        """Model diagnostics on env 0's live state (0-d tensors); the AMP,
        ASE and HRL players add theirs."""
        return {}

    @torch.no_grad()
    def run(self, num_steps: int = 300, games_num: Optional[int] = None, env_state=None,
            max_chunks: int = 100,
            success_fn: Optional[Callable[[object], torch.Tensor]] = None,
            video_path: Optional[str] = None, video_env: int = 0,
            video_max_frames: int = 900):
        """Play until ``games_num`` episodes finish (at most ``max_chunks``
        chunks of ``num_steps`` steps); returns the aggregate stats, with
        ``success_rate`` (end-of-episode successes per game),
        ``success_time_frac`` (the mean in-episode share of successful
        steps) and, with ``debug_probes``, the last chunk's probes.

        With ``video_path``, env ``video_env``'s body positions (and any
        heading/location/strike task markers) after each step, at most
        ``video_max_frames`` of them, are rendered to that file at the end
        (``viz.plotter.render_rollout``: mp4, or gif without OpenCV)."""
        games_num = int(games_num if games_num is not None else self.games_num)
        if env_state is None:
            env_state = self.env.initial_state()
        roll = self.agent._init_rollout_carry()
        B, dev = self.env.num_envs, self.env.device
        ret = torch.zeros(B, device=dev)
        lens = torch.zeros(B, dtype=torch.int32, device=dev)
        succ = torch.zeros(B, device=dev)
        games, sums = 0, [0.0, 0.0, 0.0, 0.0]   # returns, lengths, end successes, time fracs
        probes: Dict[str, float] = {}
        captured = []

        def done_sum(done, x):
            return torch.where(done, x, torch.zeros_like(x)).sum().to(torch.float32)

        for _ in range(max_chunks):
            tallies, frames = [], []
            capture = video_path is not None and len(captured) * num_steps < video_max_frames
            for _ in range(num_steps):
                env_state, roll, rewards, actions = self._policy_step(env_state, roll)
                if capture:
                    frames.append(self._frame(env_state, video_env))
                ret = ret + rewards
                lens = lens + 1
                if success_fn is not None:
                    s = success_fn(env_state).to(torch.float32)
                else:
                    s = env_state.aux.get("successes", torch.zeros_like(ret))
                succ = succ + s
                done = env_state.reset_buf > 0
                tallies.append(torch.stack([
                    done.sum().to(torch.float32), done_sum(done, ret), done_sum(done, lens),
                    done_sum(done, s), done_sum(done, succ / torch.clamp(lens, min=1))]))
                ret = torch.where(done, torch.zeros_like(ret), ret)
                lens = torch.where(done, torch.zeros_like(lens), lens)
                succ = torch.where(done, torch.zeros_like(succ), succ)
            if capture:
                captured.append({k: torch.stack([f[k] for f in frames]).cpu().numpy()
                                 for k in frames[0]})
            for c, *vals in torch.stack(tallies).cpu().tolist():
                if c > 0:
                    games += int(c)
                    sums = [a + b for a, b in zip(sums, vals)]
                    if self.print_stats:
                        print(f"reward: {vals[0] / c:.4f} steps: {vals[1] / c:.1f}")
                    if games >= games_num:
                        break
            if self.debug_probes:
                p = self._probe(env_state, roll)
                probes = dict(zip(p, torch.stack(list(p.values())).cpu().tolist())) if p else {}
                print("probe: " + " ".join(f"{k}: {v:.4f}" for k, v in probes.items()))
            if games >= games_num:
                break

        if captured:
            from ase_tpu_torch.viz.plotter import render_rollout

            merged = {k: np.concatenate([c[k] for c in captured])[:video_max_frames]
                      for k in captured[0]}
            written = render_rollout(
                self.env.model.parents, merged.pop("body_pos"), markers=merged,
                fps=1.0 / float(self.env.dt), save_path=video_path,
                title=self.agent.config.get("name", ""))
            print(f"rollout video written: {written}")

        self.env_state, self.roll = env_state, roll
        self.last_actions, self.last_rewards = actions, rewards
        n = max(games, 1)
        stats = {"mean_return": sums[0] / n, "mean_length": sums[1] / n, "episodes": games,
                 "running_return_mean": float(ret.mean()), "success_rate": sums[2] / n,
                 "success_time_frac": sums[3] / n, **probes}
        print(f"av reward: {stats['mean_return']:.4f} av steps: {stats['mean_length']:.1f} "
              f"episodes: {games}")
        return stats


class AMPPlayer(CommonPlayer):
    """Adds the discriminator's logit and reward on env 0's AMP observation."""

    def disc_reward(self, env_state) -> torch.Tensor:
        """(B, 1) discriminator rewards of the live AMP observations."""
        return self.agent._calc_disc_rewards(self.env.amp_obs_flat(env_state))

    def _probe(self, env_state, roll):
        out = super()._probe(env_state, roll)
        amp_obs = self.env.amp_obs_flat(env_state)[0:1]
        out["disc_pred"] = self.agent.network.eval_disc(self.agent._norm_amp(amp_obs))[0, 0]
        out["disc_reward"] = self.agent._calc_disc_rewards(amp_obs)[0, 0]
        return out


class ASEPlayer(AMPPlayer):
    """Latent-conditioned playback; the probe adds the encoder reward of
    env 0 under its current latent."""

    def enc_reward(self, env_state, latents) -> torch.Tensor:
        return self.agent._calc_enc_rewards(self.env.amp_obs_flat(env_state), latents)

    def _probe(self, env_state, roll):
        out = super()._probe(env_state, roll)
        amp_obs = self.env.amp_obs_flat(env_state)[0:1]
        out["enc_reward"] = self.agent._calc_enc_rewards(amp_obs, roll["ase_latents"][0:1])[0, 0]
        return out


class HRLPlayer(CommonPlayer):
    """High-level controller playback: each action is a latent that the
    agent's ``_env_step`` drives through the frozen low-level controller for
    ``llc_steps`` control steps; the probe is that controller's
    discriminator reward on env 0."""

    def _probe(self, env_state, roll):
        out = super()._probe(env_state, roll)
        amp_obs = self.env.amp_obs_flat(env_state)[0:1]
        out["llc_disc_reward"] = self.agent._calc_disc_reward(amp_obs)[0, 0]
        return out


PLAYER_REGISTRY = {"common": CommonPlayer, "amp": AMPPlayer, "ase": ASEPlayer,
                   "hrl": HRLPlayer}
