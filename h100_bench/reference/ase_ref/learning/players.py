"""Evaluation players (port of ``ase_tpu/learning/players.py``).

A player restores a checkpoint's weights and normalizers and takes one
policy step at a time (``_policy_step``), the step the benchmark's play
window drives: the env's partial resets, the agent's pre-step hook, the
actor's mean (deterministic) or a sample, the env step. The game loop
(``run``), its printed stats, probes and videos are not copied.
"""

from __future__ import annotations

import torch


class CommonPlayer:
    def __init__(self, agent, deterministic: bool = True):
        self.agent = agent
        self.env = agent.env
        self.deterministic = deterministic

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


class ASEPlayer(CommonPlayer):
    """Latent-conditioned playback (the latent schedule runs inside the
    agent's ``_pre_rollout_step``)."""


class HRLPlayer(CommonPlayer):
    """High-level controller playback: each action is a latent that the
    agent's ``_env_step`` drives through the frozen low-level controller for
    ``llc_steps`` control steps."""
