"""HRLAgent: a high-level controller driving a frozen, pretrained ASE
low-level controller through its latent space (port of
``ase_tpu/learning/hrl_agent.py``).

The high-level action is a ``latent_dim`` vector. One high-level step runs
``llc_steps`` control steps, each acting on the low-level actor's mean for
the normalized latent, clipped to [-1, 1]; the task rewards and the
low-level discriminator's rewards are averaged over the window, and done
and terminate are ORed over it. Training records the window's
discriminator rewards and learns from ``task_reward_w`` x task +
``disc_reward_w`` x discriminator reward (0.9 / 0.1 in the shipped config).

The low-level controller (its ASE network, observation normalizer and AMP
normalizer) comes from ``llc_checkpoint`` through
``checkpoint.restore_subtree``; its widths from ``llc_config``. It is
frozen: no gradient reaches it and the optimizer does not hold it, so the
train state and its checkpoints are the high-level controller's alone, and
a resumed run reloads the LLC from ``llc_checkpoint``. The HLC's ``sigma``
is trained like every other weight, as the reference's optimizer trains
every leaf of its ``HRLNetwork`` (it does not read the config's
``learn_sigma: false`` either).
"""

from __future__ import annotations

import os

import torch
import yaml

from h100_bench.reference.ase_ref.learning import checkpoint
from h100_bench.reference.ase_ref.learning.common_agent import CommonAgent
from h100_bench.reference.ase_ref.learning.running_mean_std import RunningMeanStd
from h100_bench.reference.ase_ref.models import networks
from h100_bench.reference.ase_ref.utils import paths


def _resolve(path: str) -> str:
    """``path`` as given, else relative to the repository root."""
    if os.path.exists(path):
        return path
    return os.path.join(paths.repo_root(), path)


class HRLAgent(CommonAgent):
    def __init__(self, env, cfg_train, output_dir: str = "output", mesh=None):
        config = cfg_train["params"]["config"]
        with open(_resolve(config["llc_config"]), "r") as f:
            self._llc_params_cfg = yaml.safe_load(f)["params"]
        llc_config = self._llc_params_cfg["config"]
        self._latent_dim = int(llc_config["latent_dim"])
        self._llc_steps = int(config["llc_steps"])
        self._task_reward_w = float(config["task_reward_w"])
        self._disc_reward_w = float(config["disc_reward_w"])
        self._disc_reward_scale = float(llc_config.get("disc_reward_scale", 2.0))
        self._task_size = env.get_task_obs_size()
        super().__init__(env, cfg_train, output_dir, mesh)

        self._llc_obs_dim = self.obs_dim - self._task_size
        self._amp_obs_dim = env.amp_obs_size()
        self._llc_network = networks.build_ase_network(
            self._llc_params_cfg, self._llc_obs_dim, env.get_action_size(), self._amp_obs_dim,
            self._latent_dim).to(self.device).requires_grad_(False)
        self._llc_obs_rms = RunningMeanStd((self._llc_obs_dim,)).to(self.device)
        self._llc_amp_rms = RunningMeanStd((self._amp_obs_dim,)).to(self.device)
        llc_checkpoint = config.get("llc_checkpoint", "")
        if not llc_checkpoint:
            raise ValueError("the HRL agent needs a low-level controller: --llc_checkpoint")
        self._load_llc(llc_checkpoint)

    def _load_llc(self, path: str) -> None:
        """The low-level controller's weights and normalizers (strict)."""
        checkpoint.restore_subtree(path, checkpoint.network_leaves(self._llc_network), ".params")
        checkpoint.restore_subtree(path, checkpoint.rms_leaves(self._llc_obs_rms, ""), ".obs_rms")
        checkpoint.restore_subtree(path, checkpoint.rms_leaves(self._llc_amp_rms, ""),
                                   ".extra['amp_rms']")
        print(f"Loaded LLC checkpoint from {path}", flush=True)

    # -- network --------------------------------------------------------------------

    def _actions_num(self) -> int:
        return self._latent_dim

    def _build_network(self):
        return networks.build_hrl_network(self.cfg_train["params"], self.obs_dim,
                                          self._latent_dim)

    def _actor_sigma(self, obs_n, roll):
        return self.network.eval_actor(obs_n)

    def _critic(self, obs_n, roll):
        return self.network.eval_critic(obs_n)

    # -- training: the window's rewards ------------------------------------------------

    def _record_step(self, env_state, roll, rec, infos):
        rec["disc_rewards"] = infos["disc_rewards"]
        return rec

    def _process_rewards(self, batch):
        batch["rewards"] = (self._task_reward_w * batch["rewards"]
                            + self._disc_reward_w * batch["disc_rewards"])
        return batch

    # -- the low-level controller ----------------------------------------------------

    def _compute_llc_action(self, obs, hl_actions):
        """The low-level actor's mean, clipped to [-1, 1], for the humanoid
        part of ``obs`` and the normalized latent ``hl_actions``."""
        llc_obs_n = self._llc_obs_rms.normalize(obs[..., :self._llc_obs_dim])
        mu, _ = self._llc_network.eval_actor(llc_obs_n, networks.normalize_latents(hl_actions))
        return torch.clamp(mu, -1.0, 1.0)

    def _calc_disc_reward(self, amp_obs):
        """(B, 1) the low-level discriminator's style reward."""
        prob = torch.sigmoid(self._llc_network.eval_disc(self._llc_amp_rms.normalize(amp_obs)))
        return -torch.log(torch.clamp(1.0 - prob, min=0.0001)) * self._disc_reward_scale

    @torch.no_grad()
    def _env_step(self, env_state, actions):
        """``llc_steps`` control steps under one latent: the averaged task
        rewards, with the averaged discriminator rewards in the infos, and
        done / terminate ORed over the window."""
        actions = torch.clamp(actions, -1.0, 1.0)
        B = self.num_actors
        rewards = torch.zeros(B, device=self.device)
        disc_rewards = torch.zeros(B, 1, device=self.device)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        term = torch.zeros(B, dtype=torch.bool, device=self.device)
        for _ in range(self._llc_steps):
            llc_actions = self._compute_llc_action(env_state.obs, actions)
            env_state = self.env.step(env_state, llc_actions)
            rewards = rewards + env_state.rew
            done = done | (env_state.reset_buf > 0)
            term = term | (env_state.terminate_buf > 0)
            disc_rewards = disc_rewards + self._calc_disc_reward(self.env.amp_obs_flat(env_state))
        env_state = env_state.replace(reset_buf=done.to(torch.int32),
                                      terminate_buf=term.to(torch.int32))
        return (env_state, rewards / self._llc_steps,
                {"disc_rewards": disc_rewards / self._llc_steps})
