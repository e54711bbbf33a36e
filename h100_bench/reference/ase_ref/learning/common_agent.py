"""The PPO core (port of ``ase_tpu/learning/common_agent.py``).

One training epoch is a ``horizon_length``-step rollout of every env (with
the env's partial resets), GAE over the recorded batch with stored
next-values, masked advantage normalization, and ``mini_epochs`` passes of
minibatch PPO updates, in the reference's order of operations. The losses
are the reference's: clipped surrogate, value MSE times ``critic_coef``,
soft bound loss (soft bound 1.0) times ``bounds_loss_coef``; actor, bound
and entropy terms are means masked by the ε-greedy ``rand_action_mask``.

The rollout runs eagerly on the env's device under ``torch.no_grad()``
(not ``inference_mode``: its tensors feed the update's backward). The
train state lives on the agent: network, Adam state, normalizers, game
meters, epoch and frame counters. Every random number the epoch consumes
comes through one ``_draw_*`` method per consumer, so a test can hand the
port the reference's numbers.

The benchmark's comparison drives the pieces of an epoch one by one
(``reference/follow.py``): the epoch and training loops, checkpoint saving
and profiling are not copied. Data-parallel training (``mesh``) is not
followed either; its hooks stay where the constructor and the update call
them (one process: ``gen`` and ``replicated_gen`` are the same generator).
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Dict

import numpy as np
import torch

from h100_bench.reference.ase_ref.learning import checkpoint
from h100_bench.reference.ase_ref.learning.running_mean_std import RunningMeanStd


class CommonAgent:
    def __init__(self, env, cfg_train: Dict[str, Any], output_dir: str = "output",
                 mesh=None):
        self.env = env
        self.output_dir = output_dir
        self.cfg_train = cfg_train
        config = self.config = cfg_train["params"]["config"]
        self.device = env.device
        self.mesh = mesh
        self.rank, self.world = (mesh.rank, mesh.world) if mesh is not None else (0, 1)
        self.num_actors = env.num_envs          # this rank's envs
        self.horizon_length = int(config["horizon_length"])
        self.minibatch_size = int(config["minibatch_size"])
        self.mini_epochs = int(config["mini_epochs"])
        self.gamma = float(config["gamma"])
        self.tau = float(config["tau"])
        self.e_clip = float(config["e_clip"])
        self.critic_coef = float(config["critic_coef"])
        self.bounds_loss_coef = float(config.get("bounds_loss_coef", 0.0))
        self.entropy_coef = float(config.get("entropy_coef", 0.0))
        self.grad_norm = float(config.get("grad_norm", 1.0))
        self.truncate_grads = bool(config.get("truncate_grads", False))
        self.normalize_input = bool(config.get("normalize_input", True))
        self.normalize_value = bool(config.get("normalize_value", True))
        self.normalize_advantage = bool(config.get("normalize_advantage", True))
        self.learning_rate = float(config["learning_rate"])
        self.lr_schedule = str(config.get("lr_schedule", "constant"))
        self.kl_threshold = float(config.get("kl_threshold", 0.008))
        self.max_epochs = int(config.get("max_epochs", 10000))
        self.games_to_track = int(config.get("games_to_track", 100))
        self.save_frequency = int(config.get("save_frequency", 50))
        self.save_best_after = int(config.get("save_best_after", 50))
        self._save_intermediate = bool(config.get("save_intermediate", False))
        self._best_mean_rewards = -1e9

        self.batch_size = self.horizon_length * self.num_actors * self.world
        self.num_minibatches = self.batch_size // self.minibatch_size
        # the whole-network loss terms (weight decay, logit regularizer): all
        # of them on rank 0, none elsewhere, so the summed gradient has them once
        self._param_share = 1.0 if self.rank == 0 else 0.0

        self.obs_dim = env.get_obs_size()
        self.action_dim = self._actions_num()
        self.obs_rms = RunningMeanStd((self.obs_dim,)).to(self.device)
        self.value_rms = RunningMeanStd((1,)).to(self.device)
        seed = int(cfg_train["params"].get("seed", 0)) + 1
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(seed)
        self.replicated_gen = self.gen
        self.network = self._build_network().to(self.device)
        self.optimizer = None
        self.epoch = 0
        self.frame = 0
        if mesh is not None:
            self._join(mesh, seed)

    def _join(self, mesh, seed: int) -> None:
        """Split the draws per rank. The replicas start equal: the initial
        weights come from the config's seed, which every rank shares."""
        for n in (self.minibatch_size, *self._minibatch_rows().values()):
            if n % self.world:
                raise ValueError(f"minibatch rows {n} do not split over {self.world} ranks")
        self.gen.manual_seed(mesh.rank_seed(seed))
        self.replicated_gen = torch.Generator(device=self.device)
        self.replicated_gen.manual_seed(mesh.replicated_seed(seed))
        self.env.split_draws(mesh.rank_seed(int(self.env.cfg.get("seed", 0))),
                             self.replicated_gen)

    # -- overridables -----------------------------------------------------------

    def _actions_num(self) -> int:
        return self.env.get_action_size()

    def _build_network(self) -> torch.nn.Module:
        raise NotImplementedError

    def _actor_sigma(self, obs_n, roll):
        """(mu, log_sigma) for the normalized obs batch."""
        raise NotImplementedError

    def _critic(self, obs_n, roll):
        raise NotImplementedError

    def _init_rollout_carry(self) -> Dict[str, torch.Tensor]:
        return {}

    def _pre_rollout_step(self, env_state, roll):
        """Per-step hook before action selection (latent updates etc.)."""
        return env_state, roll

    def _env_step(self, env_state, actions):
        """One env transition; returns (env_state, rewards, infos)."""
        env_state = self.env.step(env_state, actions)
        return env_state, env_state.rew, {}

    def _record_step(self, env_state, roll, rec, infos):
        """Extend the per-step record (AMP obs, latents, ...)."""
        return rec

    def _rand_action_mask(self, u_mask):
        return torch.ones(self.num_actors, device=self.device)

    def _post_rollout(self, roll) -> None:
        """Persist rollout-carry state across epochs (ASE latents)."""

    def _process_rewards(self, batch):
        return batch

    def _prepare_extra_dataset(self, batch, dataset):
        return dataset

    def _minibatch_rows(self) -> Dict[str, int]:
        """Fields gathered with only the first N permuted indices."""
        return {}

    def _extra_loss(self, loss, mb, info):
        return loss, info

    def _post_update(self, dataset) -> None:
        """Hook after the minibatch loop (the AMP replay store)."""

    # -- random draws (one method per consumer) ---------------------------------

    def _draw_actions(self, n: int) -> Dict[str, torch.Tensor]:
        """Action noise (n, actions) and the ε-greedy uniform (n,)."""
        return {"noise": torch.randn(n, self.action_dim, generator=self.gen, device=self.device),
                "u_mask": torch.rand(n, generator=self.gen, device=self.device)}

    def _draw_minibatch_perm(self) -> torch.Tensor:
        """One permutation of the (global) batch per mini-epoch."""
        return torch.randperm(self.batch_size, generator=self.replicated_gen, device=self.device)

    # -- train state --------------------------------------------------------------

    def _make_optimizer(self) -> torch.optim.Optimizer:
        return torch.optim.Adam(self.network.parameters(), lr=self.learning_rate, eps=1e-8)

    def init_train_state(self) -> None:
        """Optimizer, game meters and the rollout carry (subclasses add the
        AMP buffers and latents)."""
        if self.batch_size % self.minibatch_size != 0:
            raise ValueError(f"batch {self.batch_size} % minibatch {self.minibatch_size} != 0")
        self.optimizer = self._make_optimizer()
        B, K, dev = self.num_actors * self.world, self.games_to_track, self.device
        self.meters = {
            "cur_rewards": torch.zeros(B, device=dev),
            "cur_lengths": torch.zeros(B, device=dev),
            "game_rewards_buf": torch.zeros(K, device=dev),
            "game_lengths_buf": torch.zeros(K, device=dev),
            "game_success_buf": torch.zeros(K, device=dev),
            "game_head": torch.zeros((), dtype=torch.long, device=dev),
            "game_total": torch.zeros((), device=dev),
        }
        self.roll_state = self._init_rollout_carry()

    # -- checkpoints ------------------------------------------------------------------

    def _weight_leaves(self) -> Dict[str, checkpoint.Leaf]:
        """The policy's weights and normalizers (what a player restores)."""
        leaves = checkpoint.network_leaves(self.network, ".params")
        leaves.update(checkpoint.rms_leaves(self.obs_rms, ".obs_rms"))
        leaves.update(checkpoint.rms_leaves(self.value_rms, ".value_rms"))
        return leaves

    def restore(self, path: str) -> None:
        """Weights and normalizers from a checkpoint of either package, at
        any env count (non-strict: what is missing keeps its value)."""
        checkpoint.restore(path, self._weight_leaves(), strict=False)

    # -- policy math ----------------------------------------------------------------

    def _denorm_value(self, v):
        return self.value_rms.denormalize(v) if self.normalize_value else v

    @staticmethod
    def _neglogp(actions, mu, log_sigma):
        sigma = torch.exp(log_sigma)
        return (0.5 * torch.sum(torch.square((actions - mu) / sigma), dim=-1)
                + 0.5 * math.log(2.0 * math.pi) * actions.shape[-1]
                + torch.sum(log_sigma, dim=-1))

    @staticmethod
    def _entropy(log_sigma):
        return torch.sum(log_sigma + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)

    def _policy_kl(self, mu, log_sigma, old_mu, old_log_sigma):
        """Analytic diagonal-gaussian KL (rl_games torch_ext.policy_kl)."""
        s, so = torch.exp(log_sigma), torch.exp(old_log_sigma)
        kl = (old_log_sigma - log_sigma
              + (torch.square(so) + torch.square(mu - old_mu)) / (2.0 * torch.square(s)) - 0.5)
        return self._row_mean(torch.sum(kl, dim=-1))

    def _row_mean(self, x):
        """The mean of ``x`` over a minibatch's rows; on one of W ranks,
        which holds every W-th row, its share: its sum over all ranks' count."""
        if self.world == 1:
            return torch.mean(x)
        return torch.sum(x) / (x.numel() * self.world)

    def _mask_count(self, mb):
        """The minibatch's ε-greedy mask count (all ranks' rows), at least 1."""
        if self.world == 1:
            return torch.clamp(mb["rand_action_mask"].sum(), min=1.0)
        return torch.clamp(mb["rand_action_mask_sum"], min=1.0)

    def _share_rows(self, x):
        """This rank's rows of a minibatch-row tensor: every W-th from its rank."""
        return x if self.world == 1 else x[self.rank::self.world]

    def _update_game_meters(self, rewards, dones, successes=None) -> None:
        """Windowed episode meters over the last ``games_to_track`` finished
        games; with more than K finishes in one step only the last K land."""
        m, K = self.meters, self.games_to_track
        cur_r = m["cur_rewards"] + rewards
        cur_l = m["cur_lengths"] + 1.0
        fin_rank = torch.cumsum(dones, 0).long() - 1
        n_fin = dones.sum()
        keep = fin_rank >= n_fin.long() - K
        pos = torch.where((dones > 0) & keep, (m["game_head"] + fin_rank) % K,
                          torch.full_like(fin_rank, K))

        def drop_scatter(buf, vals):
            out = torch.cat([buf, buf.new_zeros(1)])
            out[pos] = vals
            return out[:K]

        m["game_rewards_buf"] = drop_scatter(m["game_rewards_buf"], cur_r)
        m["game_lengths_buf"] = drop_scatter(m["game_lengths_buf"], cur_l)
        if successes is not None:
            m["game_success_buf"] = drop_scatter(m["game_success_buf"], successes)
        m["game_head"] = (m["game_head"] + n_fin.long()) % K
        m["game_total"] = m["game_total"] + n_fin
        m["cur_rewards"] = cur_r * (1.0 - dones)
        m["cur_lengths"] = cur_l * (1.0 - dones)

    # -- rollout ----------------------------------------------------------------------

    def _discount_values(self, dones, values, rewards, next_values):
        """GAE over T, newest step first."""
        advs = torch.empty_like(values)
        lastgaelam = torch.zeros_like(values[0])
        for t in reversed(range(values.shape[0])):
            not_done = (1.0 - dones[t])[:, None]
            delta = rewards[t] + self.gamma * next_values[t] - values[t]
            lastgaelam = delta + self.gamma * self.tau * not_done * lastgaelam
            advs[t] = lastgaelam
        return advs

    @staticmethod
    def _normalize_adv(advantages, mask):
        """Masked advantage normalization (torch_ext.normalization_with_masks)."""
        msum = torch.clamp(mask.sum(), min=1.0)
        mean = torch.sum(advantages * mask) / msum
        var = torch.sum(mask * torch.square(advantages - mean)) / msum
        return (advantages - mean) / (torch.sqrt(var) + 1e-8)

    def _prepare_dataset(self, batch):
        def flat(x):
            return x.reshape((self.batch_size,) + tuple(x.shape[2:]))

        values, returns = flat(batch["values"]), flat(batch["returns"])
        advantages = torch.sum(returns - values, dim=1)
        rmask = flat(batch["rand_action_mask"])
        if self.normalize_advantage:
            advantages = self._normalize_adv(advantages, rmask)
        if self.normalize_value:
            self.value_rms.update(values).update(returns)
            values = self.value_rms.normalize(values, clip=math.inf)
            returns = self.value_rms.normalize(returns, clip=math.inf)
        # obs stay raw: each minibatch updates obs_rms and normalizes with it
        dataset = {"obs_n": flat(batch["obs"]), "actions": flat(batch["actions"]),
                   "neglogp": flat(batch["neglogp"]), "values": values, "returns": returns,
                   "advantages": advantages, "mu": flat(batch["mu"]),
                   "sigma": flat(batch["sigma"]), "rand_action_mask": rmask}
        return self._prepare_extra_dataset(batch, dataset)

    # -- losses ---------------------------------------------------------------------

    def _actor_loss(self, old_neglogp, neglogp, advantage):
        ratio = torch.exp(old_neglogp - neglogp)
        surr1 = advantage * ratio
        surr2 = advantage * torch.clamp(ratio, 1.0 - self.e_clip, 1.0 + self.e_clip)
        a_loss = torch.maximum(-surr1, -surr2)
        clipped = (torch.abs(ratio - 1.0) > self.e_clip).to(torch.float32)
        return a_loss, clipped

    def _bound_loss(self, mu):
        if self.bounds_loss_coef == 0:
            return torch.zeros(mu.shape[:-1], device=mu.device)
        hi = torch.square(torch.clamp(mu - 1.0, min=0.0))
        lo = torch.square(torch.clamp(mu + 1.0, max=0.0))
        return torch.sum(hi + lo, dim=-1)

    def _loss(self, mb):
        """Minibatch loss and its info; subclasses extend via _extra_loss."""
        obs_n = mb["obs_n"]
        mu, log_sigma = self._actor_sigma(obs_n, mb)
        values = self._critic(obs_n, mb)
        neglogp = self._neglogp(mb["actions"], mu, log_sigma)
        a_loss, a_clipped = self._actor_loss(mb["neglogp"], neglogp, mb["advantages"])
        c_loss = torch.square(mb["returns"] - values)
        b_loss = self._bound_loss(mu)
        entropy = self._entropy(log_sigma)

        rmask = mb["rand_action_mask"]
        rsum = self._mask_count(mb)
        a_loss_m = torch.sum(rmask * a_loss) / rsum
        b_loss_m = torch.sum(rmask * b_loss) / rsum
        ent_m = torch.sum(rmask * entropy) / rsum
        c_loss_m = self._row_mean(c_loss)
        loss = (a_loss_m + self.critic_coef * c_loss_m - self.entropy_coef * ent_m
                + self.bounds_loss_coef * b_loss_m)
        info = {"a_loss": a_loss_m, "c_loss": c_loss_m, "b_loss": b_loss_m, "entropy": ent_m,
                "clip_frac": torch.sum(rmask * a_clipped) / rsum, "mu": mu, "sigma": log_sigma}
        return self._extra_loss(loss, mb, info)

    # -- update -----------------------------------------------------------------------

    def _preproc_minibatch(self, mb):
        """Per-minibatch normalizer updates (rl_games train-mode forwards)."""
        if self.normalize_input:
            mb = dict(mb)
            mb["obs_n"] = self.obs_rms.update(mb["obs_n"]).normalize(mb["obs_n"])
        return mb

    def _gather_minibatch(self, dataset, idx):
        rows = self._minibatch_rows()
        return {k: (v[idx] if k not in rows else v[idx[:rows[k]]]) for k, v in dataset.items()}

    def _adapt_lr(self, kl: float) -> None:
        """KL-threshold LR adaptation (rl_games AdaptiveScheduler: /1.5 when
        KL > 2·threshold, ×1.5 when KL < threshold/2, within [1e-6, 1e-2])."""
        for g in self.optimizer.param_groups:
            lr = g["lr"]
            if kl > 2.0 * self.kl_threshold:
                lr = max(lr / 1.5, 1e-6)
            if kl < 0.5 * self.kl_threshold:
                lr = min(lr * 1.5, 1e-2)
            g["lr"] = lr

    def _update_minibatch(self, mb) -> Dict[str, torch.Tensor]:
        """One minibatch: normalizer updates, loss, backward, Adam step.
        Returns the scalar infos, the policy KL and the loss (on device).
        On one of several ranks the normalizers update on every row, the
        loss takes this rank's rows, and the gradients and infos are summed
        over the ranks before the step."""
        mb = self._preproc_minibatch(mb)
        if self.mesh is not None:
            count = mb["rand_action_mask"].sum()
            mb = {k: self._share_rows(v) for k, v in mb.items()}
            mb["rand_action_mask_sum"] = count
        loss, info = self._loss(mb)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        with torch.no_grad():
            kl = self._policy_kl(info["mu"], info["sigma"], mb["mu"], mb["sigma"])
        metrics = {k: v.detach() for k, v in info.items() if v.dim() == 0}
        metrics["kl"] = kl
        metrics["loss"] = loss.detach()
        if self.mesh is not None:
            metrics = self._all_reduce_grads(metrics)
        if self.truncate_grads:
            torch.nn.utils.clip_grad_norm_(self.network.parameters(), self.grad_norm)
        self.optimizer.step()
        if self.lr_schedule == "adaptive":
            self._adapt_lr(float(metrics["kl"]))
        return metrics

    @torch.no_grad()
    def _all_reduce_grads(self, metrics):
        """Sum the gradients and the scalar ``metrics`` over the ranks in
        one all-reduce; returns the summed metrics."""
        params = [p for p in self.network.parameters() if p.grad is not None]
        names = sorted(metrics)
        flat = self.mesh.all_reduce_sum(torch.cat(
            [p.grad.reshape(-1) for p in params]
            + [torch.stack([metrics[k].to(torch.float32) for k in names])]))
        at = 0
        for p in params:
            p.grad.copy_(flat[at:at + p.numel()].view_as(p.grad))
            at += p.numel()
        return dict(zip(names, flat[at:]))

    # -- epochs ---------------------------------------------------------------------------


