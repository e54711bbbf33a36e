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

``train`` resumes from a checkpoint (strict, in the reference's npz
layout: ``ckpt_leaves``), writes TensorBoard scalars when given a writer,
and saves ``{name}.ckpt.npz`` every ``save_frequency`` epochs (with
``save_intermediate`` also ``{name}_{epoch:08d}.ckpt.npz``, buffers
included), ``{name}_best.ckpt.npz`` when the windowed game reward beats
its best after ``save_best_after`` epochs, and ``{name}.ckpt.npz`` at the
end, all under ``output_dir``; with ``ASE_TPU_PROFILE=<epoch>`` that epoch
runs under torch.profiler and its Chrome trace lands in
``<output_dir>/profile/``. Unless ``save_buffers`` is set, checkpoints
leave out the reconstructible demo and replay buffers.

Data-parallel training (``mesh``, a ``parallel.mesh.Mesh`` of W ranks)
runs the reference's global program, up to float32 reduction order: rank r
steps env rows [r B/W, (r + 1) B/W) of the global B envs, and ``batch_size``
and the minibatches are global. Per-env draws (actions, latents, the env's
resets) come from ``gen``, seeded per rank; replicated draws (minibatch
permutations, buffer cursors, replay keeps, diversity latents, the env's
demo windows) from ``replicated_gen``, seeded alike on every rank and
touched only by code every rank runs alike (one process: the same
generator). After the rollout the batch is gathered into the global (T, B)
layout and the dataset, the normalizers, the buffers and the game meters
are computed on it by every rank. Each minibatch's normalizer updates run
on all its rows; each rank then takes the gradient of every W-th row
(``_row_mean``: its share of the global means; whole-network terms count on
rank 0 only) and one all-reduce sums gradients and scalar infos, so Adam
steps alike everywhere and the replicas stay bit-equal, which each epoch
checks. Rank 0 alone prints the epoch lines and writes the checkpoints;
per-env leaves of a checkpoint are gathered, so it resumes at any W.
"""

from __future__ import annotations

import math
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ase_tpu_torch.learning import checkpoint
from ase_tpu_torch.learning.running_mean_std import RunningMeanStd


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

    def setup_training(self):
        """Train state, then the env's initial state (the reference's order)."""
        self.init_train_state()
        return self.env.initial_state()

    # -- checkpoints ------------------------------------------------------------------

    def _weight_leaves(self) -> Dict[str, checkpoint.Leaf]:
        """The policy's weights and normalizers (what a player restores)."""
        leaves = checkpoint.network_leaves(self.network, ".params")
        leaves.update(checkpoint.rms_leaves(self.obs_rms, ".obs_rms"))
        leaves.update(checkpoint.rms_leaves(self.value_rms, ".value_rms"))
        return leaves

    def ckpt_leaves(self) -> Dict[str, checkpoint.Leaf]:
        """The train state as checkpoint leaves in the reference's layout;
        needs ``init_train_state``. The best-reward watermark is read when a
        checkpoint is written (the reference's ``_stamp_best``)."""
        leaves = self._weight_leaves()
        # where optax keeps the Adam state: chain(clip, adam) with
        # truncate_grads, inject_hyperparams(adam) with the adaptive schedule
        opt = ".opt_state[1]" if self.truncate_grads else ".opt_state"
        if self.lr_schedule == "adaptive":
            groups = self.optimizer.param_groups

            def set_lr(a):
                for g in groups:
                    g["lr"] = float(a)

            leaves[opt + ".hyperparams['learning_rate']"] = checkpoint.Leaf(
                (), lambda: np.asarray(groups[0]["lr"], np.float32), set_lr)
            opt += ".inner_state"
        leaves.update(checkpoint.adam_leaves(self.optimizer, self.network, opt + "[0]"))
        leaves[".epoch"] = checkpoint.number_leaf(self, "epoch", np.int32)
        leaves[".frame"] = checkpoint.number_leaf(self, "frame", np.int32)
        for k in self.meters:
            leaves[f".extra['{k}']"] = checkpoint.slot_leaf(self.meters, k)
        leaves[".extra['best_mean_rewards']"] = checkpoint.number_leaf(
            self, "_best_mean_rewards", np.float32)
        leaves[checkpoint.GENERATOR_KEY] = checkpoint.generator_leaf(self.replicated_gen)
        return leaves

    def _env_rows_leaf(self, box, name: str) -> checkpoint.Leaf:
        """A per-env tensor ``box[name]`` of this rank's envs as the leaf of
        all B envs (gathered on every rank)."""
        if self.mesh is None:
            return checkpoint.slot_leaf(box, name)
        return checkpoint.rows_leaf(box, name, self.mesh)

    def _transient_extra(self) -> tuple:
        """Key substrings of reconstructible state left out of checkpoints."""
        return ()

    def _ckpt_exclude(self) -> tuple:
        if bool(self.config.get("save_buffers", False)):
            return ()
        return self._transient_extra()

    def save(self, path: str, exclude: Optional[tuple] = None) -> str:
        """Write the train state (less ``_ckpt_exclude`` unless ``exclude``
        is given) to ``path`` + ``.npz``; returns the file's path. Every
        rank calls it (per-env leaves are gathered); rank 0 writes."""
        return checkpoint.save(path, self.ckpt_leaves(),
                               self._ckpt_exclude() if exclude is None else exclude,
                               write=self.rank == 0)

    def restore(self, path: str) -> None:
        """Weights and normalizers from a checkpoint of either package, at
        any env count (non-strict: what is missing keeps its value)."""
        checkpoint.restore(path, self._weight_leaves(), strict=False)

    def resume(self, path: str) -> None:
        """Strict restore of the whole train state after ``setup_training``:
        only the excluded buffers, the fields newer than the reference's
        format and the port's own generator state may be missing. Epoch
        counting continues from the checkpoint's."""
        new_fields = ("best_mean_rewards", "game_success_buf", checkpoint.GENERATOR_KEY)
        checkpoint.restore(path, self.ckpt_leaves(), strict=True,
                           allow_missing=self._ckpt_exclude() + new_fields)
        print(f"resumed from {path} at epoch {self.epoch}", flush=True)

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

    @torch.no_grad()
    def _rollout(self, env_state):
        T, B = self.horizon_length, self.num_actors
        roll = dict(self.roll_state)
        batch: Dict[str, torch.Tensor] = {}
        for t in range(T):
            env_state = self.env.reset_done(env_state)
            env_state, roll = self._pre_rollout_step(env_state, roll)
            obs = env_state.obs
            obs_n = self.obs_rms.normalize(obs) if self.normalize_input else obs
            d = self._draw_actions(B)
            mu, log_sigma = self._actor_sigma(obs_n, roll)
            value = self._denorm_value(self._critic(obs_n, roll))
            sampled = mu + torch.exp(log_sigma) * d["noise"]
            rand_mask = self._rand_action_mask(d["u_mask"])
            actions = torch.where(rand_mask[:, None] > 0, sampled, mu)
            neglogp = self._neglogp(actions, mu, log_sigma)

            env_state, rewards, infos = self._env_step(env_state, actions)
            dones = env_state.reset_buf.to(torch.float32)
            terminated = env_state.terminate_buf.to(torch.float32)

            next_obs_n = (self.obs_rms.normalize(env_state.obs) if self.normalize_input
                          else env_state.obs)
            next_value = self._denorm_value(self._critic(next_obs_n, roll))
            next_value = next_value * (1.0 - terminated[:, None])
            rec = {"obs": obs, "actions": actions, "mu": mu, "sigma": log_sigma,
                   "neglogp": neglogp, "values": value, "rewards": rewards[:, None],
                   "dones": dones, "next_values": next_value, "rand_action_mask": rand_mask}
            if "successes" in env_state.aux:
                rec["successes"] = env_state.aux["successes"]
            rec = self._record_step(env_state, roll, rec, infos)
            for k, v in rec.items():
                if k not in batch:
                    batch[k] = v.new_empty((T,) + tuple(v.shape))
                batch[k][t] = v
        return env_state, roll, batch

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

    def _gather_envs(self, x):
        """(T, B/W, ...) of this rank's envs -> (T, B, ...) of all, rank-major."""
        return self.mesh.all_gather_rows(x.transpose(0, 1).contiguous()).transpose(0, 1)

    @torch.no_grad()
    def _rollout_phase(self, env_state):
        env_state, roll, batch = self._rollout(env_state)
        self._post_rollout(roll)
        if self.mesh is not None:
            batch = {k: self._gather_envs(v) for k, v in batch.items()}
        for t in range(self.horizon_length):     # the game meters, in step order
            self._update_game_meters(batch["rewards"][t, :, 0], batch["dones"][t],
                                     batch["successes"][t] if "successes" in batch else None)
        batch = self._process_rewards(batch)
        batch["returns"] = self._discount_values(
            batch["dones"], batch["values"], batch["rewards"], batch["next_values"]) + batch["values"]
        dataset = self._prepare_dataset(batch)
        metrics = {"reward_mean": batch["rewards"].mean()}
        for k in ("disc_rewards", "enc_rewards"):
            if k in batch:
                metrics[k[:-1] + "_mean"] = batch[k].mean()
        self.epoch += 1
        self.frame += self.batch_size
        return env_state, dataset, metrics

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

    @torch.no_grad()
    def _check_replicas(self) -> None:
        """Raise unless every rank holds bit-equal weights and normalizers."""
        sums = self.mesh.all_gather_rows(self.replica_checksum()[None])
        if not bool((sums == sums[0]).all()):
            raise RuntimeError(f"the replicas diverged: checksums {sums.tolist()} by rank")

    @torch.no_grad()
    def replica_checksum(self) -> torch.Tensor:
        """(2,) int64 checksum of the bits of the weights and normalizers."""
        flat = torch.cat([t.detach().reshape(-1).to(torch.float32) for t in
                          list(self.network.parameters()) + list(self._normalizer_tensors())])
        bits = flat.view(torch.int32).to(torch.int64)
        weights = torch.arange(bits.numel(), device=bits.device) % 127 + 1
        return torch.stack([bits.sum(), (bits * weights).sum()])

    def _normalizer_tensors(self):
        return [getattr(rms, f) for rms in (self.obs_rms, self.value_rms)
                for f in ("mean", "var", "count")]

    def _update_phase(self, dataset) -> Dict[str, torch.Tensor]:
        infos = []
        for _ in range(self.mini_epochs):
            perm = self._draw_minibatch_perm()
            for i in range(self.num_minibatches):
                idx = perm[i * self.minibatch_size:(i + 1) * self.minibatch_size]
                infos.append(self._update_minibatch(self._gather_minibatch(dataset, idx)))
        with torch.no_grad():
            self._post_update(dataset)
            metrics = {k: torch.stack([m[k] for m in infos]).mean() for k in infos[0]}
            m = self.meters
            n_games = torch.clamp(m["game_total"], 1.0, float(self.games_to_track))
            metrics["game_reward_mean"] = m["game_rewards_buf"].sum() / n_games
            metrics["game_length_mean"] = m["game_lengths_buf"].sum() / n_games
            metrics["games_played"] = m["game_total"]
            metrics["consecutive_successes_mean"] = m["game_success_buf"].sum() / n_games
        return metrics

    # -- epochs ---------------------------------------------------------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train_epoch(self, env_state):
        """One epoch: rollout, then update. Returns the env state and a
        record of the epoch -- its metrics as floats, wall time with the
        rollout/update split (each phase ends in a device sync) and
        env-steps/s."""
        t0 = time.time()
        env_state, dataset, rmetrics = self._rollout_phase(env_state)
        self._sync()
        t1 = time.time()
        metrics = self._update_phase(dataset)
        metrics.update(rmetrics)
        if self.mesh is not None:
            self._check_replicas()
        names = sorted(metrics)
        values = torch.stack([metrics[k].to(torch.float32) for k in names]).cpu().tolist()
        t2 = time.time()
        return env_state, {"epoch": self.epoch - 1, "wall_s": t2 - t0, "rollout_s": t1 - t0,
                           "update_s": t2 - t1, "env_steps_per_s": self.batch_size / (t2 - t0),
                           "metrics": dict(zip(names, values))}

    def _profiled_epoch(self, env_state):
        """``train_epoch`` under torch.profiler (CPU, and CUDA on the card),
        its Chrome trace written to ``<output_dir>/profile/``."""
        from ase_tpu_torch.utils.profiling import export, profiled

        (env_state, record), prof, _ = profiled(lambda: self.train_epoch(env_state), self.device)
        path = os.path.join(self.output_dir, "profile",
                            f"epoch{record['epoch']}_rank{self.rank}.pt.trace.json.gz")
        export(prof, path)
        print(f"epoch {record['epoch']} profiled: trace in {path}", flush=True)
        return env_state, record

    def train(self, max_epochs: Optional[int] = None, env_state=None,
              on_epoch: Optional[Callable[[dict], None]] = None, writer=None,
              restore_path: Optional[str] = None):
        """Train until epoch ``max_epochs`` (the config's ``max_epochs`` by
        default), printing an ``epoch N fps:...`` line per epoch, writing
        ``train/<metric>`` and ``performance/total_fps`` scalars at the frame
        count to ``writer`` if given, saving checkpoints, and calling
        ``on_epoch(record)`` after each. Sets up the train and env states
        unless ``env_state`` is given; ``restore_path`` resumes from a
        checkpoint first (the env starts fresh). Returns the env state and
        the last record. On several ranks every rank calls it; rank 0 alone
        prints the epoch lines and writes the checkpoints (``run.main``
        gives it alone a writer)."""
        max_epochs = max_epochs or self.max_epochs
        ranks = f" (rank {self.rank} of {self.world})" if self.mesh is not None else ""
        print(f"training {type(self).__name__} for {max_epochs} epochs on {self.device}"
              f"{ranks}: {self.num_actors} envs x {self.horizon_length} steps; checkpoints "
              f"under {self.output_dir}", flush=True)
        if env_state is None:
            env_state = self.setup_training()
        if restore_path:
            self.resume(restore_path)
        name = self.config.get("name", "Humanoid")

        def path(suffix=""):
            return os.path.join(self.output_dir, f"{name}{suffix}.ckpt")

        # ASE_TPU_PROFILE=<epoch> traces that epoch (unset or -1: no profiler at all)
        profile_epoch = int(os.environ.get("ASE_TPU_PROFILE", "-1"))
        start, record = time.time(), None
        while self.epoch < max_epochs:
            if self.epoch == profile_epoch:
                env_state, record = self._profiled_epoch(env_state)
            else:
                env_state, record = self.train_epoch(env_state)
            epoch, m = record["epoch"], record["metrics"]
            if self.rank == 0:
                msg = " ".join(f"{k}:{v:.4f}" for k, v in m.items())
                print(f"epoch {epoch} fps:{record['env_steps_per_s']:.0f} {msg}", flush=True)
            if writer is not None:
                for k, v in m.items():
                    writer.add_scalar(f"train/{k}", v, self.frame)
                writer.add_scalar("performance/total_fps", record["env_steps_per_s"], self.frame)
            if self.save_frequency > 0 and (epoch + 1) % self.save_frequency == 0:
                self.save(path())
                if self._save_intermediate:
                    self.save(path(f"_{epoch + 1:08d}"), exclude=())
            if (epoch >= self.save_best_after and m["games_played"] > 0
                    and m["game_reward_mean"] > self._best_mean_rewards):
                self._best_mean_rewards = m["game_reward_mean"]
                self.save(path("_best"))
            if on_epoch is not None:
                on_epoch(record)
        saved = self.save(path())
        print(f"training done in {time.time() - start:.1f}s"
              + (f"; saved {saved}" if self.rank == 0 else ""), flush=True)
        return env_state, record
