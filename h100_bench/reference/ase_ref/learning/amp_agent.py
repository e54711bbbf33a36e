"""AMPAgent: PPO + adversarial motion prior discriminator (port of
``ase_tpu/learning/amp_agent.py``).

The discriminator trains on [agent | replay | demo] AMP observations with
BCE loss, a logit regulariser, a gradient penalty on the demo rows (second
order: the input gradient is part of the graph) and weight decay on its
kernels; the style reward ``-log(max(1 - σ(D), 1e-4))`` is scaled and
mixed with the task reward. The demo and replay buffers live on the device.
Each epoch the demo buffer takes ``amp_batch_size`` fresh demos, then one
set of cursor indices per buffer is drawn over all T·B rows; a minibatch
gathers the first ``amp_minibatch_size`` of its rows straight from the
buffers. The rollout's AMP observations enter the replay buffer after the
minibatch loop: all of them until the buffer has been filled once, then a
``amp_replay_keep_prob`` subsample. ε-greedy: env i acts on its mean with
probability ``exp(10 (i / (n-1) - 1))`` when ``enable_eps_greedy``.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from h100_bench.reference.ase_ref.learning import checkpoint
from h100_bench.reference.ase_ref.learning.common_agent import CommonAgent
from h100_bench.reference.ase_ref.learning.replay_buffer import ReplayBuffer
from h100_bench.reference.ase_ref.learning.running_mean_std import RunningMeanStd
from h100_bench.reference.ase_ref.models import networks

DEMO_CHUNK = 16384   # rows per demo fetch while the demo buffer fills


class AMPAgent(CommonAgent):
    def __init__(self, env, cfg_train, output_dir: str = "output", mesh=None):
        config = cfg_train["params"]["config"]
        self._task_reward_w = float(config["task_reward_w"])
        self._disc_reward_w = float(config["disc_reward_w"])
        self._amp_batch_size = int(config["amp_batch_size"])
        self._amp_minibatch_size = min(int(config["amp_minibatch_size"]),
                                       int(config["minibatch_size"]))
        self._disc_coef = float(config["disc_coef"])
        self._disc_logit_reg = float(config["disc_logit_reg"])
        self._disc_grad_penalty = float(config["disc_grad_penalty"])
        self._disc_weight_decay = float(config["disc_weight_decay"])
        self._disc_reward_scale = float(config["disc_reward_scale"])
        self._normalize_amp_input = bool(config.get("normalize_amp_input", True))
        self._enable_eps_greedy = bool(config.get("enable_eps_greedy", False))
        self._amp_obs_demo_buffer_size = int(config["amp_obs_demo_buffer_size"])
        self._amp_replay_buffer_size = int(config["amp_replay_buffer_size"])
        self._amp_replay_keep_prob = float(config["amp_replay_keep_prob"])
        self.amp_obs_dim = env.amp_obs_size()
        super().__init__(env, cfg_train, output_dir, mesh)
        self.amp_rms = RunningMeanStd((self.amp_obs_dim,)).to(self.device)
        self._rand_action_probs = torch.as_tensor(self._build_rand_action_probs(),
                                                  device=self.device)

    def _build_network(self):
        return networks.build_amp_network(self.cfg_train["params"], self.obs_dim,
                                          self.action_dim, self.amp_obs_dim)

    def _actor_sigma(self, obs_n, roll):
        return self.network.eval_actor(obs_n)

    def _critic(self, obs_n, roll):
        return self.network.eval_critic(obs_n)

    # -- ε-greedy ------------------------------------------------------------------

    def _build_rand_action_probs(self) -> np.ndarray:
        """The probabilities of this rank's rows of the global envs."""
        n = self.num_actors * self.world
        env_ids = np.arange(n, dtype=np.float32)
        probs = 1.0 - np.exp(10.0 * (env_ids / (n - 1.0) - 1.0))
        probs[0] = 1.0
        probs[-1] = 0.0
        if not self._enable_eps_greedy:
            probs[:] = 1.0
        return probs.astype(np.float32)[self.rank * self.num_actors:
                                        (self.rank + 1) * self.num_actors]

    def _rand_action_mask(self, u_mask):
        return (u_mask < self._rand_action_probs).to(torch.float32)

    # -- random draws --------------------------------------------------------------

    def _draw_cursor(self, buffer: ReplayBuffer, n: int) -> Dict[str, torch.Tensor]:
        """A buffer's cursor draw: n uniform indices below its ``limit()``
        and a fresh permutation of its capacity."""
        u = torch.rand(n, generator=self.replicated_gen, device=self.device)
        limit = buffer.limit()
        idx = torch.minimum((u * limit).long(), limit - 1)
        perm = torch.randperm(buffer.capacity, generator=self.replicated_gen, device=self.device)
        return {"uniform_idx": idx, "new_perm": perm}

    # -- train state -----------------------------------------------------------------

    def init_train_state(self) -> None:
        super().init_train_state()
        self.demo_buffer = ReplayBuffer(self._amp_obs_demo_buffer_size, self.amp_obs_dim,
                                        self.device)
        self.replay_buffer = ReplayBuffer(self._amp_replay_buffer_size, self.amp_obs_dim,
                                          self.device)
        self._fill_demo_buffer()

    def _weight_leaves(self):
        leaves = super()._weight_leaves()
        leaves.update(checkpoint.rms_leaves(self.amp_rms, ".extra['amp_rms']"))
        return leaves

    @torch.no_grad()
    def _fill_demo_buffer(self) -> None:
        """Fill the demo buffer once, in fetches of at most DEMO_CHUNK rows."""
        chunk = min(self._amp_obs_demo_buffer_size, DEMO_CHUNK)
        for _ in range(math.ceil(self._amp_obs_demo_buffer_size / chunk)):
            self.demo_buffer.store(self.env.fetch_amp_obs_demo(chunk))

    # -- rollout and rewards ---------------------------------------------------------

    def _norm_amp(self, amp_obs):
        return self.amp_rms.normalize(amp_obs) if self._normalize_amp_input else amp_obs

    def _record_step(self, env_state, roll, rec, infos):
        rec = super()._record_step(env_state, roll, rec, infos)
        rec["amp_obs"] = self.env.amp_obs_flat(env_state)
        return rec

    def _calc_disc_rewards(self, amp_obs):
        prob = torch.sigmoid(self.network.eval_disc(self._norm_amp(amp_obs)))
        return -torch.log(torch.clamp(1.0 - prob, min=0.0001)) * self._disc_reward_scale

    def _calc_amp_rewards(self, batch) -> Dict[str, torch.Tensor]:
        return {"disc_rewards": self._calc_disc_rewards(batch["amp_obs"])}

    def _combine_rewards(self, task_rewards, amp_rewards):
        return (self._task_reward_w * task_rewards
                + self._disc_reward_w * amp_rewards["disc_rewards"])

    def _process_rewards(self, batch):
        amp_rewards = self._calc_amp_rewards(batch)
        batch["rewards"] = self._combine_rewards(batch["rewards"], amp_rewards)
        batch.update(amp_rewards)
        return batch

    # -- dataset ------------------------------------------------------------------------

    def _prepare_extra_dataset(self, batch, dataset):
        dataset = super()._prepare_extra_dataset(batch, dataset)
        amp_obs = batch["amp_obs"].reshape(self.batch_size, -1)
        dataset["amp_obs"] = amp_obs
        self.demo_buffer.store(self.env.fetch_amp_obs_demo(self._amp_batch_size))
        n = amp_obs.shape[0]
        for key, buf in (("amp_obs_demo_idx", self.demo_buffer),
                         ("amp_obs_replay_idx", self.replay_buffer)):
            dataset[key] = buf.sample_cursor_idx(n, **self._draw_cursor(buf, n))
        return dataset

    def _minibatch_rows(self):
        rows = super()._minibatch_rows()
        n = self._amp_minibatch_size
        rows.update(amp_obs=n, amp_obs_demo_idx=n, amp_obs_replay_idx=n)
        return rows

    def _gather_minibatch(self, dataset, idx):
        """The minibatch's demo and replay rows come straight from the
        buffers (the agent's own rows while the replay buffer is empty)."""
        mb = super()._gather_minibatch(dataset, idx)
        mb["amp_obs_demo"] = self.demo_buffer.data[mb.pop("amp_obs_demo_idx")]
        rbuf = self.replay_buffer
        mb["amp_obs_replay"] = torch.where(rbuf.total_count > 0,
                                           rbuf.data[mb.pop("amp_obs_replay_idx")], mb["amp_obs"])
        return mb

    def _preproc_minibatch(self, mb):
        """One AMP normalizer update over [agent | replay | demo] (3n rows),
        then all three normalized with the new statistics."""
        mb = super()._preproc_minibatch(mb)
        n = self._amp_minibatch_size
        cat = torch.cat([mb["amp_obs"], mb["amp_obs_replay"], mb["amp_obs_demo"]], dim=0)
        if self._normalize_amp_input:
            cat = self.amp_rms.update(cat).normalize(cat)
        mb["amp_obs_ar_n"] = cat[:2 * n]
        mb["amp_obs_n"] = cat[:n]
        mb["amp_obs_demo_n"] = cat[2 * n:]
        return mb

    # -- discriminator loss ---------------------------------------------------------------

    def _disc_kernels(self):
        """The discriminator MLP's and logit layer's weights (no biases)."""
        return [layer.weight for layer in self.network.disc_mlp.layers] + \
            [self.network.disc_logits.weight]

    def _disc_loss(self, agent_logits, demo_obs_n):
        demo_obs = demo_obs_n.detach().requires_grad_(True)
        demo_logits = self.network.eval_disc(demo_obs)
        (demo_grad,) = torch.autograd.grad(demo_logits, demo_obs,
                                           grad_outputs=torch.ones_like(demo_logits),
                                           create_graph=True)
        bce = F.binary_cross_entropy_with_logits
        loss_agent = self._row_mean(bce(agent_logits, torch.zeros_like(agent_logits),
                                        reduction="none"))
        loss_demo = self._row_mean(bce(demo_logits, torch.ones_like(demo_logits),
                                       reduction="none"))
        loss = 0.5 * (loss_agent + loss_demo)
        logit_loss = self._param_share * torch.sum(torch.square(self.network.disc_logits.weight))
        loss = loss + self._disc_logit_reg * logit_loss
        grad_pen = self._row_mean(torch.sum(torch.square(demo_grad), dim=-1))
        loss = loss + self._disc_grad_penalty * grad_pen
        if self._disc_weight_decay != 0:
            loss = loss + self._param_share * self._disc_weight_decay * sum(
                torch.sum(torch.square(w)) for w in self._disc_kernels())
        with torch.no_grad():
            info = {"disc_loss": loss.detach(), "disc_grad_penalty": grad_pen.detach(),
                    "disc_logit_loss": logit_loss.detach(),
                    "disc_agent_acc": self._row_mean((agent_logits < 0).to(torch.float32)),
                    "disc_demo_acc": self._row_mean((demo_logits > 0).to(torch.float32)),
                    "disc_agent_logit": self._row_mean(agent_logits),
                    "disc_demo_logit": self._row_mean(demo_logits)}
        return loss, info

    def _extra_loss(self, loss, mb, info):
        loss, info = super()._extra_loss(loss, mb, info)
        disc_loss, disc_info = self._disc_loss(self.network.eval_disc(mb["amp_obs_ar_n"]),
                                               mb["amp_obs_demo_n"])
        info.update(disc_info)
        return loss + self._disc_coef * disc_loss, info
