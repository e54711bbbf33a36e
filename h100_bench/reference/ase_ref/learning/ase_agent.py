"""ASEAgent: AMP + a latent skill space (port of
``ase_tpu/learning/ase_agent.py``).

Each env carries a unit latent z, fresh on reset and resampled every
[latent_steps_min, latent_steps_max) control steps (``ase_agent.py:87-117``);
the actor and critic are conditioned on it, and the latents persist across
epochs. The encoder reward ``max(z·enc(amp_obs), 0)`` joins the task and
style rewards with their weights; the encoder loss (optional weight decay
and gradient penalty) and the diversity loss, which pushes different
latents to different actions, join the PPO and discriminator losses.
"""

from __future__ import annotations

from typing import Dict

import torch

from h100_bench.reference.ase_ref.learning.amp_agent import AMPAgent
from h100_bench.reference.ase_ref.models import networks


class ASEAgent(AMPAgent):
    def __init__(self, env, cfg_train, output_dir: str = "output", mesh=None):
        config = cfg_train["params"]["config"]
        self._latent_dim = int(config["latent_dim"])
        self._latent_steps_min = int(config.get("latent_steps_min", 1))
        self._latent_steps_max = int(config.get("latent_steps_max", 150))
        self._amp_diversity_bonus = float(config.get("amp_diversity_bonus", 0.0))
        self._amp_diversity_tar = float(config.get("amp_diversity_tar", 1.0))
        self._enc_coef = float(config["enc_coef"])
        self._enc_weight_decay = float(config.get("enc_weight_decay", 0.0))
        self._enc_reward_scale = float(config.get("enc_reward_scale", 1.0))
        self._enc_grad_penalty = float(config.get("enc_grad_penalty", 0.0))
        self._enc_reward_w = float(config["enc_reward_w"])
        super().__init__(env, cfg_train, output_dir, mesh)

    def _build_network(self):
        return networks.build_ase_network(self.cfg_train["params"], self.obs_dim,
                                          self.action_dim, self.amp_obs_dim, self._latent_dim)

    def _actor_sigma(self, obs_n, roll):
        return self.network.eval_actor(obs_n, roll["ase_latents"])

    def _critic(self, obs_n, roll):
        return self.network.eval_critic(obs_n, roll["ase_latents"])

    # -- latent schedule ---------------------------------------------------------

    def _randint_steps(self, n: int) -> torch.Tensor:
        return torch.randint(self._latent_steps_min, self._latent_steps_max, (n,),
                             generator=self.gen, device=self.device)

    def _draw_latents(self, n: int) -> Dict[str, torch.Tensor]:
        """Random numbers one step of the latent schedule consumes: raw
        normals for the reset and resample latents, and their step counts."""
        def normal():
            return torch.randn(n, self._latent_dim, generator=self.gen, device=self.device)

        return {"z_reset": normal(), "steps_reset": self._randint_steps(n),
                "z_resample": normal(), "steps_inc": self._randint_steps(n)}

    def _draw_diversity_latents(self, n: int) -> torch.Tensor:
        """Raw normals for one minibatch's diversity latents, (n, latent_dim)."""
        return torch.randn(n, self._latent_dim, generator=self.replicated_gen,
                           device=self.device)

    def _init_rollout_carry(self) -> Dict[str, torch.Tensor]:
        return {
            "ase_latents": networks.sample_latents(self.gen, self.num_actors,
                                                   self._latent_dim, self.device),
            "latent_reset_steps": self._randint_steps(self.num_actors),
        }

    def _pre_rollout_step(self, env_state, roll):
        env_state, roll = super()._pre_rollout_step(env_state, roll)
        d = self._draw_latents(self.num_actors)
        z, steps = roll["ase_latents"], roll["latent_reset_steps"]
        just_reset = env_state.progress == 0
        z = torch.where(just_reset[:, None], networks.normalize_latents(d["z_reset"]), z)
        steps = torch.where(just_reset, d["steps_reset"], steps)
        need = steps <= env_state.progress
        z = torch.where(need[:, None], networks.normalize_latents(d["z_resample"]), z)
        steps = torch.where(need, steps + d["steps_inc"], steps)
        return env_state, {**roll, "ase_latents": z, "latent_reset_steps": steps}

    def _record_step(self, env_state, roll, rec, infos):
        rec = super()._record_step(env_state, roll, rec, infos)
        rec["ase_latents"] = roll["ase_latents"]
        return rec

    def _post_rollout(self, roll) -> None:
        super()._post_rollout(roll)
        self.roll_state = {"ase_latents": roll["ase_latents"],
                           "latent_reset_steps": roll["latent_reset_steps"]}

    # -- rewards ----------------------------------------------------------------------

    @staticmethod
    def _calc_enc_error(enc_pred, latents):
        return -torch.sum(enc_pred * latents, dim=-1, keepdim=True)

    def _calc_enc_rewards(self, amp_obs, latents):
        err = self._calc_enc_error(self.network.eval_enc(self._norm_amp(amp_obs)), latents)
        return torch.clamp(-err, min=0.0) * self._enc_reward_scale

    def _calc_amp_rewards(self, batch):
        out = super()._calc_amp_rewards(batch)
        out["enc_rewards"] = self._calc_enc_rewards(batch["amp_obs"], batch["ase_latents"])
        return out

    def _combine_rewards(self, task_rewards, amp_rewards):
        return (self._task_reward_w * task_rewards
                + self._disc_reward_w * amp_rewards["disc_rewards"]
                + self._enc_reward_w * amp_rewards["enc_rewards"])

    def _prepare_extra_dataset(self, batch, dataset):
        dataset = super()._prepare_extra_dataset(batch, dataset)
        dataset["ase_latents"] = batch["ase_latents"].reshape(self.batch_size, -1)
        return dataset

    # -- losses -------------------------------------------------------------------------

    def _enc_kernels(self):
        """The encoder's weights (its trunk, ``enc_mlp`` or the shared disc
        trunk, and the head; no biases)."""
        net = self.network
        trunk = net.disc_mlp if net.enc_mlp is None else net.enc_mlp
        return [layer.weight for layer in trunk.layers] + [net.enc_head.weight]

    def _extra_loss(self, loss, mb, info):
        loss, info = super()._extra_loss(loss, mb, info)
        net = self.network

        # encoder loss on the AMP minibatch (its rows lead the minibatch's)
        amp_obs_n = mb["amp_obs_n"]
        enc_latents = mb["ase_latents"][:amp_obs_n.shape[0]]
        if self._enc_grad_penalty != 0:
            amp_obs_n = amp_obs_n.detach().requires_grad_(True)
        err = self._calc_enc_error(net.eval_enc(amp_obs_n), enc_latents)
        enc_loss = self._row_mean(err)
        if self._enc_weight_decay != 0:
            enc_loss = enc_loss + self._param_share * self._enc_weight_decay * sum(
                torch.sum(torch.square(w)) for w in self._enc_kernels())
        if self._enc_grad_penalty != 0:
            (g,) = torch.autograd.grad(err, amp_obs_n, grad_outputs=torch.ones_like(err),
                                       create_graph=True)
            enc_loss = enc_loss + self._enc_grad_penalty * self._row_mean(
                torch.sum(torch.square(g), dim=-1))
        info["enc_loss"] = enc_loss.detach()
        loss = loss + self._enc_coef * enc_loss

        # diversity: different latents should give different actions
        if self._amp_diversity_bonus != 0:
            n = mb["obs_n"].shape[0] * self.world        # drawn for the whole minibatch
            new_z = networks.normalize_latents(self._share_rows(self._draw_diversity_latents(n)))
            mu_new, _ = net.eval_actor(mb["obs_n"], new_z)
            a_diff = torch.mean(torch.square(torch.clamp(info["mu"], -1, 1)
                                             - torch.clamp(mu_new, -1, 1)), dim=-1)
            z_diff = 0.5 - 0.5 * torch.sum(new_z * mb["ase_latents"], dim=-1)
            bonus = a_diff / (z_diff + 1e-5)
            div_loss = torch.square(self._amp_diversity_tar - bonus)
            div_loss = torch.sum(mb["rand_action_mask"] * div_loss) / self._mask_count(mb)
            info["diversity_loss"] = div_loss.detach()
            loss = loss + self._amp_diversity_bonus * div_loss
        return loss, info
