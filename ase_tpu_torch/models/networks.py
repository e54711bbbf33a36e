"""Policy / value / discriminator / encoder networks as ``nn.Module``s
(port of the ``MLP``, ``StyleNet`` and ``ASENetwork`` of
``ase_tpu/models/networks.py``).

Layer widths, activations and heads are the reference's: the actor is a
style net (latent -> 512 -> 256 -> tanh style vector) concatenated with the
observation into the main MLP; the critic sees obs + latent; the encoder
shares the discriminator trunk and L2-normalizes its head. Weights come
from ``learning.checkpoint.load_ase`` (or torch's default init).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn


class MLP(nn.Module):
    """Dense + relu stack; parameters named Dense_0..Dense_{n-1} as in flax."""

    def __init__(self, in_dim: int, units: Sequence[int]):
        super().__init__()
        dims = [in_dim, *units]
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


class StyleNet(nn.Module):
    """Latent -> tanh style vector."""

    def __init__(self, latent_dim: int, style_units: Sequence[int], style_dim: int):
        super().__init__()
        self.mlp = MLP(latent_dim, style_units)
        self.out = nn.Linear(style_units[-1], style_dim)

    def forward(self, z):
        return torch.tanh(self.out(self.mlp(z)))


class ASENetwork(nn.Module):
    """Latent-conditioned actor/critic + discriminator + encoder."""

    def __init__(self, obs_dim: int, amp_obs_dim: int, actions_num: int, latent_dim: int,
                 units: Sequence[int], disc_units: Sequence[int],
                 style_units: Sequence[int] = (512, 256), sigma_init_val: float = -2.9):
        super().__init__()
        self.style_net = StyleNet(latent_dim, style_units, latent_dim)
        self.actor_mlp = MLP(obs_dim + latent_dim, units)
        self.critic_mlp = MLP(obs_dim + latent_dim, units)
        self.mu = nn.Linear(units[-1], actions_num)
        self.value = nn.Linear(units[-1], 1)
        self.sigma = nn.Parameter(torch.full((actions_num,), float(sigma_init_val)))
        self.disc_mlp = MLP(amp_obs_dim, disc_units)
        self.disc_logits = nn.Linear(disc_units[-1], 1)
        self.enc_head = nn.Linear(disc_units[-1], latent_dim)

    def eval_actor(self, obs, ase_latents) -> Tuple[torch.Tensor, torch.Tensor]:
        h = torch.cat([obs, self.style_net(ase_latents)], dim=-1)
        mu = self.mu(self.actor_mlp(h))
        return mu, self.sigma.expand(mu.shape)

    def eval_critic(self, obs, ase_latents) -> torch.Tensor:
        return self.value(self.critic_mlp(torch.cat([obs, ase_latents], dim=-1)))

    def eval_disc(self, amp_obs) -> torch.Tensor:
        return self.disc_logits(self.disc_mlp(amp_obs))

    def eval_enc(self, amp_obs) -> torch.Tensor:
        out = self.enc_head(self.disc_mlp(amp_obs))
        return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-8)


def build_ase_network(params, obs_dim: int, act_dim: int, amp_obs_dim: int,
                      latent_dim: int) -> ASENetwork:
    """ASENetwork from a cfg_train ``params`` block."""
    net = params["network"]
    if net["enc"].get("separate", False):
        raise NotImplementedError("a separate encoder MLP is not ported yet")
    if params.get("config", {}).get("mixed_precision", False):
        raise NotImplementedError("mixed_precision (bf16 matmuls) is not ported yet")
    return ASENetwork(
        obs_dim=obs_dim, amp_obs_dim=amp_obs_dim, actions_num=act_dim,
        latent_dim=latent_dim, units=tuple(net["mlp"]["units"]),
        disc_units=tuple(net["disc"]["units"]),
        sigma_init_val=float(net["space"]["continuous"]["sigma_init"]["val"]),
    )


def sample_latents(gen: torch.Generator, n: int, latent_dim: int, device) -> torch.Tensor:
    """Uniform on the unit hypersphere."""
    return normalize_latents(torch.randn(n, latent_dim, generator=gen, device=device))


def normalize_latents(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True), min=1e-8)
