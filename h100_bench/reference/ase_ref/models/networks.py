"""Policy / value / discriminator / encoder networks as ``nn.Module``s
(port of the ``MLP``, ``AMPNetwork``, ``StyleNet``, ``ASENetwork`` and
``HRLNetwork`` of ``ase_tpu/models/networks.py``).

Layer widths, activations, heads and initialisation are the reference's:
every ``Linear`` weight U(+-1/sqrt(fan_in)) (torch's default weight init)
with a zero bias, except the ±1-uniform discriminator logit layer and
style output, the ±0.1-uniform encoder head, and a constant log-sigma
``sigma_init.val`` (a trainable parameter, as optax trains every leaf).
AMP: separate actor/critic MLPs on the observation plus the discriminator.
ASE: the actor is a style net (latent -> 512 -> 256 -> tanh style vector)
concatenated with the observation into the main MLP; the critic sees
obs + latent; the encoder shares the discriminator trunk (or, with
``enc.separate``, has an MLP of its own, ``enc_mlp``, of the ``enc.units``
widths) and L2-normalizes its head. HRL: separate actor/critic MLPs on the task observation, whose
action is a latent of the low-level controller. Trained weights come from
``learning.checkpoint``.

Mixed precision (``config.mixed_precision``, else ``ASE_TPU_BF16=1``): the
parameters stay float32 and every dense layer computes as flax's
``nn.Dense(dtype=bfloat16)`` does -- input and kernel cast to bfloat16, a
bfloat16 product (float32 accumulation), then the bias added in bfloat16.
relu and the style net's tanh run in bfloat16; each head (``mu``,
``value``, ``disc_logits``, ``enc_head``) is cast back to float32 before
anything reads it. The compute dtype is explicit per layer, not
``torch.autocast``, so the CPU and the card run the same roundings.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class Dense(nn.Linear):
    """``nn.Linear`` with float32 parameters computing in ``compute_dtype``
    (None: the parameters' own dtype)."""

    def __init__(self, a: int, b: int, compute_dtype: Optional[torch.dtype] = None):
        super().__init__(a, b)
        self.compute_dtype = compute_dtype

    def forward(self, x):
        dt = self.compute_dtype
        if dt is None:
            return F.linear(x, self.weight, self.bias)
        # flax's order: a rounded product, then a rounded bias add
        return F.linear(x.to(dt), self.weight.to(dt)) + self.bias.to(dt)


def _init_linear(layer: Dense, gen: torch.Generator, scale: float = None) -> Dense:
    """Weight U(+-scale), scale 1/sqrt(fan_in) by default; zero bias."""
    if scale is None:
        scale = 1.0 / math.sqrt(layer.in_features)
    with torch.no_grad():
        layer.weight.uniform_(-scale, scale, generator=gen)
        layer.bias.zero_()
    return layer


def _linear(a: int, b: int, gen: torch.Generator, scale: float = None,
            dtype: Optional[torch.dtype] = None) -> Dense:
    return _init_linear(Dense(a, b, dtype), gen, scale)


class MLP(nn.Module):
    """Dense + relu stack; parameters named Dense_0..Dense_{n-1} as in flax."""

    def __init__(self, in_dim: int, units: Sequence[int], gen: torch.Generator,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        dims = [in_dim, *units]
        self.layers = nn.ModuleList(_linear(a, b, gen, dtype=dtype)
                                    for a, b in zip(dims[:-1], dims[1:]))

    def forward(self, x):
        for layer in self.layers:
            x = torch.relu(layer(x))
        return x


class AMPNetwork(nn.Module):
    """Actor + critic + discriminator."""

    def __init__(self, obs_dim: int, amp_obs_dim: int, actions_num: int,
                 units: Sequence[int], disc_units: Sequence[int],
                 sigma_init_val: float = -2.9, gen: torch.Generator = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.actor_mlp = MLP(obs_dim, units, gen, dtype)
        self.critic_mlp = MLP(obs_dim, units, gen, dtype)
        self.mu = _linear(units[-1], actions_num, gen, dtype=dtype)
        self.value = _linear(units[-1], 1, gen, dtype=dtype)
        self.sigma = nn.Parameter(torch.full((actions_num,), float(sigma_init_val)))
        self.disc_mlp = MLP(amp_obs_dim, disc_units, gen, dtype)
        self.disc_logits = _linear(disc_units[-1], 1, gen, scale=1.0, dtype=dtype)

    def eval_actor(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = self.mu(self.actor_mlp(obs)).float()
        return mu, self.sigma.expand(mu.shape)

    def eval_critic(self, obs) -> torch.Tensor:
        return self.value(self.critic_mlp(obs)).float()

    def eval_disc(self, amp_obs) -> torch.Tensor:
        return self.disc_logits(self.disc_mlp(amp_obs)).float()


class StyleNet(nn.Module):
    """Latent -> tanh style vector."""

    def __init__(self, latent_dim: int, style_units: Sequence[int], style_dim: int,
                 gen: torch.Generator, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.mlp = MLP(latent_dim, style_units, gen, dtype)
        self.out = _linear(style_units[-1], style_dim, gen, scale=1.0, dtype=dtype)

    def forward(self, z):
        return torch.tanh(self.out(self.mlp(z)))


class ASENetwork(nn.Module):
    """Latent-conditioned actor/critic + discriminator + encoder."""

    def __init__(self, obs_dim: int, amp_obs_dim: int, actions_num: int, latent_dim: int,
                 units: Sequence[int], disc_units: Sequence[int],
                 style_units: Sequence[int] = (512, 256), sigma_init_val: float = -2.9,
                 gen: torch.Generator = None, dtype: Optional[torch.dtype] = None,
                 enc_units: Optional[Sequence[int]] = None):
        """``enc_units``: the widths of a separate encoder MLP; None shares
        the discriminator trunk."""
        super().__init__()
        self.style_net = StyleNet(latent_dim, style_units, latent_dim, gen, dtype)
        self.actor_mlp = MLP(obs_dim + latent_dim, units, gen, dtype)
        self.critic_mlp = MLP(obs_dim + latent_dim, units, gen, dtype)
        self.mu = _linear(units[-1], actions_num, gen, dtype=dtype)
        self.value = _linear(units[-1], 1, gen, dtype=dtype)
        self.sigma = nn.Parameter(torch.full((actions_num,), float(sigma_init_val)))
        self.disc_mlp = MLP(amp_obs_dim, disc_units, gen, dtype)
        self.disc_logits = _linear(disc_units[-1], 1, gen, scale=1.0, dtype=dtype)
        self.enc_mlp = None if enc_units is None else MLP(amp_obs_dim, enc_units, gen, dtype)
        trunk = (disc_units if enc_units is None else enc_units)[-1]
        self.enc_head = _linear(trunk, latent_dim, gen, scale=0.1, dtype=dtype)

    def eval_actor(self, obs, ase_latents) -> Tuple[torch.Tensor, torch.Tensor]:
        # float32 obs beside a bfloat16 style vector: the cat promotes to
        # float32, as jnp.concatenate does, and the MLP casts back
        h = torch.cat([obs, self.style_net(ase_latents)], dim=-1)
        mu = self.mu(self.actor_mlp(h)).float()
        return mu, self.sigma.expand(mu.shape)

    def eval_critic(self, obs, ase_latents) -> torch.Tensor:
        return self.value(self.critic_mlp(torch.cat([obs, ase_latents], dim=-1))).float()

    def eval_disc(self, amp_obs) -> torch.Tensor:
        return self.disc_logits(self.disc_mlp(amp_obs)).float()

    def eval_enc(self, amp_obs) -> torch.Tensor:
        trunk = self.disc_mlp if self.enc_mlp is None else self.enc_mlp
        out = self.enc_head(trunk(amp_obs)).float()
        return out / torch.clamp(torch.linalg.norm(out, dim=-1, keepdim=True), min=1e-8)


class HRLNetwork(nn.Module):
    """High-level controller: actor and critic over the task observation;
    the action is a latent of the low-level controller."""

    def __init__(self, obs_dim: int, actions_num: int, units: Sequence[int],
                 sigma_init_val: float = -2.3, gen: torch.Generator = None,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.actor_mlp = MLP(obs_dim, units, gen, dtype)
        self.critic_mlp = MLP(obs_dim, units, gen, dtype)
        self.mu = _linear(units[-1], actions_num, gen, dtype=dtype)
        self.value = _linear(units[-1], 1, gen, dtype=dtype)
        self.sigma = nn.Parameter(torch.full((actions_num,), float(sigma_init_val)))

    def eval_actor(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        mu = self.mu(self.actor_mlp(obs)).float()
        return mu, self.sigma.expand(mu.shape)

    def eval_critic(self, obs) -> torch.Tensor:
        return self.value(self.critic_mlp(obs)).float()


def _compute_dtype(params) -> Optional[torch.dtype]:
    """bfloat16 under mixed precision, else None (float32): the config's
    ``config.mixed_precision`` wins; without the key, ``ASE_TPU_BF16=1``."""
    mp = params.get("config", {}).get("mixed_precision", None)
    if mp is None:
        mp = os.environ.get("ASE_TPU_BF16", "0") == "1"
    return torch.bfloat16 if mp else None


def _checked(params, disc: bool = True):
    """The network block and the keyword arguments the builders take."""
    net = params["network"]
    kw = dict(units=tuple(net["mlp"]["units"]),
              sigma_init_val=float(net["space"]["continuous"]["sigma_init"]["val"]),
              dtype=_compute_dtype(params))
    if disc:
        kw["disc_units"] = tuple(net["disc"]["units"])
    return net, kw


def _init_gen(params) -> torch.Generator:
    """CPU generator for the initial weights, seeded from the config."""
    gen = torch.Generator()
    gen.manual_seed(int(params.get("seed", 0)))
    return gen


def build_amp_network(params, obs_dim: int, act_dim: int, amp_obs_dim: int) -> AMPNetwork:
    """AMPNetwork from a cfg_train ``params`` block, initialised on the CPU."""
    _, kw = _checked(params)
    return AMPNetwork(obs_dim=obs_dim, amp_obs_dim=amp_obs_dim, actions_num=act_dim,
                      gen=_init_gen(params), **kw)


def build_ase_network(params, obs_dim: int, act_dim: int, amp_obs_dim: int,
                      latent_dim: int) -> ASENetwork:
    """ASENetwork from a cfg_train ``params`` block, initialised on the CPU."""
    net, kw = _checked(params)
    if net["enc"].get("separate", False):
        kw["enc_units"] = tuple(net["enc"]["units"])
    return ASENetwork(obs_dim=obs_dim, amp_obs_dim=amp_obs_dim, actions_num=act_dim,
                      latent_dim=latent_dim, gen=_init_gen(params), **kw)


def build_hrl_network(params, obs_dim: int, act_dim: int) -> HRLNetwork:
    """HRLNetwork from a cfg_train ``params`` block, initialised on the CPU."""
    _, kw = _checked(params, disc=False)
    return HRLNetwork(obs_dim=obs_dim, actions_num=act_dim, gen=_init_gen(params), **kw)


def build_network(name: str, params, obs_dim: int, act_dim: int, amp_obs_dim: int = 0,
                  latent_dim: int = 0) -> nn.Module:
    """Network registry keyed by the cfg_train ``network.name`` field."""
    if name == "amp":
        return build_amp_network(params, obs_dim, act_dim, amp_obs_dim)
    if name == "ase":
        return build_ase_network(params, obs_dim, act_dim, amp_obs_dim, latent_dim)
    if name == "hrl":
        return build_hrl_network(params, obs_dim, act_dim)
    raise ValueError(f"unknown network {name}")


def sample_latents(gen: torch.Generator, n: int, latent_dim: int, device) -> torch.Tensor:
    """Uniform on the unit hypersphere."""
    return normalize_latents(torch.randn(n, latent_dim, generator=gen, device=device))


def normalize_latents(z: torch.Tensor) -> torch.Tensor:
    return z / torch.clamp(torch.linalg.norm(z, dim=-1, keepdim=True), min=1e-8)
