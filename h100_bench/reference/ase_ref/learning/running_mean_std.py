"""Running mean/std normalizer (port of
``ase_tpu/learning/running_mean_std.py``, rl_games semantics): the
statistics are buffers, updated in place by the Chan moment merge."""

from __future__ import annotations

import torch
from torch import nn


class RunningMeanStd(nn.Module):
    def __init__(self, shape):
        super().__init__()
        self.register_buffer("mean", torch.zeros(shape))
        self.register_buffer("var", torch.ones(shape))
        self.register_buffer("count", torch.tensor(1e-4))

    @torch.no_grad()
    def update(self, batch: torch.Tensor) -> "RunningMeanStd":
        """Chan-style parallel moment merge over the leading axis."""
        batch = batch.reshape(-1, *self.mean.shape)
        b_mean = batch.mean(dim=0)
        b_var = batch.var(dim=0, unbiased=False)
        b_count = float(batch.shape[0])
        delta = b_mean - self.mean
        tot = self.count + b_count
        m2 = self.var * self.count + b_var * b_count + delta.square() * self.count * b_count / tot
        self.mean.add_(delta * b_count / tot)
        self.var.copy_(m2 / tot)
        self.count.copy_(tot)
        return self

    def normalize(self, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
        return torch.clamp((x - self.mean) / torch.sqrt(self.var + 1e-5), -clip, clip)

    def denormalize(self, y: torch.Tensor) -> torch.Tensor:
        return y * torch.sqrt(self.var + 1e-5) + self.mean
