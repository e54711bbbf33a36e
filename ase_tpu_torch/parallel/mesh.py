"""The process group of data-parallel training (the port's counterpart of
``ase_tpu/parallel/mesh.py``).

The reference shards the env axis of one program over a device mesh and
lets XLA insert the collectives. The port runs one process per card,
launched by torchrun,

    torchrun --nproc_per_node=<cards> -m ase_tpu_torch.run --multi_gpu ...

and its agents call the few collectives they need through ``Mesh``, each
on a tensor of the rank's device: ``all_reduce_sum``, ``all_gather_rows``
and ``broadcast``. The default backend is NCCL for a card and gloo for the
CPU. A gloo group may also carry CUDA tensors: ``Mesh`` then stages them
through host memory (gloo has no CUDA all-gather, and NCCL refuses two
ranks on one card, which is how one card runs two ranks). Nothing here runs
unless a caller calls ``init``.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

ENV_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
_REPLICATED_SEED = 1 << 62   # offset of the seed every rank shares


@dataclasses.dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    device: torch.device
    staged: bool             # a gloo group carrying CUDA tensors through host memory

    def _buffer(self, x: torch.Tensor) -> torch.Tensor:
        """A contiguous copy of ``x`` where the backend takes it."""
        return x.detach().to("cpu" if self.staged else x.device, copy=True).contiguous()

    def all_reduce_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's ``x``."""
        buf = self._buffer(x)
        dist.all_reduce(buf)
        return buf.to(x.device)

    def all_gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated along dim 0 in rank order (the
        same shape on every rank)."""
        buf = self._buffer(x)
        parts = [torch.empty_like(buf) for _ in range(self.world)]
        dist.all_gather(parts, buf)
        return torch.cat(parts).to(x.device)

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank."""
        buf = self._buffer(x)
        dist.broadcast(buf, src)
        return buf.to(x.device)

    def rank_seed(self, seed: int) -> int:
        """A seed of this rank's own, for its per-env draws."""
        return seed + (self.rank << 32)

    @staticmethod
    def replicated_seed(seed: int) -> int:
        """The seed every rank shares, for the draws replicated code makes."""
        return seed + _REPLICATED_SEED

    def close(self) -> None:
        dist.destroy_process_group()


def init(backend: Optional[str] = None, device="cuda") -> Mesh:
    """Join the process group that torchrun's variables describe (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``). The
    rank works on ``device``: a card without an index means card
    ``LOCAL_RANK``, made the current device. ``backend`` defaults to NCCL
    on a card and gloo on the CPU; gloo on a card stages every collective
    through host memory."""
    missing = [k for k in ENV_VARS if k not in os.environ]
    if missing:
        raise RuntimeError(
            f"data-parallel training needs torchrun's variables ({', '.join(missing)} "
            "missing): launch it as torchrun --nproc_per_node=<cards> -m "
            "ase_tpu_torch.run --multi_gpu ...")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world)
    return Mesh(rank, world, dev, staged=backend == "gloo" and dev.type == "cuda")
