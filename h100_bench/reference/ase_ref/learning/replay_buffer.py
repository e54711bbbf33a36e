"""Fixed-size ring buffer of rows on the device (port of
``ase_tpu/learning/replay_buffer.py``).

One feature tensor plus a write head, a total count, a sampling
permutation and a cursor into it, all device tensors, so storing and
sampling never wait for the device. Sampling follows the reference's
shuffled cursor: the stored permutation is walked in order, so no row
repeats until the whole buffer has been visited, and it is replaced once a
call runs past its end. While the buffer is only partly filled, rows are
drawn uniformly from the stored region instead.

The buffer draws no random numbers: the uniform indices and the next
permutation come in as arguments (the agent draws them), so a test can hand
both packages the same numbers.
"""

from __future__ import annotations

import torch


class ReplayBuffer:
    def __init__(self, capacity: int, dim: int, device="cuda", dtype=torch.float32):
        dev = torch.device(device)
        self.data = torch.zeros(capacity, dim, dtype=dtype, device=dev)
        self.head = torch.zeros((), dtype=torch.long, device=dev)
        self.total_count = torch.zeros((), dtype=torch.long, device=dev)
        self.perm = torch.arange(capacity, device=dev)
        self.cursor = torch.zeros((), dtype=torch.long, device=dev)

    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    def limit(self) -> torch.Tensor:
        """Rows a uniform draw may pick: the stored count, at least 1."""
        return torch.clamp(self.total_count, 1, self.capacity)

    def _ring_write(self, rows: torch.Tensor, n_valid: torch.Tensor) -> "ReplayBuffer":
        """Write the first ``n_valid`` of ``rows`` at the ring head (rows past
        n_valid rewrite their slot's old contents)."""
        n = rows.shape[0]
        ar = torch.arange(n, device=rows.device)
        idx = (self.head + ar) % self.capacity
        keep = (ar < n_valid)[:, None]
        self.data[idx] = torch.where(keep, rows.to(self.data.dtype), self.data[idx])
        self.head = (self.head + n_valid) % self.capacity
        self.total_count = self.total_count + n_valid
        return self

    def store(self, batch: torch.Tensor, mask: torch.Tensor = None) -> "ReplayBuffer":
        """Write ``batch`` at the ring head; ``mask`` selects the rows to keep
        (moved to the front in their order)."""
        if mask is None:
            return self._ring_write(batch, torch.tensor(batch.shape[0], device=batch.device))
        order = torch.argsort((~mask.bool()).to(torch.int8), stable=True)
        return self._ring_write(batch[order], mask.bool().sum())

    def store_compact(self, batch: torch.Tensor, mask: torch.Tensor, k_max: int) -> "ReplayBuffer":
        """``store(batch, mask)`` that moves only ``k_max`` rows: the same
        rows in the same order whenever ``mask`` keeps at most ``k_max``;
        valid rows past the k_max-th are dropped."""
        n = batch.shape[0]
        mask = mask.bool()
        rank = torch.cumsum(mask, 0) - 1
        slot = torch.where(mask & (rank < k_max), rank, torch.full_like(rank, k_max))
        row_idx = torch.zeros(k_max + 1, dtype=torch.long, device=batch.device)
        row_idx[slot] = torch.arange(n, device=batch.device)
        n_valid = torch.clamp(mask.sum(), max=k_max)
        return self._ring_write(batch[row_idx[:k_max]], n_valid)

    def sample(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows at indices the caller drew uniformly below ``limit()``."""
        return self.data[idx]

    def sample_cursor_idx(self, n: int, uniform_idx: torch.Tensor,
                          new_perm: torch.Tensor) -> torch.Tensor:
        """Indices of ``n`` rows without replacement: the next ``n`` entries
        of the stored permutation once the buffer is full, else
        ``uniform_idx`` (drawn below ``limit()``). When the cursor runs past
        the end, ``new_perm`` (a permutation of the capacity) replaces the
        stored one for later calls and the cursor restarts at 0."""
        cap = self.capacity
        pos = (self.cursor + torch.arange(n, device=self.data.device)) % cap
        idx = torch.where(self.total_count >= cap, self.perm[pos], uniform_idx)
        exhausted = self.cursor + n >= cap
        self.perm = torch.where(exhausted, new_perm.to(self.perm.dtype), self.perm)
        self.cursor = torch.where(exhausted, torch.zeros_like(self.cursor), self.cursor + n)
        return idx
