"""Frozen copy of ``ase_tpu_torch.utils`` (the modules the reference runs)."""
