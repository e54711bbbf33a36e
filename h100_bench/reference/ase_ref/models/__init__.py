"""Frozen copy of ``ase_tpu_torch.models`` (the modules the reference runs)."""
