"""Frozen copy of ``ase_tpu_torch.learning`` (the modules the reference runs)."""
