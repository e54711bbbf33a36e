"""Frozen copy of ``ase_tpu_torch.motion`` (the modules the reference runs)."""
