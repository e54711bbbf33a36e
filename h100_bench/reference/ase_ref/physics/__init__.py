"""Frozen copy of ``ase_tpu_torch.physics`` (the modules the reference runs)."""
