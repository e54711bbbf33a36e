"""Frozen copy of ``ase_tpu_torch.ops`` (the modules the reference runs)."""
