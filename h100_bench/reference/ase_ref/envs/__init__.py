"""Frozen copy of ``ase_tpu_torch.envs`` (the modules the reference runs)."""
