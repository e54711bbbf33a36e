"""Visualization tools (matplotlib, offline; imported inside the functions)."""
from ase_tpu_torch.viz import plotter  # noqa: F401
