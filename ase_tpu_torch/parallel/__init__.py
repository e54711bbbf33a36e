"""Data-parallel training over torch.distributed (``parallel/mesh.py``)."""
