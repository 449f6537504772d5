"""The mesh of ranks (``parallel/mesh.py``): the JAX package's multi-device
layouts on ``torch.distributed``, one process per card."""
