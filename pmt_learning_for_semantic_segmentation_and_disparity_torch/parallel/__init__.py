"""Spatial banding of the port (``spatial.py``). The JAX package's mesh
(``parallel/mesh.py``) is the multi-device slice, ROADMAP.md queue 1, item
10."""
from .spatial import merge_bands, spatial_shard_infer, split_bands  # noqa: F401
