"""Data-parallel ranks (``mesh.py``, over ``torch.distributed``) and spatial
banding (``spatial.py``): the JAX package's ``parallel/``."""
from .mesh import (  # noqa: F401
    DATA_AXIS,
    REPLICA_AXIS,
    Mesh,
    local_batch_size,
    make_mesh,
    mesh_size,
    replicate,
    setup_distributed,
    shard_batch,
)
from .spatial import merge_bands, spatial_shard_infer, split_bands  # noqa: F401
