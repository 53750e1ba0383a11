"""Execution on a mesh of devices: mesh construction, batch sharding,
spatial sharding with halo exchange (BASELINE config 5), the sharded video
enhancer, and data parallelism across processes (``distributed``). One
process drives a grid of ``torch.device``s; the port of the JAX package's
``parallel``."""

from low_light_image_enhancement_tpu_torch.parallel.halo import (
    halo_pad,
    halo_pad_local,
)
from low_light_image_enhancement_tpu_torch.parallel.sharding import (
    Mesh,
    enhance_spatial_sharded,
    make_mesh,
    shard_batch_fn,
)
from low_light_image_enhancement_tpu_torch.parallel.video_sharded import (
    SpatialShardedVideoEnhancer,
)

__all__ = [
    "make_mesh",
    "shard_batch_fn",
    "enhance_spatial_sharded",
    "halo_pad",
    "halo_pad_local",
    "SpatialShardedVideoEnhancer",
    "Mesh",
]
