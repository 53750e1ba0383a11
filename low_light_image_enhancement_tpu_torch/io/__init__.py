"""Host-side I/O: image codecs and the host -> device prefetch queue."""

from low_light_image_enhancement_tpu_torch.io.codec import (
    decode_image,
    encode_image,
)
from low_light_image_enhancement_tpu_torch.io.prefetch import PrefetchQueue

__all__ = ["decode_image", "encode_image", "PrefetchQueue"]
