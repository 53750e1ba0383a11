"""Host-side utilities: JSONL metrics, profiling hooks, NaN checks,
checkpoints and the kernel build's cache."""

from low_light_image_enhancement_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)
from low_light_image_enhancement_tpu_torch.utils.compile_cache import (
    enable_compile_cache,
)
from low_light_image_enhancement_tpu_torch.utils.logging import (
    JSONLLogger,
    get_logger,
)
from low_light_image_enhancement_tpu_torch.utils.profiling import (
    profile_trace,
    stage,
)

__all__ = [
    "JSONLLogger",
    "get_logger",
    "profile_trace",
    "stage",
    "CheckpointManager",
    "enable_compile_cache",
]
