"""Low-light image enhancement on PyTorch and CUDA (NVIDIA Hopper).

The port of ``low_light_image_enhancement_tpu`` (JAX on a TPU), which stays
the reference. This package imports ``torch`` and numpy, never ``jax``.

Public API::

    import low_light_image_enhancement_tpu_torch as llt
    out = llt.enhance(img_u8_hwc)                # default config, on CUDA
    pipe = llt.EnhancePipeline(llt.PipelineConfig(method="hybrid"),
                               device="cuda")
    best = llt.EnhancePipeline(llt.PRESETS["quality"], device="cuda")
    server = llt.EnhanceServer(device="cuda")    # micro-batching server
    ve = llt.VideoEnhancer(llt.PipelineConfig(), alpha=0.3, device="cuda")
    out = ve.process(frame_u8_hwc)               # temporally smoothed
    pipe.enhance_file("dark.png", "bright.png")  # io.codec: PIL or zlib PNG
    out = pipe.enhance_raw(mosaic_u16)           # RGGB Bayer: ISP, then enhance
    for out in pipe.enhance_stream(frames, staging="canvas"):
        ...                                      # pinned prefetch queue
    mesh = llt.make_mesh(n_data=1, n_spatial=4)  # cuda:0..3, one process
    sve = llt.SpatialShardedVideoEnhancer(mesh, llt.PipelineConfig())

Methods: retinex (kernel K1), curve and hybrid (the curve CNN, then K3),
fcn and decom (their net, then K5, the bilateral or guided denoise tail).
The nets' convs run as cuDNN or, under ``conv_impl="pallas"``, as kernels
K6a/K6b, and fcn's dilated stack under ``"cascade"`` as one K7 launch;
``"gemm"``, ``"packed"`` and ``"packed12"`` are ``ops/patch_conv.py``'s
GEMM and space-to-depth forms in plain PyTorch;
``kernels.fused_enhance_hwc.enhance_hwc_u8`` is retinex on u8 HWC (K8).
Video (``VideoEnhancer``, ``MultiStreamVideoEnhancer``): retinex as one
kernel K4 per frame (or K1's gain form), curve and hybrid through K3.
``eval.metrics`` has PSNR, SSIM and CIE76 delta-E on tensors,
``eval.runner.eval_lol`` the LOL eval; ``http_server`` and ``cli`` (the
``llie-torch`` command) are the front ends. ``parallel`` runs on a mesh
of devices: ``PipelineConfig(spatial_shards=n)`` (config 5) and
``data_shards``, ``enhance_spatial_sharded``, the sharded video enhancer,
and the trainers' ``mesh`` and ``spatial_batch`` (``train``), with data
parallelism across processes in ``parallel.distributed`` and a spatial
axis that may span processes. ``utils`` has ``profile_trace``/``stage``,
``utils.debug.checked`` (NaN and division checks) and
``enable_compile_cache`` (where the kernel library is built and reused).
``EnhancePipeline.enhance_raw``/``enhance_raw_batch`` take RGGB Bayer
mosaics through the ISP (demosaic, white balance, CCM, gamma), then the
same u8 path (K1 for retinex). ``ops`` holds the plain toolkit ops, the
JAX package's ``ops`` name for name: colour spaces (HSV, YCbCr, HVI),
filters and denoise, retinex and gamma, the ISP, the Fourier ops,
autocontrast, histogram equalization and CLAHE.
"""

from low_light_image_enhancement_tpu_torch.config import (
    PRESETS,
    PipelineConfig,
)
from low_light_image_enhancement_tpu_torch.io import (
    PrefetchQueue,
    decode_image,
    encode_image,
)
from low_light_image_enhancement_tpu_torch.parallel import (
    SpatialShardedVideoEnhancer,
    enhance_spatial_sharded,
    make_mesh,
)
from low_light_image_enhancement_tpu_torch.pipeline import (
    EnhancePipeline,
    enhance,
    enhance_batch,
)
from low_light_image_enhancement_tpu_torch.serving import (
    EnhanceServer,
    ServerSaturated,
)
from low_light_image_enhancement_tpu_torch.video import (
    MultiStreamVideoEnhancer,
    VideoEnhancer,
)

__version__ = "0.1.0"

__all__ = [
    "PipelineConfig",
    "PRESETS",
    "EnhancePipeline",
    "EnhanceServer",
    "ServerSaturated",
    "VideoEnhancer",
    "MultiStreamVideoEnhancer",
    "SpatialShardedVideoEnhancer",
    "make_mesh",
    "enhance_spatial_sharded",
    "PrefetchQueue",
    "decode_image",
    "encode_image",
    "enhance",
    "enhance_batch",
    "__version__",
]
