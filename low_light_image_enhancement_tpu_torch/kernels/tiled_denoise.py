"""K5 (the tiled denoise tail of fcn and decom): wrapper, plain PyTorch
version and launch count.

``tiled_denoise`` replaces the JAX package's
``kernels/tiled_denoise.py::tiled_denoise`` (``_denoise_kernel``). It
dispatches on the device of its input alone: a CPU tensor goes to
``tiled_denoise_plain``, a CUDA tensor to the hand-written kernel in
``csrc/tiled_denoise.cu`` (or the call raises). ``tiled_denoise.launches``
counts the kernel launches, and nothing else.

The contract follows K3's: the whole f32 block goes in, with its ``halo``
and ``rows``, and the window ``[halo - m, halo + rows + m)``
(``m = canvas_margin(cfg)``) is read where it lies; the JAX package slices
and edge-pads that window into a copy first.
"""

from __future__ import annotations

import torch

from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import denoise_tail
from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    _check_cuda_tensor,
    _raise_on,
    _tail_args,
)


def tiled_denoise_plain(y: torch.Tensor, cfg: PipelineConfig, halo: int,
                        rows: int) -> torch.Tensor:
    """Plain version of K5: the configured denoise on the window
    ``[halo - m, halo + rows + m)`` with wrap shifts, clipped to [0, 1],
    rows ``[m, m + rows)`` of it."""
    m = canvas_margin(cfg)
    y = denoise_tail(y[..., halo - m:halo + rows + m, :], cfg)
    return torch.clamp(y, 0.0, 1.0)[..., m:m + rows, :]


def tiled_denoise(y: torch.Tensor, cfg: PipelineConfig, halo: int,
                  rows: int) -> torch.Tensor:
    """K5: f32 block (B, 3, HB, WB) -> f32 (B, 3, rows, WB), the denoised
    and clipped block rows [halo, halo + rows).

    The block has ``canvas_margin(cfg)`` replicate columns before the
    image's column 0. Output columns outside [m, m + w) of an image w
    columns wide are not defined (the caller crops them)."""
    if cfg.denoise_strength <= 0.0:
        raise ValueError("tiled_denoise runs the denoise tail; at "
                         "denoise_strength 0 the caller skips it")
    if y.dtype != torch.float32 or y.ndim != 4 or y.shape[1] != 3 \
            or 0 in y.shape:
        raise ValueError(f"expected an f32 (B,3,HB,WB) block, got {y.dtype} "
                         f"{tuple(y.shape)}")
    b, _, hb, wb = y.shape
    m = canvas_margin(cfg)
    if rows < 1 or halo < m or hb < halo + rows + m:
        raise ValueError(f"block of {hb} rows cannot hold {rows} rows "
                         f"with halo {halo} >= margin {m}")
    if y.device.type == "cpu":
        return tiled_denoise_plain(y, cfg, halo, rows)
    _check_cuda_tensor(y)
    lib = _build.load_library()
    guided = cfg.denoise_taps == "guided"
    r = cfg.guided_radius   # 1..8, as PipelineConfig validates
    out = torch.empty((b, 3, rows, wb), dtype=torch.float32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_tiled_denoise_f32(
            y.data_ptr(), out.data_ptr(), b, hb, wb, halo, rows, m,
            *_tail_args(cfg), int(guided), r, 1.0 / (2 * r + 1),
            cfg.guided_eps, stream)
    _raise_on(rc, lib, "tiled_denoise")
    tiled_denoise.launches += 1
    return out


tiled_denoise.launches = 0
