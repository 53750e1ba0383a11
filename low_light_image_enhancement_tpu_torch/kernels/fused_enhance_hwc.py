"""K8 (the retinex graph on interleaved u8 HWC): wrapper, plain PyTorch
version and launch count.

``enhance_hwc_u8`` replaces the JAX package's
``kernels/fused_enhance_hwc.py::enhance_hwc_u8`` (``fused_retinex_hwc`` ->
``_retinex_hwc_kernel``), which runs K1's graph on (H, 3W) u8 rows so that
no transpose is needed. K1's CUDA kernel (``csrc/retinex_tile.cu``,
``retinex_tile_kernel``) already reads and writes u8 HWC in place, so K8 is
that kernel in the per-channel, full-3x3 configuration the JAX function
implements, behind its own wrapper and launch count. Like the JAX function,
it raises for the other denoise guides and taps, and takes u8 alone. A
blur radius past ``MAX_BLUR_RADIUS`` is blurred first into a plane
(``blur_illumination``), as K1 does. A CPU tensor goes to the plain
version, a CUDA tensor to the kernel (or the call raises).

``pad_hwc`` and ``fused_retinex_hwc`` are the JAX function's canvas form:
the edge-padded HWC batch in, the enhanced canvas out, the caller crops.
``fused_retinex_hwc`` runs the same kernel over the whole canvas (its
clamped reads of an edge-padded canvas are the image's own), so its
launches count on ``enhance_hwc_u8``.
"""

from __future__ import annotations

import torch

from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    _boost_args,
    _check_cuda_tensor,
    _ptr,
    _raise_on,
    _stream,
    _tail_args,
    _wide_blur,
    blur_illumination,
    fused_retinex_plain,
)
from low_light_image_enhancement_tpu_torch.kernels.striping import CanvasPlan


def _check(imgs: torch.Tensor, cfg: PipelineConfig) -> None:
    if cfg.method != "retinex":
        raise ValueError(f"enhance_hwc_u8 runs method='retinex', not "
                         f"{cfg.method!r}")
    if cfg.denoise_strength > 0.0 and (
            cfg.denoise_guide != "perchannel" or cfg.denoise_taps != "full"):
        raise NotImplementedError(
            "enhance_hwc_u8 implements only the per-channel full-tap "
            "bilateral, as the JAX package's interleaved kernel does; the "
            "planar path (fused_retinex) takes denoise_guide='luma' and "
            "denoise_taps='sep'")
    if imgs.dtype != torch.uint8:
        raise TypeError(f"enhance_hwc_u8 takes uint8 images, got "
                        f"{imgs.dtype}")
    if imgs.ndim != 4 or imgs.shape[-1] != 3 or 0 in imgs.shape:
        raise ValueError(f"expected non-empty (B,H,W,3), got "
                         f"{tuple(imgs.shape)}")


def enhance_hwc_u8_plain(imgs: torch.Tensor,
                         cfg: PipelineConfig) -> torch.Tensor:
    """Plain version of K8: the eager planar retinex (K1's plain version:
    transpose, replicate-pad, the graph with wrap shifts, crop, transpose
    back)."""
    return fused_retinex_plain(imgs, cfg)


def enhance_hwc_u8(imgs: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """K8: (B, H, W, 3) uint8 -> (B, H, W, 3) uint8, the retinex graph with
    the per-channel full 3x3 bilateral (or none, at strength 0), read and
    written in HWC."""
    _check(imgs, cfg)
    if imgs.device.type == "cpu":
        return enhance_hwc_u8_plain(imgs, cfg)
    _check_cuda_tensor(imgs)
    lib = _build.load_library()
    b, h, w, _ = imgs.shape
    out = torch.empty_like(imgs)
    lp = blur_illumination(imgs, cfg, 1, hwc=True) if _wide_blur(cfg) \
        else None
    with torch.cuda.device(imgs.device):
        rc = lib.llie_fused_retinex(
            imgs.data_ptr(), out.data_ptr(), 0, _ptr(lp), b, h, w, 7,
            *_boost_args(cfg), *_tail_args(cfg), _stream(imgs))
    _raise_on(rc, lib, "enhance_hwc_u8")
    enhance_hwc_u8.launches += 1
    return out


enhance_hwc_u8.launches = 0


def pad_hwc(imgs_u8: torch.Tensor, plan: CanvasPlan, h: int,
            w: int) -> torch.Tensor:
    """(B, H, W, 3) -> edge-padded (B, Hp, Wp, 3): ``margin`` rows/cols
    before the image origin, the plan's alignment padding after (the JAX
    package's ``pad_hwc``)."""
    m, dev = plan.margin, imgs_u8.device
    rows = torch.clamp(torch.arange(-m, plan.padded_h - m, device=dev),
                       0, h - 1)
    cols = torch.clamp(torch.arange(-m, plan.padded_w - m, device=dev),
                       0, w - 1)
    return imgs_u8.index_select(1, rows).index_select(2, cols)


def fused_retinex_hwc(padded_u8: torch.Tensor, cfg: PipelineConfig,
                      plan: CanvasPlan) -> torch.Tensor:
    """(B, Hp, Wp, 3) u8 edge-padded HWC (``pad_hwc``) -> (B, Hp - 2 *
    margin, Wp, 3) u8, the JAX function's shape: row 0 is the image's row
    0, and the caller crops rows [0, H) and cols [margin, margin + W). K8
    over the whole canvas; the rows returned are a view of its output."""
    if tuple(padded_u8.shape[1:3]) != (plan.padded_h, plan.padded_w):
        raise ValueError(f"expected a ({plan.padded_h}, {plan.padded_w}) "
                         f"canvas, got {tuple(padded_u8.shape)}")
    m = plan.margin
    return enhance_hwc_u8(padded_u8, cfg)[:, m:plan.padded_h - m]
