"""The enhancement graph on pre-padded planar images (plain PyTorch).

Port of the JAX package's ``core.py``: the same math on a canvas that was
replicate-padded once, filtered with wrap-around shifts (``roll2d``). The
interior equals edge-clamped filtering of the unpadded image; the outer ring
(< margin) is cropped by the caller. The intermediates at out-of-image
canvas positions are computed from the replicated input, never clamped
themselves.
"""

from __future__ import annotations

from typing import Optional

import torch

from low_light_image_enhancement_tpu_torch.config import MARGIN, PipelineConfig
from low_light_image_enhancement_tpu_torch.ops.curves import apply_curves
from low_light_image_enhancement_tpu_torch.ops.denoise import denoise_planar
from low_light_image_enhancement_tpu_torch.ops.filters import (
    roll2d,
    separable_blur,
)

__all__ = ["MARGIN", "illumination_boost", "denoise_tail",
           "enhance_core_padded", "pad_edge", "pad_planar",
           "replicate_margin_cols"]


def pad_edge(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicate pad of the last two axes, for any dtype and device
    (``F.pad(mode="replicate")`` semantics, by clamped index gathers)."""
    h, w = x.shape[-2:]
    dev = x.device
    rows = torch.clamp(torch.arange(-top, h + bottom, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-left, w + right, device=dev), 0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)


def pad_planar(x: torch.Tensor, plan, h: int, w: int) -> torch.Tensor:
    """Edge-replicate pad (..., C, H, W) to the plan's canvas
    (``kernels.striping.CanvasPlan``), with exactly ``margin`` rows/cols
    before the image origin."""
    m = plan.margin
    return pad_edge(x, m, plan.padded_h - h - m, m, plan.padded_w - w - m)


def replicate_margin_cols(y: torch.Tensor, w: int,
                          m: int = MARGIN) -> torch.Tensor:
    """Replace canvas cols [0, m) by col m and cols [m + w, Wp) by col
    m + w - 1: the wrap-shift blur of the hybrid boost leaves
    opposite-edge content there, inside the curve CNN's reach."""
    wb = y.shape[-1]
    col = torch.arange(wb, device=y.device)
    left = y[..., :, m:m + 1]
    right = y[..., :, m + w - 1:m + w]
    y = torch.where(col < m, left, y)
    return torch.where(col >= m + w, right, y)


def illumination_boost(xp: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """Retinex stage: x * clip(blur(maxRGB), eps, 1) ** (gamma - 1), with the
    power written as exp((gamma - 1) * log L)."""
    l0 = torch.amax(xp, dim=-3)
    l = separable_blur(l0, cfg.blur_radius, cfg.blur_sigma, roll2d)
    l = torch.clamp(l, cfg.illum_eps, 1.0)
    boost = torch.exp((cfg.gamma - 1.0) * torch.log(l))
    return torch.clamp(xp * boost[..., None, :, :], 0.0, 1.0)


def denoise_tail(x: torch.Tensor, cfg: PipelineConfig) -> torch.Tensor:
    """The configured denoise on a padded planar canvas (wrap shifts). The
    guided radius and eps are passed on: the cores' own defaults are not the
    config's."""
    inv2s2 = 1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma)
    return denoise_planar(x, inv2s2, cfg.denoise_strength, roll2d,
                          cfg.denoise_kernel, cfg.denoise_guide,
                          cfg.denoise_taps, cfg.guided_radius,
                          cfg.guided_eps)


def enhance_core_padded(
    xp: torch.Tensor,
    cfg: PipelineConfig,
    curve_maps: Optional[torch.Tensor] = None,
    do_denoise: bool = True,
) -> torch.Tensor:
    """Full enhance graph on a padded planar image ``(..., 3, Hp, Wp)``.

    ``curve_maps`` (``(..., n_iter, 3, Hp, Wp)``) must be given for the
    "curve"/"hybrid" methods.
    """
    x = xp
    if cfg.method in ("retinex", "hybrid"):
        x = illumination_boost(x, cfg)
    if cfg.method in ("curve", "hybrid"):
        if curve_maps is None:
            raise ValueError(f"method={cfg.method!r} requires curve_maps")
        x = torch.clamp(apply_curves(x, curve_maps), 0.0, 1.0)
    if do_denoise and cfg.denoise_strength > 0.0:
        x = denoise_tail(x, cfg)
    return torch.clamp(x, 0.0, 1.0)
