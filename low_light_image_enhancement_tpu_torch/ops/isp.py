"""A minimal RAW -> sRGB ISP: bilinear RGGB demosaic, white balance, a
colour-correction matrix, and ``raw_to_srgb`` composing them, which feeds
the enhancement pipeline from RAW sensor data.

Plain PyTorch on planar layouts, as the JAX package's ``ops/isp.py`` is
plain jnp (it has no RAW kernel). The demosaic is roll-based neighbour
averaging: edge rows and columns take wrap neighbours, so callers pad and
crop for exact borders, as the pipeline does.
"""

from __future__ import annotations

import torch

from low_light_image_enhancement_tpu_torch.ops.filters import roll2d


def demosaic_bilinear_rggb(raw: torch.Tensor) -> torch.Tensor:
    """(..., H, W) RGGB Bayer mosaic (f32 [0,1], H and W even) ->
    (..., 3, H, W) RGB by bilinear interpolation.

    Pattern (top-left 2x2): R G / G B.
    """
    h, w = raw.shape[-2], raw.shape[-1]
    ys = torch.arange(h, device=raw.device).reshape(-1, 1)
    xs = torch.arange(w, device=raw.device).reshape(1, -1)
    r_mask = ((ys % 2 == 0) & (xs % 2 == 0)).to(raw.dtype)
    b_mask = ((ys % 2 == 1) & (xs % 2 == 1)).to(raw.dtype)
    g_mask = 1.0 - r_mask - b_mask

    def interp(masked, mask):
        # the normalized 3x3 neighbourhood average of the known samples
        acc = torch.zeros_like(masked)
        wacc = torch.zeros_like(mask)
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                wgt = 1.0 if (dy, dx) == (0, 0) else (
                    0.5 if dy == 0 or dx == 0 else 0.25)
                acc = acc + wgt * roll2d(masked, dy, dx)
                wacc = wacc + wgt * roll2d(mask, dy, dx)
        return acc / torch.clamp(wacc, min=1e-8)

    r = interp(raw * r_mask, r_mask)
    g = interp(raw * g_mask, g_mask)
    b = interp(raw * b_mask, b_mask)
    return torch.stack([r, g, b], dim=-3)


def white_balance(rgb: torch.Tensor, gains) -> torch.Tensor:
    """Per-channel gains (3,) applied to planar RGB (..., 3, H, W)."""
    gains = torch.as_tensor(gains, dtype=rgb.dtype,
                            device=rgb.device).reshape(3, 1, 1)
    return torch.clamp(rgb * gains, 0.0, 1.0)


def gray_world_gains(rgb: torch.Tensor) -> torch.Tensor:
    """Auto white balance: the gains that equalize the channel means to the
    green channel's mean (the gray-world assumption). Returns (..., 3)."""
    means = torch.mean(rgb, dim=(-2, -1))
    g = means[..., 1:2]
    return g / torch.clamp(means, min=1e-6)


def color_correction(rgb: torch.Tensor, ccm) -> torch.Tensor:
    """3x3 colour-correction matrix on planar RGB:
    out_c = sum_k M[c,k] * in_k, summed in k's order as three multiply-adds
    of the matrix's float32 entries (no GEMM: the same floats on every
    device)."""
    m = torch.as_tensor(ccm, dtype=rgb.dtype).reshape(3, 3).tolist()
    planes = [rgb[..., k, :, :] for k in range(3)]
    out = torch.stack([row[0] * planes[0] + row[1] * planes[1]
                       + row[2] * planes[2] for row in m], dim=-3)
    return torch.clamp(out, 0.0, 1.0)


# A mild default CCM (identity with a slight cross-channel correction).
DEFAULT_CCM = (
    (1.06, -0.03, -0.03),
    (-0.03, 1.06, -0.03),
    (-0.03, -0.03, 1.06),
)


def raw_to_srgb(raw: torch.Tensor, wb_gains=None, ccm=DEFAULT_CCM,
                gamma: float = 1.0 / 2.2) -> torch.Tensor:
    """RGGB RAW (..., H, W) f32 -> display RGB (..., 3, H, W): demosaic ->
    white balance (gray-world when the gains are omitted) -> CCM -> display
    gamma. Feed the result to ``EnhancePipeline`` (planar f32) for the
    low-light enhancement of RAW captures."""
    rgb = demosaic_bilinear_rggb(raw)
    gains = gray_world_gains(rgb) if wb_gains is None else \
        torch.as_tensor(wb_gains, device=rgb.device)
    if gains.ndim > 1:  # batched gray-world gains
        gains = gains.reshape(gains.shape[:-1] + (3, 1, 1))
        rgb = torch.clamp(rgb * gains, 0.0, 1.0)
    else:
        rgb = white_balance(rgb, gains)
    rgb = color_correction(rgb, ccm)
    return torch.clamp(rgb, 0.0, 1.0) ** gamma
