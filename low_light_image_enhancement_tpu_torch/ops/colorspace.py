"""Colour-space conversions and u8 normalization.

``normalize_u8`` and ``quantize_u8`` take planar or HWC, any leading dims;
the conversions take planar RGB ``(..., 3, H, W)`` float32 in [0, 1]. The
arithmetic follows the JAX package's ``ops/colorspace.py`` op for op.
"""

from __future__ import annotations

import math

import torch

_U8_SCALE = 1.0 / 255.0


def normalize_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]: a multiply by 1/255, not a divide."""
    return x_u8.to(torch.float32) * _U8_SCALE


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8, rounding half to even (``torch.round``)."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)


# --------------------------------------------------------------------------- #
# HSV (planar (..., 3, H, W), h in [0, 1))
# --------------------------------------------------------------------------- #

def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """Planar RGB -> planar HSV, h in [0,1)."""
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    safe_c = torch.where(c == 0, 1.0, c)
    # the hue sector chosen without data-dependent control flow
    hr = torch.remainder((g - b) / safe_c, 6.0)
    hg = (b - r) / safe_c + 2.0
    hb = (r - g) / safe_c + 4.0
    h = torch.where(v == r, hr, torch.where(v == g, hg, hb))
    h = torch.where(c == 0, 0.0, h / 6.0)
    s = torch.where(v == 0, 0.0, c / torch.where(v == 0, 1.0, v))
    return torch.stack([h, s, v], dim=-3)


def _select(conds, choices, default):
    """``jnp.select``: the choice of the first true condition, nested
    ``torch.where`` in the same order."""
    out = default
    for cond, choice in zip(reversed(conds), reversed(choices)):
        out = torch.where(cond, choice, out)
    return out


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """Planar HSV -> planar RGB."""
    h, s, v = hsv[..., 0, :, :], hsv[..., 1, :, :], hsv[..., 2, :, :]
    h6 = h * 6.0
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(h6, 2.0) - 1.0))
    m = v - c
    zeros = torch.zeros_like(c)
    sector = torch.floor(h6).to(torch.int32) % 6
    conds = [sector == k for k in range(5)]
    r = _select(conds, [c, x, zeros, zeros, x], c)
    g = _select(conds, [x, c, c, x, zeros], zeros)
    b = _select(conds, [zeros, zeros, x, c, c], x)
    return torch.stack([r + m, g + m, b + m], dim=-3)


# --------------------------------------------------------------------------- #
# YCbCr (BT.601 full-range)
# --------------------------------------------------------------------------- #

def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    r, g, b = rgb[..., 0, :, :], rgb[..., 1, :, :], rgb[..., 2, :, :]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 0.5 + (b - y) * (0.5 / (1.0 - 0.114))
    cr = 0.5 + (r - y) * (0.5 / (1.0 - 0.299))
    return torch.stack([y, cb, cr], dim=-3)


def ycbcr_to_rgb(ycc: torch.Tensor) -> torch.Tensor:
    y, cb, cr = ycc[..., 0, :, :], ycc[..., 1, :, :], ycc[..., 2, :, :]
    r = y + (cr - 0.5) * ((1.0 - 0.299) / 0.5)
    b = y + (cb - 0.5) * ((1.0 - 0.114) / 0.5)
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return torch.stack([r, g, b], dim=-3)


# --------------------------------------------------------------------------- #
# HVI: intensity-collapsed polar chroma, in a simplified, exactly invertible
# form
# --------------------------------------------------------------------------- #

_HVI_EPS = 1e-8
_TWO_PI = 2.0 * math.pi


def rgb_to_hvi(rgb: torch.Tensor) -> torch.Tensor:
    """RGB -> (H, V, I): I = max(RGB); (H, V) = k*s*(cos, sin)(2*pi*hue)
    with the collapse factor k = sin(pi*I/2) + eps, which shrinks the
    chroma plane in dark regions."""
    hsv = rgb_to_hsv(rgb)
    h, s, i = hsv[..., 0, :, :], hsv[..., 1, :, :], hsv[..., 2, :, :]
    k = torch.sin(math.pi * i * 0.5) + _HVI_EPS
    hh = k * s * torch.cos(_TWO_PI * h)
    vv = k * s * torch.sin(_TWO_PI * h)
    return torch.stack([hh, vv, i], dim=-3)


def hvi_to_rgb(hvi: torch.Tensor) -> torch.Tensor:
    hh, vv, i = hvi[..., 0, :, :], hvi[..., 1, :, :], hvi[..., 2, :, :]
    k = torch.sin(math.pi * i * 0.5) + _HVI_EPS
    s = torch.sqrt(hh * hh + vv * vv) / k
    s = torch.clamp(s, 0.0, 1.0)
    h = torch.remainder(torch.atan2(vv, hh) / _TWO_PI, 1.0)
    return hsv_to_rgb(torch.stack([h, s, i], dim=-3))
