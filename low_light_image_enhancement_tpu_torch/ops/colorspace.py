"""u8 normalization and quantization (planar or HWC, any leading dims)."""

from __future__ import annotations

import torch

_U8_SCALE = 1.0 / 255.0


def normalize_u8(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [0,255] -> float32 [0,1]: a multiply by 1/255, not a divide."""
    return x_u8.to(torch.float32) * _U8_SCALE


def quantize_u8(x: torch.Tensor) -> torch.Tensor:
    """float [0,1] -> uint8, rounding half to even (``torch.round``)."""
    return torch.clamp(torch.round(x * 255.0), 0.0, 255.0).to(torch.uint8)
