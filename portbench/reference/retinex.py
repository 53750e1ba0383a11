"""Plain reference of the retinex configuration: max-RGB illumination,
Gaussian blur, gain exp((gamma - 1) log L), the luma-guided separable
bilateral, quantization to u8; on the image edge-replicated by its
receptive radius (blur radius + 1), filtered with wrap-around shifts,
cropped. The reference runs in float32; the control in bfloat16."""

from __future__ import annotations

import torch

from portbench.reference.common import (
    bilateral,
    illumination_boost,
    normalize,
    pad_edge,
    quantize,
)


def enhance(x_u8: torch.Tensor, p: dict, params=None,
            control: bool = False) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (B, H, W, 3) u8."""
    dtype = torch.bfloat16 if control else torch.float32
    _, h, w, _ = x_u8.shape
    m = p["blur_radius"] + 1
    xp = pad_edge(normalize(x_u8.permute(0, 3, 1, 2), dtype), m, m, m, m)
    y = bilateral(illumination_boost(xp, p), p)
    return quantize(y[..., m:m + h, m:m + w]).permute(0, 2, 3, 1) \
        .contiguous()
