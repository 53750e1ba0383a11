"""Retinex decomposition: illumination-map estimation and reflectance.

Classical max-RGB Retinex: the illumination map is a smoothed per-pixel max
over RGB; reflectance is the input divided by the illumination; the
enhancement brightens the illumination with a gamma (< 1) and recombines.
The arithmetic follows the JAX package's ``ops/retinex.py``.
"""

from __future__ import annotations

import torch

from low_light_image_enhancement_tpu_torch.ops.filters import gaussian_blur


def illumination_map(rgb: torch.Tensor, radius: int = 2, sigma: float = 1.0,
                     mode: str = "clamp") -> torch.Tensor:
    """Smoothed max-RGB illumination estimate:
    (..., 3, H, W) -> (..., H, W)."""
    l0 = torch.amax(rgb, dim=-3)
    return gaussian_blur(l0, radius=radius, sigma=sigma, mode=mode)


def reflectance(rgb: torch.Tensor, illum: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
    """R = I / max(L, eps), the illumination plane broadcast over RGB."""
    return rgb / torch.clamp(illum, min=eps)[..., None, :, :]


def retinex_enhance(rgb: torch.Tensor, gamma: float = 0.45, eps: float = 1e-3,
                    radius: int = 2, sigma: float = 1.0,
                    mode: str = "clamp") -> torch.Tensor:
    """The whole classical enhance, R * L**gamma, in the fused form
    x * L_safe**(gamma - 1) = x * exp((gamma - 1) * log L_safe): the
    formula the kernels use."""
    illum = illumination_map(rgb, radius=radius, sigma=sigma, mode=mode)
    l_safe = torch.clamp(illum, eps, 1.0)
    boost = torch.exp((gamma - 1.0) * torch.log(l_safe))
    return torch.clamp(rgb * boost[..., None, :, :], 0.0, 1.0)
