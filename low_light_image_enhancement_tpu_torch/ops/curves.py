"""Iterative light-enhancement curves (Zero-DCE family)."""

from __future__ import annotations

import torch


def apply_curves(x: torch.Tensor, curve_params: torch.Tensor) -> torch.Tensor:
    """Apply ``n_iter`` iterations of ``x <- x + a * x * (1 - x)``.

    Args:
      x: planar image ``(..., 3, H, W)`` in [0, 1].
      curve_params: ``(..., n_iter, 3, H, W)`` curve maps in [-1, 1].
    """
    for i in range(curve_params.shape[-4]):
        a = curve_params[..., i, :, :, :]
        x = x + a * x * (1.0 - x)
    return x
