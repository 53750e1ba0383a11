"""Gamma / tone-curve correction."""

from __future__ import annotations

import torch


def gamma_correct(x: torch.Tensor, gamma: float) -> torch.Tensor:
    """x**gamma on [0,1] with a safe clip; gamma < 1 brightens."""
    return torch.pow(torch.clamp(x, 0.0, 1.0), gamma)
