"""Windowed-filter building blocks: sums of 2-D shifts.

Same taps, same accumulation order and same coefficients as the JAX
package's ``ops/filters.py``, so the plain versions here and the CUDA
kernels in ``kernels/csrc`` reproduce its floats.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import torch


@lru_cache(maxsize=None)
def gaussian_kernel_1d(radius: int, sigma: float) -> Tuple[float, ...]:
    """Normalized 1-D Gaussian taps as Python floats (double precision)."""
    xs = [math.exp(-0.5 * (i / sigma) ** 2) for i in range(-radius, radius + 1)]
    total = sum(xs)
    return tuple(x / total for x in xs)


def roll2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Circular shift over the last two axes: out[y, x] = in[y-dy, x-dx]."""
    if dy:
        x = torch.roll(x, dy, dims=-2)
    if dx:
        x = torch.roll(x, dx, dims=-1)
    return x


def _shift1d_clamp(x: torch.Tensor, d: int, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(n, device=x.device) - d, 0, n - 1)
    return torch.index_select(x, dim, idx)


def shift2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Edge-replicating shift over the last two axes:
    out[y, x] = in[clamp(y - dy), clamp(x - dx)]."""
    if dy:
        x = _shift1d_clamp(x, dy, x.ndim - 2)
    if dx:
        x = _shift1d_clamp(x, dx, x.ndim - 1)
    return x


def separable_blur(x, radius, sigma, shift_fn):
    """Separable Gaussian blur: the vertical taps first, in ascending tap
    order, each pass starting from its first term (not from zero)."""
    taps = gaussian_kernel_1d(radius, sigma)
    acc = None
    for i, t in enumerate(taps):
        term = t * shift_fn(x, i - radius, 0)
        acc = term if acc is None else acc + term
    out = None
    for j, t in enumerate(taps):
        term = t * shift_fn(acc, 0, j - radius)
        out = term if out is None else out + term
    return out
