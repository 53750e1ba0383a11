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


def upsample_int(x: torch.Tensor, ds: int, axis: int,
                 shift_fn) -> torch.Tensor:
    """Integer-factor bilinear upsample along ``axis`` (one of the last
    two), the upsample of record for curve maps: repeat, two shifts, then
    the per-phase blend ``lo * (1 - f) + hi * f`` with
    ``lo[i] = rep[i - ds/2]``, ``hi[i] = rep[i + ds/2]``, ``rep[i] =
    x[i // ds]`` and f depending only on ``i mod ds``. ``ds`` is 1 or
    even."""
    if ds == 1:
        return x
    if ds % 2:
        raise ValueError(f"upsample_int needs an even factor, got {ds}")
    ax = axis % x.ndim
    rep = torch.repeat_interleave(x, ds, dim=ax)
    half = ds // 2
    dy, dx = (half, 0) if ax == rep.ndim - 2 else (0, half)
    lo = shift_fn(rep, dy, dx)
    hi = shift_fn(rep, -dy, -dx)
    f = upsample_phase(rep.shape[-2:], ds, ax - (x.ndim - 2), x.dtype,
                       x.device)
    return lo * (1.0 - f) + hi * f


def upsample_maps(x: torch.Tensor, ds: int) -> torch.Tensor:
    """``upsample_int`` over both of the last two axes with clamp shifts,
    columns first, then rows: the curve maps' upsample of record."""
    x = upsample_int(x, ds, axis=-1, shift_fn=shift2d)
    return upsample_int(x, ds, axis=-2, shift_fn=shift2d)


@lru_cache(maxsize=None)
def _phase_consts(ds: int) -> Tuple[float, ...]:
    return tuple(float((((p + 0.5) / ds) - 0.5) % 1.0) for p in range(ds))


def upsample_phase(shape2d, ds: int, axis2d: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    """The (H, W) blend-weight plane of ``upsample_int``: the phase
    constant of ``index mod ds`` along ``axis2d`` (0 = rows, 1 = cols),
    each rounded once from double to ``dtype``."""
    n = shape2d[axis2d]
    consts = torch.tensor(_phase_consts(ds), dtype=dtype, device=device)
    f = consts[torch.arange(n, device=device) % ds]
    f = f[:, None] if axis2d == 0 else f[None, :]
    return f.expand(tuple(shape2d))


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


def gaussian_blur(x: torch.Tensor, radius: int = 2, sigma: float = 1.0,
                  mode: str = "clamp") -> torch.Tensor:
    """Separable Gaussian blur over the last two axes.

    mode="clamp": edge-replicate boundary (the public op's).
    mode="wrap":  circular boundary, for inputs padded beforehand."""
    shift_fn = shift2d if mode == "clamp" else roll2d
    return separable_blur(x, radius, sigma, shift_fn)
