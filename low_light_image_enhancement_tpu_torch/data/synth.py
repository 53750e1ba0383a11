"""Deterministic synthetic low-light pairs (LOL-shaped fixtures).

A numpy-only copy of the JAX package's ``data/synth.py``: the same seeds
give the same images. It is copied rather than imported because importing
anything from the JAX package imports ``jax``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _smooth_field(rng: np.random.Generator, h: int, w: int, c: int,
                  grid: int = 6) -> np.ndarray:
    """Bilinear upsample of a coarse random grid -> (h, w, c) in [0, 1]."""
    coarse = rng.random((grid, grid, c), dtype=np.float64)
    ys = np.linspace(0, grid - 1, h)
    xs = np.linspace(0, grid - 1, w)
    y0 = np.clip(ys.astype(np.int64), 0, grid - 2)
    x0 = np.clip(xs.astype(np.int64), 0, grid - 2)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    c00 = coarse[y0][:, x0]
    c01 = coarse[y0][:, x0 + 1]
    c10 = coarse[y0 + 1][:, x0]
    c11 = coarse[y0 + 1][:, x0 + 1]
    out = (c00 * (1 - fy) * (1 - fx) + c01 * (1 - fy) * fx
           + c10 * fy * (1 - fx) + c11 * fy * fx)
    return out.astype(np.float32)


def synth_pair(
    index: int, h: int = 400, w: int = 600, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (low_u8, high_u8), both (h, w, 3) uint8: a smooth ground truth
    under a smooth illumination field at a log-uniform exposure (3%..45%),
    with a per-channel color cast and shot + read noise."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    base = _smooth_field(rng, h, w, 3, grid=6)
    texture = _smooth_field(rng, h, w, 3, grid=24) - 0.5
    fine = _smooth_field(rng, h, w, 3, grid=48) - 0.5
    gt = np.clip(0.15 + 0.72 * base + 0.22 * texture + 0.10 * fine,
                 0.02, 0.98)

    level = np.exp(rng.uniform(np.log(0.03), np.log(0.45)))  # exposure
    illum = (0.4 + 0.6 * _smooth_field(rng, h, w, 1, grid=4)) * level
    cast = 1.0 + rng.uniform(-0.25, 0.25, size=(1, 1, 3))
    cast = (cast / cast.mean()).astype(np.float32)  # hue shift, not gain
    signal = gt * illum * cast
    read = rng.uniform(0.004, 0.015)
    shot = rng.uniform(0.0005, 0.003)
    sigma = np.sqrt(read * read + shot * np.clip(signal, 0.0, 1.0))
    noise = rng.normal(0.0, 1.0, size=(h, w, 3)).astype(np.float32) * sigma
    low = np.clip(signal + noise, 0.0, 1.0)

    to_u8 = lambda x: np.clip(np.rint(x * 255.0), 0, 255).astype(np.uint8)
    return to_u8(low), to_u8(gt)


def synth_batch(
    n: int, h: int = 400, w: int = 600, seed: int = 0, start: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (lows, highs) stacked uint8 (n, h, w, 3)."""
    lows, highs = zip(*(synth_pair(start + i, h, w, seed) for i in range(n)))
    return np.stack(lows), np.stack(highs)
