"""Guided filter (He et al.): edge-aware smoothing.

Planar layout, images are ``(..., H, W)`` planes. Two forms, as in the JAX
package's ``ops/guided.py``:

- the public ops (``box_mean``, ``guided_filter``, ``guided_denoise``) take
  box sums on integral images (``cumsum`` and two shifted differences per
  axis), with true means at the image edges;
- the shift cores (``box_mean_shift``, ``guided_core_shift``,
  ``guided_joint_core_shift``) run on a replicate-padded canvas through a
  ``shift_fn`` (``roll2d``), tap for tap as the JAX package's, and are the
  plain version of the guided arm of K5 (``kernels/tiled_denoise.py``),
  whose CUDA code repeats them in ``kernels/csrc/guided.cuh``.
"""

from __future__ import annotations

import torch


def _box_sum_1d(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    x = torch.movedim(x, dim, -1)
    n = x.shape[-1]
    c = torch.cumsum(x, dim=-1)
    # window sum at i = c[min(i + r, n - 1)] - c[i - r - 1]   (c[-1] := 0)
    idx = torch.arange(n, device=x.device)
    c_hi = c[..., torch.clamp(idx + r, 0, n - 1)]
    lo = idx - r - 1
    c_lo = torch.where(lo >= 0, c[..., torch.clamp(lo, 0, n - 1)],
                       torch.zeros((), dtype=c.dtype, device=c.device))
    return torch.movedim(c_hi - c_lo, -1, dim)


def _box_sum(x: torch.Tensor, r: int) -> torch.Tensor:
    return _box_sum_1d(_box_sum_1d(x, r, -1), r, -2)


def box_mean(x: torch.Tensor, radius: int) -> torch.Tensor:
    """(..., H, W) -> mean over the (2r+1)^2 window, true means at the
    edges (the window sum over the same sum of a ones plane)."""
    if radius < 1:
        return x
    ones = torch.ones(x.shape[-2:], dtype=x.dtype, device=x.device)
    return _box_sum(x, radius) / _box_sum(ones, radius)


def guided_filter(p: torch.Tensor, guide: torch.Tensor, radius: int = 2,
                  eps: float = 1e-3) -> torch.Tensor:
    """Filter plane(s) ``p`` (..., H, W) with a single-plane ``guide``
    (broadcastable to ``p``): locally a linear transform of the guide."""
    m_i = box_mean(guide, radius)
    m_p = box_mean(p, radius)
    cov = box_mean(guide * p, radius) - m_i * m_p
    var = box_mean(guide * guide, radius) - m_i * m_i
    a = cov / (var + eps)
    b = m_p - a * m_i
    return box_mean(a, radius) * guide + box_mean(b, radius)


def guided_denoise(x: torch.Tensor, radius: int = 2, eps: float = 1e-3,
                   strength: float = 1.0) -> torch.Tensor:
    """(..., 3, H, W) RGB denoise, every channel guided by the luminance
    plane, blended by ``strength``."""
    r, g, b = x[..., 0, :, :], x[..., 1, :, :], x[..., 2, :, :]
    luma = 0.299 * r + 0.587 * g + 0.114 * b
    q = guided_filter(x, luma[..., None, :, :], radius, eps)
    return x + strength * (q - x)


# --------------------------------------------------------------------- #
# Shift cores: the padded-canvas form, the plain version of K5's guided arm
# --------------------------------------------------------------------- #

def box_mean_shift(x: torch.Tensor, radius: int, shift_fn) -> torch.Tensor:
    """(2r+1)^2 separable box mean over the last two axes via shifts: the
    vertical pass, then the horizontal one; each pass adds the taps at -t
    and +t to the centre, t ascending, and multiplies by 1/(2r+1)."""
    k = 1.0 / (2 * radius + 1)
    for dy, dx in ((1, 0), (0, 1)):
        acc = x
        for t in range(1, radius + 1):
            acc = acc + shift_fn(x, t * dy, t * dx) \
                + shift_fn(x, -t * dy, -t * dx)
        x = acc * k
    return x


def guided_core_shift(x, eps, strength, shift_fn, radius: int = 2):
    """Self-guided filter of one plane (the guide is the plane itself)."""
    m = box_mean_shift(x, radius, shift_fn)
    var = box_mean_shift(x * x, radius, shift_fn) - m * m
    a = var / (var + eps)
    b = m - a * m
    q = box_mean_shift(a, radius, shift_fn) * x \
        + box_mean_shift(b, radius, shift_fn)
    return x + strength * (q - x)


def guided_joint_core_shift(planes, eps, strength, shift_fn,
                            radius: int = 2):
    """Luma-guided filter of the 3 channel planes, with the joint
    bilateral's channel-mean guide."""
    g = (planes[0] + planes[1] + planes[2]) * (1.0 / 3.0)
    m_g = box_mean_shift(g, radius, shift_fn)
    var = box_mean_shift(g * g, radius, shift_fn) - m_g * m_g
    inv = 1.0 / (var + eps)
    out = []
    for p in planes:
        m_p = box_mean_shift(p, radius, shift_fn)
        cov = box_mean_shift(g * p, radius, shift_fn) - m_g * m_p
        a = cov * inv
        b = m_p - a * m_g
        q = box_mean_shift(a, radius, shift_fn) * g \
            + box_mean_shift(b, radius, shift_fn)
        out.append(p + strength * (q - p))
    return out
