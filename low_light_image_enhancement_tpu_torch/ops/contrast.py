"""Classical global and local contrast ops: percentile autocontrast,
histogram equalization and CLAHE, the no-weights baselines every low-light
toolkit carries. Planar images; the arithmetic follows the JAX package's
``ops/contrast.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _percentile_pair(flat: torch.Tensor, low_pct: float, high_pct: float):
    """``jnp.percentile``'s linear interpolation, at two percentiles of
    each row of ``flat`` (..., n), from one sort. The positions and weights
    are float32 as there; ``torch.quantile`` is not used, since it refuses
    more than 2**24 values (a 4K RGB frame has 24.9M)."""
    n = flat.shape[-1]
    srt = torch.sort(flat, dim=-1).values
    out = []
    for pct in (low_pct, high_pct):
        q = (np.float32(pct) / np.float32(100.0)) * (np.float32(n)
                                                       - np.float32(1.0))
        lo, hi = np.floor(q), np.ceil(q)
        w_hi = np.float32(q - lo)
        w_lo = np.float32(np.float32(1.0) - w_hi)
        last = np.float32(n - 1)
        lo = int(np.clip(lo, np.float32(0.0), last))
        hi = int(np.clip(hi, np.float32(0.0), last))
        out.append(srt[..., lo:lo + 1] * float(w_lo)
                   + srt[..., hi:hi + 1] * float(w_hi))
    return out


def autocontrast(x: torch.Tensor, low_pct: float = 1.0,
                 high_pct: float = 99.0,
                 per_channel: bool = False) -> torch.Tensor:
    """Percentile stretch to [0, 1] over the last three axes (or, with
    ``per_channel``, the last two)."""
    k = 2 if per_channel else 3
    lead = x.shape[:-k]
    lo, hi = _percentile_pair(x.reshape(*lead, -1), low_pct, high_pct)
    keep = lead + (1,) * k
    lo, hi = lo.reshape(keep), hi.reshape(keep)
    return torch.clamp((x - lo) / torch.clamp(hi - lo, min=1e-6), 0.0, 1.0)


def _bin_index(x: torch.Tensor, bins: int) -> torch.Tensor:
    """Each value's histogram bin: ``int(v * (bins - 1))`` clipped."""
    return torch.clamp((x * (bins - 1)).to(torch.int32), 0,
                       bins - 1).to(torch.int64)


def equalize_hist(x: torch.Tensor, bins: int = 256) -> torch.Tensor:
    """Global histogram equalization over the last two axes of planes
    (..., H, W) in [0, 1], via the empirical CDF; each leading index is
    equalized on its own."""
    shape = x.shape
    idx = _bin_index(x.reshape(-1, shape[-2] * shape[-1]), bins)
    hist = torch.zeros((idx.shape[0], bins), dtype=x.dtype, device=x.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx, dtype=x.dtype))
    cdf = torch.cumsum(hist, dim=1)
    cdf = cdf / cdf[:, -1:]
    return torch.gather(cdf, 1, idx).reshape(shape)


def clahe(x: torch.Tensor, tiles: int = 8, clip_limit: float = 2.0,
          bins: int = 256) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization over the last two
    axes of (..., H, W) planes in [0, 1].

    Per-tile histograms by one scatter-add, each clipped at ``clip_limit``
    times the tile's uniform bin height (floored at one count) with the
    excess spread uniformly, per-tile CDF tables, and a bilinear blend of
    the four surrounding tiles' mappings per pixel. The image is
    edge-padded up to a tile multiple and cropped back; the padded pixels
    carry zero histogram weight, and a tile that is all padding maps by the
    identity ramp."""
    if tiles < 1:
        raise ValueError(f"tiles must be >= 1, got {tiles}")
    shape = x.shape
    h, w = shape[-2], shape[-1]
    th = -(-h // tiles)
    tw = -(-w // tiles)
    hp, wp = th * tiles, tw * tiles
    dev = x.device
    xp = F.pad(x.reshape(-1, 1, h, w), (0, wp - w, 0, hp - h),
               mode="replicate")[:, 0]
    n = xp.shape[0]
    valid = ((torch.arange(hp, device=dev) < h)[:, None]
             & (torch.arange(wp, device=dev) < w)[None, :]).to(torch.float32)
    idx = _bin_index(xp, bins)                                  # (n, hp, wp)
    ty = torch.arange(hp, device=dev) // th
    tx = torch.arange(wp, device=dev) // tw
    tid = ty[:, None] * tiles + tx[None, :]
    nt = tiles * tiles
    hist = torch.zeros((n, nt * bins), dtype=torch.float32, device=dev)
    hist.scatter_add_(1, (tid * bins + idx).reshape(n, -1),
                      valid.reshape(1, -1).expand(n, -1))
    hist = hist.reshape(n, nt, bins)
    # the contrast limit, floored at one count: below it every occupied
    # bin of a small tile would clip, flattening it to an identity ramp
    count = torch.sum(hist, dim=2, keepdim=True)
    limit = torch.clamp(clip_limit * count / bins, min=1.0)
    excess = torch.sum(torch.clamp(hist - limit, min=0.0), dim=2,
                       keepdim=True)
    hist = torch.minimum(hist, limit) + excess / bins
    cdf = torch.cumsum(hist, dim=2)
    ramp = torch.arange(bins, dtype=torch.float32, device=dev) / (bins - 1)
    cdf = torch.where(cdf[..., -1:] > 0,
                      cdf / torch.clamp(cdf[..., -1:], min=1e-9),
                      ramp)
    cdf = cdf.reshape(n, nt * bins)
    # the blend's weights: distance to the tile centres, clamped at the
    # border tiles
    cy = (torch.arange(hp, dtype=torch.float32, device=dev) - th / 2.0
          + 0.5) / th
    cx = (torch.arange(wp, dtype=torch.float32, device=dev) - tw / 2.0
          + 0.5) / tw
    y0 = torch.clamp(torch.floor(cy).to(torch.int64), 0, tiles - 1)
    x0 = torch.clamp(torch.floor(cx).to(torch.int64), 0, tiles - 1)
    y1 = torch.clamp(y0 + 1, max=tiles - 1)
    x1 = torch.clamp(x0 + 1, max=tiles - 1)
    wy = torch.clamp(cy - y0, 0.0, 1.0)[:, None]
    wx = torch.clamp(cx - x0, 0.0, 1.0)[None, :]

    def lut(tyi, txi):
        t = tyi[:, None] * tiles + txi[None, :]
        return torch.gather(cdf, 1, (t * bins + idx).reshape(n, -1)
                            ).reshape(n, hp, wp)

    top = lut(y0, x0) * (1 - wx) + lut(y0, x1) * wx
    bot = lut(y1, x0) * (1 - wx) + lut(y1, x1) * wx
    out = top * (1 - wy) + bot * wy
    return out.reshape(shape[:-2] + (hp, wp))[..., :h, :w].to(x.dtype)
