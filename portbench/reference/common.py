"""The per-pixel stages in plain PyTorch, written from the semantics of the
JAX package's pure path (``core.py``, ``ops/filters.py``,
``ops/denoise.py``): the image edge-replicated by a margin, the filters
as wrap-around shifts of the padded canvas (whose wrapped values stay in
the margin), then cropped. ``dtype`` is the precision every stage runs in:
float32 for the reference, lower for a control. Imports nothing of the
program."""

from __future__ import annotations

import math

import torch

SPATIAL_1D = (0.25, 0.5, 0.25)


def normalize(x_u8: torch.Tensor, dtype) -> torch.Tensor:
    """u8 -> [0, 1]: a multiply by 1/255."""
    return x_u8.to(dtype) * (1.0 / 255.0)


def quantize(y: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> u8, clipped, rounded half to even."""
    y = torch.clamp(y, 0.0, 1.0)
    return torch.clamp(torch.round(y * 255.0), 0.0, 255.0).to(torch.uint8)


def roll2d(x: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[y, x] = in[y - dy, x - dx], wrapping over the last two axes."""
    if dy:
        x = torch.roll(x, dy, dims=-2)
    if dx:
        x = torch.roll(x, dx, dims=-1)
    return x


def gaussian_taps(radius: int, sigma: float):
    xs = [math.exp(-0.5 * (i / sigma) ** 2)
          for i in range(-radius, radius + 1)]
    total = sum(xs)
    return [v / total for v in xs]


def separable_blur(x: torch.Tensor, radius: int, sigma: float
                   ) -> torch.Tensor:
    """Rows first, taps in ascending order, each pass starting from its
    first term."""
    taps = gaussian_taps(radius, sigma)
    acc = None
    for i, t in enumerate(taps):
        term = t * roll2d(x, i - radius, 0)
        acc = term if acc is None else acc + term
    out = None
    for j, t in enumerate(taps):
        term = t * roll2d(acc, 0, j - radius)
        out = term if out is None else out + term
    return out


def illumination_boost(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x * clip(blur(max RGB), eps, 1) ** (gamma - 1), the power as
    exp((gamma - 1) * log L); x planar (..., 3, H, W)."""
    l0 = torch.amax(x, dim=-3)
    l = torch.clamp(separable_blur(l0, p["blur_radius"], p["blur_sigma"]),
                    p["illum_eps"], 1.0)
    gain = torch.exp((p["gamma"] - 1.0) * torch.log(l))
    return torch.clamp(x * gain[..., None, :, :], 0.0, 1.0)


def _range_weight(d2, inv2s2, kind):
    if kind == "exp":
        return torch.exp(-d2 * inv2s2)
    u = torch.clamp(1.0 - d2 * (inv2s2 * (1.0 / 3.0)), min=0.0)
    return u * u


def bilateral(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The luma-guided separable bilateral (3 taps along rows, then 3 along
    columns of the result, the guide recomputed from each pass's input),
    blended by strength; x planar (..., 3, H, W)."""
    if p["denoise_strength"] <= 0.0:
        return x
    if p["denoise_taps"] != "sep" or p["denoise_guide"] != "luma":
        raise NotImplementedError("the reference has the luma-guided "
                                  "separable bilateral only")
    inv2s2 = 1.0 / (2.0 * p["denoise_sigma"] ** 2)
    planes = [x[..., c, :, :] for c in range(3)]
    outs = list(planes)
    for dy, dx in ((1, 0), (0, 1)):
        luma = (outs[0] + outs[1] + outs[2]) * (1.0 / 3.0)
        accs = [torch.zeros_like(o) for o in outs]
        wacc = torch.zeros_like(luma)
        for t in (-1, 0, 1):
            d = roll2d(luma, t * dy, t * dx) - luma
            w = SPATIAL_1D[t + 1] * _range_weight(d * d, inv2s2,
                                                  p["denoise_kernel"])
            wacc = wacc + w
            for k, o in enumerate(outs):
                accs[k] = accs[k] + w * roll2d(o, t * dy, t * dx)
        winv = 1.0 / wacc
        outs = [a * winv for a in accs]
    s = p["denoise_strength"]
    return torch.stack([q + s * (o - q) for q, o in zip(planes, outs)],
                       dim=-3)


def pad_edge(x: torch.Tensor, top: int, bottom: int, left: int,
             right: int) -> torch.Tensor:
    """Edge-replicate pad of the last two axes, any dtype."""
    h, w = x.shape[-2:]
    rows = torch.clamp(torch.arange(-top, h + bottom, device=x.device),
                       0, h - 1)
    cols = torch.clamp(torch.arange(-left, w + right, device=x.device),
                       0, w - 1)
    return x.index_select(-2, rows).index_select(-1, cols)
