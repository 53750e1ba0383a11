"""Synthetic low-light pairs made on the device, from a ``torch.Generator``.

The construction of the JAX package's ``data/synth_device.py`` (a smooth
random colour field with texture, a smooth illumination field, a colour
cast, shot and read noise): a training loop makes its batches where it
trains, with no host-to-device copy a step. It is split into the random
draws (:func:`synth_draws`) and a deterministic body
(:func:`synth_from_draws`), so that the body can be held to the JAX
package's on the JAX draws. The draws come from PyTorch's generator, not
JAX's: the stream is the same distribution, not the same numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, Tuple

import torch
import torch.nn.functional as F

from low_light_image_enhancement_tpu_torch.pipeline import resolve_device

# (name, coarse grid) of the smooth colour fields
_FIELDS = (("base", 6), ("texture", 24), ("fine", 48))


def _uniform(g: torch.Generator, shape, lo: float, hi: float, device):
    u = torch.rand(shape, generator=g, device=device)
    return u * (hi - lo) + lo


def synth_draws(generator: torch.Generator, batch: int, h: int, w: int,
                device="cuda") -> Dict[str, torch.Tensor]:
    """The random draws of one batch, on ``device`` (the generator's):
    each field's coarse grid ``(B, g, g, c)`` in [0, 1), the log exposure
    level, the colour cast, read and shot noise scales and the unit normal
    noise ``(B, h, w, 3)``."""
    device = resolve_device(device, "synth_draws")
    g = generator
    d = {name: torch.rand((batch, grid, grid, 3), generator=g, device=device)
         for name, grid in _FIELDS}
    d["log_level"] = _uniform(g, (batch, 1, 1, 1), math.log(0.03),
                              math.log(0.45), device)
    d["illum"] = torch.rand((batch, 4, 4, 1), generator=g, device=device)
    d["cast"] = _uniform(g, (batch, 1, 1, 3), -0.25, 0.25, device)
    d["read"] = _uniform(g, (batch, 1, 1, 1), 0.004, 0.015, device)
    d["shot"] = _uniform(g, (batch, 1, 1, 1), 0.0005, 0.003, device)
    d["noise"] = torch.randn((batch, h, w, 3), generator=g, device=device)
    return d


def _smooth(coarse: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, g, g, c) -> bilinear (B, h, w, c), as
    ``jax.image.resize(method="bilinear")`` resizes: half-pixel centres,
    edges clamped, and antialiased where a side shrinks (a crop under 48
    rows or columns shrinks the fine field)."""
    up = F.interpolate(coarse.permute(0, 3, 1, 2), size=(h, w),
                       mode="bilinear", align_corners=False, antialias=True)
    return up.permute(0, 2, 3, 1)


def synth_from_draws(d: Dict[str, torch.Tensor], h: int, w: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The deterministic body: draws -> (low, high) planar f32
    ``(B, 3, h, w)`` in [0, 1]."""
    base = _smooth(d["base"], h, w)
    texture = _smooth(d["texture"], h, w) - 0.5
    fine = _smooth(d["fine"], h, w) - 0.5
    gt = torch.clamp(0.15 + 0.72 * base + 0.22 * texture + 0.10 * fine,
                     0.02, 0.98)
    level = torch.exp(d["log_level"])
    illum = (0.4 + 0.6 * _smooth(d["illum"], h, w)) * level
    cast = 1.0 + d["cast"]
    cast = cast / torch.mean(cast, dim=-1, keepdim=True)
    signal = gt * illum * cast
    read, shot = d["read"], d["shot"]
    sigma = torch.sqrt(read * read + shot * torch.clamp(signal, 0.0, 1.0))
    low = torch.clamp(signal + sigma * d["noise"], 0.0, 1.0)
    return (low.permute(0, 3, 1, 2).contiguous(),
            gt.permute(0, 3, 1, 2).contiguous())


def synth_pair_batch(generator: torch.Generator, batch: int, h: int, w: int,
                     device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """(low, high) planar f32 ``(batch, 3, h, w)`` in [0, 1], made on
    ``device`` from ``generator`` (a generator of that device)."""
    return synth_from_draws(synth_draws(generator, batch, h, w, device),
                            h, w)


def synth_batch_iter(batch: int, h: int, w: int, seed: int = 0,
                     device="cuda") -> Iterator[Tuple[torch.Tensor,
                                                      torch.Tensor]]:
    """Infinite iterator of device-resident (low, high) batches from one
    generator seeded with ``seed``."""
    device = resolve_device(device, "synth_batch_iter")
    g = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield synth_pair_batch(g, batch, h, w, device)
