"""Bilateral-lite 3x3 denoise expressed as shifted taps, and the dispatch
to the guided cores (``ops/guided.py``).

Spatial weights are the separable [1/4, 1/2, 1/4] binomial; the range
weight is ``"exp"`` (Gaussian, ``exp(-d^2 / 2 sigma^2)``) or ``"epan"``
(squared Epanechnikov, ``max(0, 1 - d^2 / 6 sigma^2)^2``). The tap order
and the arithmetic form of each core follow the JAX package's
``ops/denoise.py`` exactly; the CUDA kernels repeat it in
``kernels/csrc/fused_enhance.cuh``.
"""

from __future__ import annotations

import torch

from low_light_image_enhancement_tpu_torch.ops.filters import roll2d, shift2d
from low_light_image_enhancement_tpu_torch.ops.guided import (
    guided_core_shift,
    guided_joint_core_shift,
)

_SPATIAL_1D = (0.25, 0.5, 0.25)

RANGE_KERNELS = ("exp", "epan")
GUIDES = ("perchannel", "luma")
TAPS = ("full", "sep", "guided")


def _range_weight(d2, inv2s2, kind: str):
    if kind == "exp":
        return torch.exp(-d2 * inv2s2)
    if kind == "epan":
        u = torch.clamp(1.0 - d2 * (inv2s2 * (1.0 / 3.0)), min=0.0)
        return u * u
    raise ValueError(f"range kernel must be one of {RANGE_KERNELS}: {kind!r}")


def bilateral_core(x, inv2s2, strength, shift_fn, kind: str = "exp"):
    """3x3 per-channel bilateral as 9 shifted taps over the last two axes."""
    acc = torch.zeros_like(x)
    wacc = torch.zeros_like(x)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            s = shift_fn(x, di, dj)
            d = s - x
            w = (_SPATIAL_1D[di + 1] * _SPATIAL_1D[dj + 1]) * _range_weight(
                d * d, inv2s2, kind
            )
            acc = acc + w * s
            wacc = wacc + w
    filtered = acc / wacc
    return x + strength * (filtered - x)


def bilateral_joint_core(planes, inv2s2, strength, shift_fn,
                         kind: str = "exp"):
    """Luma-guided joint 3x3 bilateral over a sequence of 3 channel planes:
    one weight plane per tap from the channel-mean guide."""
    luma = (planes[0] + planes[1] + planes[2]) * (1.0 / 3.0)
    accs = [torch.zeros_like(p) for p in planes]
    wacc = torch.zeros_like(luma)
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            g = shift_fn(luma, di, dj)
            d = g - luma
            w = (_SPATIAL_1D[di + 1] * _SPATIAL_1D[dj + 1]) * _range_weight(
                d * d, inv2s2, kind
            )
            wacc = wacc + w
            for k, p in enumerate(planes):
                accs[k] = accs[k] + w * shift_fn(p, di, dj)
    winv = 1.0 / wacc
    return [p + strength * (acc * winv - p)
            for p, acc in zip(planes, accs)]


def bilateral_sep_core(x, inv2s2, strength, shift_fn, kind: str = "exp"):
    """Separable per-channel bilateral: a 3-tap pass along rows, then along
    columns of the row-filtered result."""
    f = x
    for dy, dx in ((1, 0), (0, 1)):
        acc = torch.zeros_like(f)
        wacc = torch.zeros_like(f)
        for t in (-1, 0, 1):
            s = shift_fn(f, t * dy, t * dx)
            d = s - f
            w = _SPATIAL_1D[t + 1] * _range_weight(d * d, inv2s2, kind)
            acc = acc + w * s
            wacc = wacc + w
        f = acc / wacc
    return x + strength * (f - x)


def bilateral_sep_joint_core(planes, inv2s2, strength, shift_fn,
                             kind: str = "exp"):
    """Separable luma-guided joint bilateral: 2 passes, the guide recomputed
    from each pass's input."""
    outs = list(planes)
    for dy, dx in ((1, 0), (0, 1)):
        luma = (outs[0] + outs[1] + outs[2]) * (1.0 / 3.0)
        accs = [torch.zeros_like(p) for p in outs]
        wacc = torch.zeros_like(luma)
        for t in (-1, 0, 1):
            g = shift_fn(luma, t * dy, t * dx)
            d = g - luma
            w = _SPATIAL_1D[t + 1] * _range_weight(d * d, inv2s2, kind)
            wacc = wacc + w
            for k, p in enumerate(outs):
                accs[k] = accs[k] + w * shift_fn(p, t * dy, t * dx)
        winv = 1.0 / wacc
        outs = [acc * winv for acc in accs]
    return [p + strength * (o - p) for p, o in zip(planes, outs)]


def plane_cores(guide: str, taps: str, guided_radius: int = 2,
                guided_eps: float = 3e-3):
    """(single-plane core, joint core) pair for a (guide, taps) choice. Every
    core has the signature ``core(x_or_planes, inv2s2, strength, shift_fn,
    kind)``; the guided cores (taps="guided") bind their radius and eps
    here and ignore ``inv2s2`` and ``kind``. The defaults are the JAX
    package's; the config's ``guided_eps`` default differs (1e-2), so the
    pipeline always passes both."""
    if guide not in GUIDES:
        raise ValueError(f"denoise guide must be one of {GUIDES}: {guide!r}")
    if taps not in TAPS:
        raise ValueError(f"denoise taps must be one of {TAPS}: {taps!r}")
    if taps == "guided":
        def core1(x, inv2s2, strength, shift_fn, kind="exp"):
            return guided_core_shift(x, guided_eps, strength, shift_fn,
                                     guided_radius)

        def corej(planes, inv2s2, strength, shift_fn, kind="exp"):
            return guided_joint_core_shift(planes, guided_eps, strength,
                                           shift_fn, guided_radius)

        return core1, corej
    if taps == "full":
        return bilateral_core, bilateral_joint_core
    return bilateral_sep_core, bilateral_sep_joint_core


def denoise_planar(x, inv2s2, strength, shift_fn, kind: str = "exp",
                   guide: str = "perchannel", taps: str = "full",
                   guided_radius: int = 2, guided_eps: float = 3e-3):
    """Dispatch on (guide, taps) for a planar (..., 3, H, W) tensor."""
    core1, corej = plane_cores(guide, taps, guided_radius, guided_eps)
    if guide == "perchannel":
        return core1(x, inv2s2, strength, shift_fn, kind)
    planes = [x[..., c, :, :] for c in range(3)]
    return torch.stack(corej(planes, inv2s2, strength, shift_fn, kind), dim=-3)


def bilateral_denoise(
    x: torch.Tensor,
    sigma_range: float = 0.12,
    strength: float = 0.5,
    mode: str = "clamp",
    kind: str = "exp",
    guide: str = "perchannel",
    taps: str = "full",
) -> torch.Tensor:
    """Edge-preserving 3x3 filter over the last two axes, blended by
    ``strength`` (0 returns ``x`` itself). Any planar layout
    (``guide="luma"`` needs the channel axis at -3).

    mode="clamp": edge-replicate boundary (the public op's).
    mode="wrap":  circular boundary, for inputs padded beforehand.
    kind: the range weight, "exp" or "epan"; guide: "perchannel" weights or
    "luma" (the joint bilateral); taps: "full" 3x3 or "sep" (3+3)."""
    if strength == 0.0:
        return x
    shift_fn = shift2d if mode == "clamp" else roll2d
    inv2s2 = 1.0 / (2.0 * sigma_range * sigma_range)
    return denoise_planar(x, inv2s2, strength, shift_fn, kind, guide, taps)
