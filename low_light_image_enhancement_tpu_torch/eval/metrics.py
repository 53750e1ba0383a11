"""PSNR, SSIM and CIE76 delta-E on tensors, as the JAX package's
``eval/metrics.py`` computes them: the same formulas, constants and
boundary (edge-replicate Gaussian window for SSIM), on any device.

SSIM filters over the last two axes (planar layout); the ``*_u8`` helpers
take u8 (..., H, W, 3) channels-last images and transpose first.
"""

from __future__ import annotations

import torch

from low_light_image_enhancement_tpu_torch.ops.filters import (
    separable_blur,
    shift2d,
)


def _per_image_mean(x: torch.Tensor, image_ndim: int) -> torch.Tensor:
    """Mean over the last ``image_ndim`` axes when there is a batch axis in
    front of them, over everything otherwise."""
    if x.ndim > image_ndim:
        return torch.mean(x, dim=tuple(range(1, x.ndim)))
    return torch.mean(x)


def psnr(a: torch.Tensor, b: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    """PSNR in dB; per image for batched (ndim > 3) inputs."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    mse = torch.clamp(_per_image_mean((a - b) ** 2, 3), min=1e-12)
    return 10.0 * torch.log10((max_val * max_val) / mse)


def ssim(a: torch.Tensor, b: torch.Tensor, max_val: float = 1.0,
         radius: int = 5, sigma: float = 1.5) -> torch.Tensor:
    """Mean SSIM with an 11x11 Gaussian window (edge-replicate boundary,
    'same' output); per image for batched (B, C, H, W) inputs."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2

    def blur(x):
        return separable_blur(x, radius, sigma, shift2d)

    mu_a = blur(a)
    mu_b = blur(b)
    var_a = blur(a * a) - mu_a * mu_a
    var_b = blur(b * b) - mu_b * mu_b
    cov = blur(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a * mu_a + mu_b * mu_b + c1) * (var_a + var_b + c2))
    return _per_image_mean(s, 3)


def _planar_unit(x_u8: torch.Tensor) -> torch.Tensor:
    """u8 (..., H, W, 3) -> float32 (..., 3, H, W) in [0, 1], divided by
    255 as the JAX package divides."""
    return torch.movedim(x_u8.to(torch.float32) / 255.0, -1, -3)


def psnr_u8(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    return psnr(a_u8.to(torch.float32) / 255.0, b_u8.to(torch.float32) / 255.0)


def ssim_u8(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """u8 (..., H, W, 3) channels-last -> mean SSIM."""
    return ssim(_planar_unit(a_u8), _planar_unit(b_u8))


def _srgb_to_linear(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x <= 0.04045, x / 12.92,
                       ((x + 0.055) / 1.055) ** 2.4)


def rgb_to_lab(rgb: torch.Tensor) -> torch.Tensor:
    """sRGB [0,1] (..., 3, H, W) planar -> CIE L*a*b* (D65)."""
    lin = _srgb_to_linear(rgb.to(torch.float32))
    r, g, b = lin[..., 0, :, :], lin[..., 1, :, :], lin[..., 2, :, :]
    x = 0.4124564 * r + 0.3575761 * g + 0.1804375 * b
    y = 0.2126729 * r + 0.7151522 * g + 0.0721750 * b
    z = 0.0193339 * r + 0.1191920 * g + 0.9503041 * b
    xn, yn, zn = 0.95047, 1.0, 1.08883  # the D65 white point
    d = 6.0 / 29.0

    def f(t):
        # t > d**3 > 0 where the cube root is taken
        return torch.where(t > d ** 3, torch.abs(t) ** (1.0 / 3.0),
                           t / (3 * d * d) + 4.0 / 29.0)

    fx, fy, fz = f(x / xn), f(y / yn), f(z / zn)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-3)


def delta_e76(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean CIE76 color difference between planar sRGB images; per image
    for batched inputs."""
    d = rgb_to_lab(a) - rgb_to_lab(b)
    de = torch.sqrt(torch.sum(d * d, dim=-3) + 1e-12)
    return _per_image_mean(de, 2)


def delta_e76_u8(a_u8: torch.Tensor, b_u8: torch.Tensor) -> torch.Tensor:
    """u8 (..., H, W, 3) channels-last -> mean CIE76 delta-E."""
    return delta_e76(_planar_unit(a_u8), _planar_unit(b_u8))
