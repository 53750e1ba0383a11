"""Plain PyTorch image ops, the JAX package's ``ops`` op for op.

Planar layout: single planes ``(..., H, W)`` or RGB ``(..., 3, H, W)``.
The kernels in ``..kernels`` repeat the arithmetic of the filters, the
denoise cores and the curves; the ISP, the colour spaces, the Fourier and
contrast ops are plain torch on every device, as they are plain jnp there.
"""

from low_light_image_enhancement_tpu_torch.ops.colorspace import (
    hsv_to_rgb,
    hvi_to_rgb,
    normalize_u8,
    quantize_u8,
    rgb_to_hsv,
    rgb_to_hvi,
    rgb_to_ycbcr,
    ycbcr_to_rgb,
)
from low_light_image_enhancement_tpu_torch.ops.contrast import (
    autocontrast,
    clahe,
    equalize_hist,
)
from low_light_image_enhancement_tpu_torch.ops.curves import apply_curves
from low_light_image_enhancement_tpu_torch.ops.denoise import (
    bilateral_denoise,
)
from low_light_image_enhancement_tpu_torch.ops.filters import (
    gaussian_blur,
    gaussian_kernel_1d,
    shift2d,
)
from low_light_image_enhancement_tpu_torch.ops.fourier import (
    amplitude_phase_swap,
    fourier_amplitude_boost,
)
from low_light_image_enhancement_tpu_torch.ops.gamma import gamma_correct
from low_light_image_enhancement_tpu_torch.ops.guided import (
    box_mean,
    guided_denoise,
    guided_filter,
)
from low_light_image_enhancement_tpu_torch.ops.isp import (
    color_correction,
    demosaic_bilinear_rggb,
    gray_world_gains,
    raw_to_srgb,
    white_balance,
)
from low_light_image_enhancement_tpu_torch.ops.retinex import (
    illumination_map,
    reflectance,
    retinex_enhance,
)

__all__ = [
    "normalize_u8",
    "quantize_u8",
    "rgb_to_hsv",
    "hsv_to_rgb",
    "rgb_to_ycbcr",
    "ycbcr_to_rgb",
    "rgb_to_hvi",
    "hvi_to_rgb",
    "gaussian_kernel_1d",
    "shift2d",
    "gaussian_blur",
    "illumination_map",
    "reflectance",
    "retinex_enhance",
    "gamma_correct",
    "bilateral_denoise",
    "box_mean",
    "guided_denoise",
    "guided_filter",
    "apply_curves",
    "demosaic_bilinear_rggb",
    "white_balance",
    "gray_world_gains",
    "color_correction",
    "raw_to_srgb",
    "fourier_amplitude_boost",
    "amplitude_phase_swap",
    "autocontrast",
    "clahe",
    "equalize_hist",
]
