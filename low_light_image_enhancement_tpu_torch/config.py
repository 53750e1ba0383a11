"""Pipeline configuration.

The same frozen dataclass as the JAX package's ``config.py``: every field,
default and validation rule is kept so a config means the same thing on
both sides (``tests/test_torch_config.py`` holds the two equal). Fields that
only steer the TPU lowering are kept for that equality and have no effect
in this package; their comments say so.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# Edge-replicate margin of the canvas at the default config: blur radius 2
# plus the radius-1 bilateral gives a receptive radius of 3, floored to 4.
# Configs with a wider per-pixel tail get a wider canvas (canvas_margin).
MARGIN = 4


def denoise_radius(cfg: "PipelineConfig") -> int:
    """Receptive radius (pixels) of the configured denoise tail: radius-1
    bilateral taps, or the guided filter's two cascaded radius-r box means
    (stats, then the a/b smoothing) = 2*r."""
    if cfg.denoise_strength <= 0.0:
        return 0
    if cfg.denoise_taps == "guided":
        return 2 * cfg.guided_radius
    return 1


def canvas_margin(cfg: "PipelineConfig") -> int:
    """Edge-replicate margin of the padded canvas for ``cfg``: the total
    receptive radius of the per-pixel tail (illumination blur where the
    method has one, plus the denoise radius), floored at MARGIN and rounded
    up to a multiple of 8 above it. Every bilateral config resolves to
    exactly MARGIN=4."""
    edge = 0
    if cfg.method in ("retinex", "hybrid"):
        edge = cfg.blur_radius
    if cfg.method in ("curve", "hybrid") and cfg.curve_downsample in (2, 4):
        edge = max(edge, cfg.curve_downsample // 2)
    r = denoise_radius(cfg) + edge
    return MARGIN if r <= MARGIN else -(-r // 8) * 8


_METHODS = ("retinex", "curve", "hybrid", "fcn", "decom")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Configuration of the enhancement graph (hashable, all scalars)."""

    # --- algorithm selection -------------------------------------------------
    # "retinex": classical illumination-map / reflectance path (no weights).
    # "curve":   Zero-DCE-style learned curve adjustment (needs CNN params).
    # "hybrid":  retinex illumination boost followed by learned curves.
    # "fcn":     supervised context-aggregation FCN enhancer.
    # "decom":   learned Retinex decomposition + relight.
    method: str = "retinex"

    # --- retinex / gamma -----------------------------------------------------
    gamma: float = 0.45          # illumination exponent (<1 brightens)
    decom_gamma: float = 0.08    # decom method's illumination exponent
    illum_eps: float = 1e-3      # floor for illumination before the boost
    blur_radius: int = 2         # Gaussian radius for illumination smoothing
    blur_sigma: float = 1.0      # Gaussian sigma for illumination smoothing

    # --- denoise -------------------------------------------------------------
    denoise_strength: float = 1.0   # 0 disables; blend toward the filtered
    denoise_sigma: float = 0.2      # range sigma of the bilateral
    denoise_kernel: str = "exp"     # range weight: "exp" or "epan"
    denoise_taps: str = "sep"       # "sep" 3+3 taps, "full" 3x3, "guided"
                                    # (every method runs each of them)
    guided_radius: int = 2          # box radius of the guided tail
    guided_eps: float = 1e-2        # guided-filter variance threshold
    denoise_guide: str = "luma"     # "luma" joint bilateral or "perchannel"

    # --- curve CNN -----------------------------------------------------------
    curve_iters: int = 8         # LE-curve iterations (Zero-DCE uses 8)
    curve_features: int = 32     # conv width of the curve estimator
    curve_downsample: int = 1    # CNN at 1/N resolution (1, 2, 4 or 8)

    # --- execution -----------------------------------------------------------
    # use_pallas, stripe_rows and stripe_windowed steer the TPU kernels'
    # lowering in the JAX package. They have no effect here: the device of
    # the input tensor picks the kernel or its plain version, and the CUDA
    # kernels tile in 2-D with their own halos.
    use_pallas: bool = True
    stripe_rows: int = 1024
    stripe_windowed: Optional[bool] = None
    compute_dtype: str = "bfloat16"  # CNN conv compute dtype; the per-pixel
                                     # tail math is float32 regardless
    conv_impl: str = "auto"      # the nets' conv arm: "auto" and "xla" run
                                 # F.conv2d, "pallas" the K6 kernels,
                                 # "cascade" K7 on fcn (xla elsewhere);
                                 # "gemm" patch/im2col GEMMs, "packed" and
                                 # "packed12" convs on space-to-depth lanes

    # --- sharding ------------------------------------------------------------
    # >1 runs on a mesh of devices (parallel/): rows over spatial_shards,
    # the batch over data_shards; on CUDA each is clamped to the cards
    spatial_shards: int = 1
    data_shards: int = 1

    # Named shipped weights this config pairs with (models.weights.NAMED);
    # None = the method's default .npz. Explicit model_params still win.
    weights_name: Optional[str] = None

    def __post_init__(self):
        if self.method not in _METHODS:
            raise ValueError(
                f"unknown method {self.method!r}; choose from {_METHODS}"
            )
        if self.blur_radius < 1 or self.blur_sigma <= 0:
            raise ValueError("blur_radius >= 1 and blur_sigma > 0 required")
        if not 0.0 <= self.denoise_strength <= 1.0:
            raise ValueError("denoise_strength must be in [0, 1]")
        if self.denoise_strength > 0.0 and self.denoise_sigma <= 0:
            raise ValueError("denoise_sigma must be > 0")
        from low_light_image_enhancement_tpu_torch.ops.denoise import (
            GUIDES,
            RANGE_KERNELS,
            TAPS,
        )

        if self.denoise_kernel not in RANGE_KERNELS:
            raise ValueError(
                f"denoise_kernel must be one of {RANGE_KERNELS}: "
                f"{self.denoise_kernel!r}"
            )
        if self.denoise_guide not in GUIDES:
            raise ValueError(
                f"denoise_guide must be one of {GUIDES}: "
                f"{self.denoise_guide!r}"
            )
        if self.denoise_taps not in TAPS:
            raise ValueError(
                f"denoise_taps must be one of {TAPS}: {self.denoise_taps!r}"
            )
        if self.denoise_taps == "guided" and not 1 <= self.guided_radius <= 8:
            raise ValueError(
                f"guided_radius must be in [1, 8]: {self.guided_radius} "
                "(receptive radius 2*r sets the canvas margin; 8 is already "
                "a 32-row margin)"
            )
        if self.denoise_taps == "guided" and self.guided_eps <= 0:
            raise ValueError("guided_eps must be > 0")
        if self.conv_impl not in ("auto", "xla", "pallas", "gemm", "packed",
                                  "packed12", "cascade"):
            raise ValueError(
                "conv_impl must be 'auto', 'xla', 'pallas', 'gemm', "
                f"'packed', 'packed12' or 'cascade': {self.conv_impl!r}"
            )
        if self.curve_downsample not in (1, 2, 4, 8):
            raise ValueError(
                "curve_downsample must be 1, 2, 4 or 8 (the integer-factor "
                "bilinear upsample of record and the sharded/striped phase "
                "alignment need a small even factor)"
            )
        if self.spatial_shards < 1 or self.data_shards < 1:
            raise ValueError(
                "spatial_shards and data_shards must be >= 1: "
                f"{self.spatial_shards}, {self.data_shards}"
            )
        if self.spatial_shards > 1 and self.data_shards > 1:
            raise ValueError(
                "combined data+spatial sharding is driven via "
                "parallel.make_mesh(n_data, n_spatial) + "
                "enhance_spatial_sharded, not PipelineConfig; set only one "
                "of spatial_shards / data_shards here"
            )

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


# Named presets, equal to the JAX package's.
PRESETS = {
    "config1_single_cpu": PipelineConfig(method="retinex", use_pallas=False),
    "config2_lol_eval": PipelineConfig(method="retinex", use_pallas=True),
    "config3_curve_cnn": PipelineConfig(method="curve", use_pallas=True),
    "config4_1080p_stream": PipelineConfig(method="retinex", use_pallas=True),
    "config5_4k_sharded": PipelineConfig(
        method="retinex", use_pallas=True, spatial_shards=8
    ),
    "quality": PipelineConfig(
        method="decom", denoise_taps="guided", guided_radius=4,
        weights_name="decom_relit_guided",
    ),
    "quality_fast": PipelineConfig(method="fcn"),
}
