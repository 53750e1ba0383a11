"""The yardstick's arithmetic: one NVIDIA H100's peaks and the work an
image needs, counted from the configuration's shapes alone.

The counts follow the convention of the port's analytic roofline (one
multiply-add is 2 FLOPs, an exp or a log 8) and are frozen here so that a
change to the program cannot move them. They count what the algorithm
needs, not what an implementation moves: every input byte is read once and
every output byte written once (u8 RGB, 3 bytes a pixel each way); the
intermediates between layers or stages are left out, since a fused
implementation need not store them.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W.
PEAK_BF16_TENSOR_FLOPS = 989e12
PEAK_F32_CUDA_CORE_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

TRANSCENDENTAL = 8      # FLOPs an exp or a log, by convention
IO_BYTES_PER_PX = 6     # u8 RGB in and out
NORM_QUANT = 1 + 3      # u8 -> f32 multiply; round, clip, cast a channel


def illumination_flops_per_px(p: dict) -> float:
    """max RGB (2), the separable blur (2 passes of 2r+1 multiply-adds),
    the clip (2), exp((gamma - 1) log L) (2 transcendentals and a
    multiply) and the gain applied to 3 channels (3 x 3)."""
    blur = 2 * (2 * p["blur_radius"] + 1) * 2
    return 2 + blur + 2 + (2 * TRANSCENDENTAL + 1) + 9


def bilateral_flops_per_px(p: dict) -> float:
    """The bilateral tail: a tap's guide difference and square (2), its
    range weight (8 for exp, 2 for epan), the weight and value
    accumulations (2 multiply-adds a channel); the luma guide shares one
    weight across the channels; then the guide's mean (3), the divide (4)
    and the blend by strength (2) a channel."""
    if p["denoise_strength"] <= 0.0:
        return 0.0
    if p["denoise_taps"] not in ("sep", "full"):
        raise ValueError(f"no count for taps {p['denoise_taps']!r}")
    taps = 6 if p["denoise_taps"] == "sep" else 9
    weight = 2 + (TRANSCENDENTAL if p["denoise_kernel"] == "exp" else 2)
    if p["denoise_guide"] == "luma":
        return float(3 + taps * (weight + 3 * 2) + 3 * (4 + 2))
    return float(3 * (taps * (weight + 2 * 2) + 4 + 2))


def retinex_flops_per_px(p: dict) -> float:
    """CUDA-core FLOPs a pixel of the retinex method (171 at the
    defaults)."""
    return (illumination_flops_per_px(p) + bilateral_flops_per_px(p)
            + NORM_QUANT)


def retinex_least_s(p: dict, batch: int, h: int, w: int) -> float:
    """The least time one H100 can take for a retinex batch: the larger of
    its FLOPs over the float32 CUDA-core peak and its u8 bytes over the HBM
    rate."""
    px = float(batch * h * w)
    return max(retinex_flops_per_px(p) * px / PEAK_F32_CUDA_CORE_FLOPS,
               IO_BYTES_PER_PX * px / PEAK_HBM_BYTES_PER_S)


def net_flops_per_image(layers, h: int, w: int) -> float:
    """Tensor FLOPs of a net of 3x3 convs at the image's own h x w:
    2 * 9 * h * w * sum(cin * cout). ``layers``: (name, cin, cout)."""
    return float(2 * 9 * h * w * sum(cin * cout for _, cin, cout in layers))
