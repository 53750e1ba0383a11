"""Analytic roofline model: operations and HBM bytes per image, and the
achieved rates against one NVIDIA H100's peaks.

The arithmetic is the JAX package's ``utils/roofline.py``, unchanged: for
the same arguments the operation and byte counts are equal. Conventions:

* one FMA = 2 FLOPs; one transcendental (exp/log/sigmoid) = 8 FLOPs, by
  convention;
* ``tensor_flops`` are the conv contractions (cuDNN or the port's conv
  kernels run them on the tensor cores in bf16), ``cuda_core_flops`` the
  per-pixel math;
* HBM bytes are the algorithmic minimum: inputs, outputs and the seams
  between stages that must cross memory (the nets' activations between
  conv layers, the curve maps into the fused tail). Real traffic is at
  least this, so the HBM share is optimistic.

Peaks (H100 SXM data sheet, dense, at the full 700 W; ``chip_smoke.py``
uses the same): 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s float32
on the CUDA cores, 3.35 TB/s HBM. A card set below 700 W reaches less.
"""

from __future__ import annotations

import dataclasses

from low_light_image_enhancement_tpu_torch.config import PipelineConfig

H100_TENSOR_BF16_TFLOPS = 989.0
H100_CUDA_CORE_F32_TFLOPS = 67.0
H100_HBM_GBPS = 3350.0

_TRANSCENDENTAL = 8  # FLOPs per exp/log/sigmoid, by convention


@dataclasses.dataclass(frozen=True)
class Cost:
    """Per-image algorithmic cost of one enhancement (or training step)."""

    tensor_flops: float     # conv contraction FLOPs (tensor cores)
    cuda_core_flops: float  # per-pixel math FLOPs (CUDA cores)
    hbm_bytes: float        # algorithmic-minimum HBM traffic


def _conv_flops(h: int, w: int, sizes, k: int = 3) -> float:
    """2 * k*k*cin*cout FLOPs per output pixel, summed over layers."""
    return float(sum(2 * k * k * cin * cout * h * w for cin, cout in sizes))


def _denoise_flops_per_px(cfg: PipelineConfig) -> float:
    """Bilateral tail: per tap the guide diff and square (2), the range
    weight (a transcendental for 'exp', 2 for 'epan') and the weight and
    value accumulates (2 FMAs = 4); the luma guide shares the weight plane
    across channels, per channel pays it per channel; plus the guide mean,
    the final divide (~4) and the strength lerp (2) a channel."""
    if cfg.denoise_strength <= 0.0:
        return 0.0
    taps = 6 if cfg.denoise_taps == "sep" else 9
    w_range = _TRANSCENDENTAL if cfg.denoise_kernel == "exp" else 2
    per_tap_weight = 2 + w_range
    if cfg.denoise_guide == "luma":
        per_px = 3 + taps * (per_tap_weight + 3 * 2) + 3 * (4 + 2)
    else:
        per_px = 3 * (taps * (per_tap_weight + 2 * 2) + 4 + 2)
    return float(per_px)


def _illum_flops_per_px(cfg: PipelineConfig) -> float:
    """max-RGB (2) + separable blur (2 passes x (2r+1) FMAs) + clip (2) +
    the gain's exp/log chain (2 T + 1) + the 3-channel apply (3 x 3)."""
    blur = 2 * (2 * cfg.blur_radius + 1) * 2
    return 2 + blur + 2 + (2 * _TRANSCENDENTAL + 1) + 9


def _curve_sizes(f: int, n: int):
    """The curve CNN's (cin, cout) a layer, c1-c7."""
    return [(3, f), (f, f), (f, f), (f, f), (2 * f, f), (2 * f, f),
            (2 * f, 3 * n)]


def pipeline_cost(cfg: PipelineConfig, h: int, w: int) -> Cost:
    """Algorithmic per-image cost of ``EnhancePipeline`` at (h, w) for
    ``cfg.method``; u8 I/O, 3 bytes a pixel in and 3 out."""
    px = float(h * w)
    io_bytes = 6.0 * px
    norm_quant = 1 + 3  # u8 -> f32 multiply; round, clip, cast a channel
    act = 2 if cfg.compute_dtype == "bfloat16" else 4  # activation bytes

    if cfg.method == "retinex":
        flops = _illum_flops_per_px(cfg) + _denoise_flops_per_px(cfg)
        return Cost(0.0, (flops + norm_quant) * px, io_bytes)

    ds = cfg.curve_downsample
    f, n = cfg.curve_features, cfg.curve_iters
    # the curves: n_iter x 3 channels x (y + a*y*(1-y): ~4)
    curve_tail = n * 3 * 4

    if cfg.method in ("curve", "hybrid"):
        tensor = _conv_flops(h // ds, w // ds, _curve_sizes(f, n))
        # the activations between conv layers cross HBM (write + read) in
        # the compute dtype; the curve maps cross into the tail in f32
        inter = [f, f, f, f, f, f]  # outputs of c1..c6 (c7 = the maps)
        act_bytes = sum(2 * c * act for c in inter) * px / (ds * ds)
        maps_bytes = 2 * n * 3 * 4 * px / (ds * ds)
        relu = (6 * f + 3 * n) * 2 / (ds * ds)  # relu/tanh a layer pixel
        flops = (norm_quant + curve_tail + relu
                 + _denoise_flops_per_px(cfg))
        if ds > 1:
            flops += n * 3 * 8  # the maps' 2-D upsample: 2 lerps x ~4
        if cfg.method == "hybrid":
            flops += _illum_flops_per_px(cfg)
        return Cost(tensor, flops * px, io_bytes + act_bytes + maps_bytes)

    if cfg.method == "fcn":
        depth, feat = 7, 24
        sizes = [(3, feat)] + [(feat, feat)] * (depth - 1)
        tensor = _conv_flops(h, w, sizes) + 2 * feat * 3 * px  # + 1x1 head
        act_bytes = depth * 2 * feat * act * px
        flops = (norm_quant + depth * feat * 2  # leaky_relu a layer pixel
                 + _TRANSCENDENTAL * 3) * px    # the sigmoid head
        return Cost(tensor, flops, io_bytes + act_bytes)

    if cfg.method == "decom":
        feat = 32
        sizes = [(4, feat), (feat, feat), (feat, feat), (feat, feat),
                 (feat, 4)]
        tensor = _conv_flops(h, w, sizes)
        act_bytes = 4 * 2 * feat * act * px
        # relight: L**decom_gamma (exp + log), a multiply, the tail
        flops = (norm_quant + 2 * _TRANSCENDENTAL + 3
                 + _denoise_flops_per_px(cfg)) * px
        return Cost(tensor, flops, io_bytes + act_bytes)

    raise ValueError(f"no roofline model for method {cfg.method!r}")


def train_step_cost(features: int, n_iter: int, crop: int,
                    remat: bool = True,
                    compute_dtype: str = "float32") -> Cost:
    """Per-image algorithmic cost of one curve-CNN training step (the
    zero-reference loss, forward + backward + the AdamW update).

    * backward conv FLOPs = 2x forward (a dgrad and a wgrad contraction of
      the layer's shape); ``remat`` recomputes the forward in the backward
      pass: 4x forward with remat, 3x without;
    * HBM bytes: the f32 planar batch in, the activations between layers
      in the compute dtype crossing HBM twice a materialization (write +
      read), materialized twice with remat, their gradients once, and the
      f32 curve maps forward and backward; the params and optimizer state
      (~100 KB) are left out;
    * the loss's per-pixel work: the curves forward and backward (~3x
      forward), the pools and the TV.
    """
    px = float(crop * crop)
    sizes = _curve_sizes(features, n_iter)
    fwd = _conv_flops(crop, crop, sizes)
    passes = 4.0 if remat else 3.0
    tensor = passes * fwd

    act = 2 if compute_dtype == "bfloat16" else 4
    inter = [features] * 6  # c1..c6 outputs; c7 emits the maps
    act_mat = 2.0 if remat else 1.0
    act_bytes = sum(2 * c * act for c in inter) * px * act_mat
    grad_bytes = sum(2 * c * act for c in inter) * px
    maps_bytes = 2 * n_iter * 3 * 4 * px
    io_bytes = 2 * 3 * 4 * px
    flops = (n_iter * 3 * 4 * 3 + 40) * px
    return Cost(tensor, flops, io_bytes + act_bytes + grad_bytes + maps_bytes)


def least_seconds(c: Cost, compute_dtype: str) -> dict:
    """Seconds an image takes at each ceiling: the convs on the tensor
    cores in bf16, or on the CUDA cores in float32 (TF32 off: the port's
    float32 parity setting) beside the per-pixel math, and the bytes over
    HBM. The largest is the bound."""
    t = {"HBM": c.hbm_bytes / (H100_HBM_GBPS * 1e9),
         "CUDA cores": c.cuda_core_flops / (H100_CUDA_CORE_F32_TFLOPS
                                            * 1e12)}
    if compute_dtype == "bfloat16":
        t["tensor cores"] = c.tensor_flops / (H100_TENSOR_BF16_TFLOPS * 1e12)
    else:
        t["CUDA cores"] += c.tensor_flops / (H100_CUDA_CORE_F32_TFLOPS * 1e12)
    return t


def _report(c: Cost, images_per_sec: float, compute_dtype: str) -> dict:
    t = least_seconds(c, compute_dtype)
    bound = max(t, key=t.get)
    return {
        "achieved_tensor_tflops": c.tensor_flops * images_per_sec / 1e12,
        "achieved_cuda_core_tflops": (c.cuda_core_flops * images_per_sec
                                      / 1e12),
        "achieved_hbm_gbps": c.hbm_bytes * images_per_sec / 1e9,
        "util": {k: v * images_per_sec for k, v in t.items()},
        "bound": bound,
        "bound_ms_per_img": 1e3 * t[bound],
    }


def train_roofline_report(features: int, n_iter: int, crop: int,
                          images_per_sec: float, remat: bool = True,
                          compute_dtype: str = "float32") -> dict:
    """The training step's achieved TFLOP/s and GB/s against the H100's
    peaks, the ceiling that binds (``least_seconds``), and the measured
    rate's share of that bound. The tensor-core share is against the bf16
    peak whatever the compute dtype (``train_compute_dtype`` says which
    ran)."""
    c = train_step_cost(features, n_iter, crop, remat, compute_dtype)
    r = _report(c, images_per_sec, compute_dtype)
    return {
        "train_flops_per_img_tensor": round(c.tensor_flops),
        "train_hbm_bytes_per_img": round(c.hbm_bytes),
        "train_achieved_tensor_tflops": round(r["achieved_tensor_tflops"], 2),
        "train_achieved_hbm_gbps": round(r["achieved_hbm_gbps"], 2),
        "train_tensor_util_pct_of_bf16_peak": round(
            100 * r["achieved_tensor_tflops"] / H100_TENSOR_BF16_TFLOPS, 2),
        "train_hbm_util_pct": round(100 * r["util"]["HBM"], 2),
        "train_compute_dtype": compute_dtype,
        "train_roofline_bound": r["bound"],
        "train_bound_ms_per_img": round(r["bound_ms_per_img"], 5),
        "train_bound_images_per_sec": round(1e3 / r["bound_ms_per_img"], 1),
        "train_share_of_bound_pct": round(
            100 * images_per_sec * r["bound_ms_per_img"] / 1e3, 2),
    }


def roofline_report(cfg: PipelineConfig, h: int, w: int,
                    images_per_sec: float) -> dict:
    """Achieved rates against the H100's peaks and the binding ceiling."""
    c = pipeline_cost(cfg, h, w)
    r = _report(c, images_per_sec, cfg.compute_dtype)
    return {
        "flops_per_img_tensor": round(c.tensor_flops),
        "flops_per_img_cuda_core": round(c.cuda_core_flops),
        "hbm_bytes_per_img": round(c.hbm_bytes),
        "achieved_tensor_tflops": round(r["achieved_tensor_tflops"], 3),
        "achieved_cuda_core_tflops": round(r["achieved_cuda_core_tflops"], 3),
        "achieved_hbm_gbps": round(r["achieved_hbm_gbps"], 2),
        **{f"{k.replace(' ', '_').lower()}_util_pct": round(100 * v, 2)
           for k, v in r["util"].items()},
        "roofline_bound": r["bound"],
    }
