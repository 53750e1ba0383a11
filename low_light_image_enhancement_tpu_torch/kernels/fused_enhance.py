"""K1 (fused retinex) and K3 (fused curve/hybrid tail): wrappers, plain
PyTorch versions and launch counts.

Each wrapper dispatches on the device of its input alone: a CPU tensor goes
to the plain version, a CUDA tensor to the hand-written kernel in
``csrc/fused_enhance.cu`` (or the call raises). ``<wrapper>.launches``
counts the kernel launches, and nothing else.

- K1 ``fused_retinex`` replaces the JAX package's
  ``kernels/fused_enhance.py::fused_retinex`` (``_retinex_kernel``).
- K3 ``fused_curve_enhance`` replaces its ``fused_curve_enhance``
  (``_curve_kernel``) at ``curve_downsample`` 1, with the contract of
  ``blocks._fused_curve_tail``.
"""

from __future__ import annotations

import ctypes

import torch

from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import (
    denoise_tail,
    enhance_core_padded,
    illumination_boost,
    pad_planar,
    replicate_margin_cols,
)
from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.kernels.striping import plan_canvas
from low_light_image_enhancement_tpu_torch.ops.colorspace import (
    normalize_u8,
    quantize_u8,
)
from low_light_image_enhancement_tpu_torch.ops.curves import apply_curves
from low_light_image_enhancement_tpu_torch.ops.filters import (
    gaussian_kernel_1d,
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the CUDA kernels yet (ROADMAP Queue 1)")


def _check_options(cfg: PipelineConfig, gain, stages) -> None:
    if cfg.denoise_taps == "guided":
        raise _not_ported("denoise_taps='guided'")
    if gain is not None:
        raise _not_ported("the external gain plane (gain=, ext_gain)")
    if stages is not None:
        raise _not_ported("stage truncation (stages=)")


def _check_cuda_tensor(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(
            f"expected a CPU or CUDA tensor, got device {t.device}")
    if not t.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous tensors")


def _boost_args(cfg: PipelineConfig, lib):
    if cfg.blur_radius > lib.llie_max_blur_radius():
        raise _not_ported(f"blur_radius > {lib.llie_max_blur_radius()}")
    taps = gaussian_kernel_1d(cfg.blur_radius, cfg.blur_sigma)
    return (cfg.blur_radius, (ctypes.c_float * len(taps))(*taps),
            cfg.gamma - 1.0, cfg.illum_eps)


def _tail_args(cfg: PipelineConfig):
    strength = cfg.denoise_strength
    inv2s2 = (1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma)
              if strength > 0.0 else 0.0)
    return (strength, inv2s2, inv2s2 * (1.0 / 3.0),
            0 if cfg.denoise_kernel == "exp" else 1,
            int(cfg.denoise_guide == "luma"),
            int(cfg.denoise_taps == "sep"))


def _raise_on(rc: int, lib, what: str) -> None:
    if rc != 0:
        msg = lib.llie_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


# --------------------------------------------------------------------- K1 #

def fused_retinex_plain(imgs: torch.Tensor,
                        cfg: PipelineConfig) -> torch.Tensor:
    """Plain version of K1: replicate-pad to the canvas, run
    ``core.enhance_core_padded`` with wrap shifts, crop."""
    _, h, w, _ = imgs.shape
    plan = plan_canvas(h, w, canvas_margin(cfg))
    xp = pad_planar(normalize_u8(imgs.permute(0, 3, 1, 2)), plan, h, w)
    y = enhance_core_padded(xp, cfg)
    m = plan.margin
    return quantize_u8(y[..., m:m + h, m:m + w]).permute(0, 2, 3, 1) \
        .contiguous()


def fused_retinex(imgs: torch.Tensor, cfg: PipelineConfig, *,
                  gain=None, stages=None) -> torch.Tensor:
    """K1: (B, H, W, 3) uint8 -> (B, H, W, 3) uint8, the default retinex
    graph (max-RGB illumination, blur, boost, denoise, quantize)."""
    if cfg.method != "retinex":
        raise ValueError(f"fused_retinex runs method='retinex', not "
                         f"{cfg.method!r}")
    _check_options(cfg, gain, stages)
    if imgs.dtype != torch.uint8:
        raise _not_ported(f"float I/O ({imgs.dtype})")
    if imgs.ndim != 4 or imgs.shape[-1] != 3 or 0 in imgs.shape:
        raise ValueError(f"expected non-empty (B,H,W,3), got "
                         f"{tuple(imgs.shape)}")
    if imgs.device.type == "cpu":
        return fused_retinex_plain(imgs, cfg)
    _check_cuda_tensor(imgs)
    lib = _build.load_library()
    b, h, w, _ = imgs.shape
    out = torch.empty_like(imgs)
    with torch.cuda.device(imgs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_fused_retinex_u8(
            imgs.data_ptr(), out.data_ptr(), b, h, w,
            *_boost_args(cfg, lib), *_tail_args(cfg), stream)
    _raise_on(rc, lib, "fused_retinex")
    fused_retinex.launches += 1
    return out


fused_retinex.launches = 0


# --------------------------------------------------------------------- K3 #

def fused_curve_enhance_plain(xb, maps, cfg, halo, rows, img_w):
    """Plain version of K3: the JAX kernel's graph on the window
    ``[halo - m, halo + rows + m)`` of the block, with wrap shifts."""
    m = canvas_margin(cfg)
    win = slice(halo - m, halo + rows + m)
    y = normalize_u8(xb[..., win, :])
    if cfg.method == "hybrid":
        y = replicate_margin_cols(illumination_boost(y, cfg), img_w, m)
    y = torch.clamp(apply_curves(y, maps[..., win, :]), 0.0, 1.0)
    if cfg.denoise_strength > 0.0:
        y = denoise_tail(y, cfg)
    return quantize_u8(torch.clamp(y, 0.0, 1.0)[..., m:m + rows, :])


def fused_curve_enhance(
    xb: torch.Tensor,
    maps: torch.Tensor,
    cfg: PipelineConfig,
    halo: int,
    rows: int,
    img_w: int,
    *,
    gain=None,
) -> torch.Tensor:
    """K3: u8 block (B, 3, HB, WB) + f32 curve maps (B, n_iter, 3, HB, WB)
    -> u8 (B, 3, rows, WB), the block's rows [halo, halo + rows).

    The block has ``canvas_margin(cfg)`` replicate columns before the
    image's column 0 and ``img_w`` image columns. Output columns outside
    [m, m + img_w) are not defined (the caller crops them)."""
    if cfg.method not in ("curve", "hybrid"):
        raise ValueError(f"fused_curve_enhance runs curve/hybrid, not "
                         f"{cfg.method!r}")
    if cfg.curve_downsample != 1:
        raise _not_ported(f"curve_downsample={cfg.curve_downsample}")
    _check_options(cfg, gain, None)
    if xb.dtype != torch.uint8:
        raise _not_ported(f"float I/O ({xb.dtype})")
    if xb.ndim != 4 or xb.shape[1] != 3 or 0 in xb.shape:
        raise ValueError(f"expected a (B,3,HB,WB) block, got "
                         f"{tuple(xb.shape)}")
    b, _, hb, wb = xb.shape
    if (maps.dtype != torch.float32 or maps.ndim != 5
            or maps.shape[0] != b or maps.shape[2:] != (3, hb, wb)):
        raise ValueError(f"expected f32 maps (B,it,3,HB,WB) for block "
                         f"{tuple(xb.shape)}, got {maps.dtype} "
                         f"{tuple(maps.shape)}")
    if maps.device != xb.device:
        raise ValueError("block and maps lie on different devices")
    m = canvas_margin(cfg)
    if rows < 1 or halo < m or hb < halo + rows + m:
        raise ValueError(f"block of {hb} rows cannot hold {rows} rows "
                         f"with halo {halo} >= margin {m}")
    if not 0 < img_w <= wb - m:
        raise ValueError(f"img_w={img_w} does not fit block width {wb}")
    if xb.device.type == "cpu":
        return fused_curve_enhance_plain(xb, maps, cfg, halo, rows, img_w)
    _check_cuda_tensor(xb)
    _check_cuda_tensor(maps)
    lib = _build.load_library()
    out = torch.empty((b, 3, rows, wb), dtype=torch.uint8, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_fused_curve_u8(
            xb.data_ptr(), maps.data_ptr(), out.data_ptr(), b, hb, wb,
            halo, rows, maps.shape[1], int(cfg.method == "hybrid"), m,
            img_w, *_boost_args(cfg, lib), *_tail_args(cfg), stream)
    _raise_on(rc, lib, "fused_curve_enhance")
    fused_curve_enhance.launches += 1
    return out


fused_curve_enhance.launches = 0
