"""K1 (fused retinex), K3 (fused curve/hybrid tail) and K4 (the fused
retinex video step): wrappers, plain PyTorch versions and launch counts.

Each wrapper dispatches on the device of its input alone: a CPU tensor goes
to the plain version, a CUDA tensor to the hand-written kernel in
``csrc/fused_enhance.cu`` (or the call raises). ``<wrapper>.launches``
counts the kernel launches, and nothing else.

- K1 ``fused_retinex`` replaces the JAX package's
  ``kernels/fused_enhance.py::fused_retinex`` (``_retinex_kernel``) on u8
  HWC images; ``fused_retinex_gain`` is its external-gain form on a block,
  with the contract of ``video._fused_gain_tail``, and counts its launches
  on ``fused_retinex``.
- K3 ``fused_curve_enhance`` replaces its ``fused_curve_enhance``
  (``_curve_kernel``) with the contract of ``blocks._fused_curve_tail``:
  full-resolution maps or maps at 1/2 and 1/4 that it upsamples itself, and
  the optional external gain plane.
- K4 ``fused_retinex_ema`` replaces its ``fused_retinex_ema``
  (``_retinex_kernel(ema_alpha=...)``) with the contract of
  ``video._fused_ema_tail``.
"""

from __future__ import annotations

import ctypes
import numbers

import torch

from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import (
    denoise_tail,
    enhance_core_padded,
    illumination_boost,
    pad_edge,
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
    _phase_consts,
    gaussian_kernel_1d,
    roll2d,
    separable_blur,
    upsample_maps,
)


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the CUDA kernels yet (ROADMAP Queue 1)")


def _check_options(cfg: PipelineConfig, stages=None) -> None:
    if cfg.denoise_taps == "guided":
        raise _not_ported("denoise_taps='guided'")
    if stages is not None:
        raise _not_ported("stage truncation (stages=)")


def _check_block(xb: torch.Tensor) -> None:
    if xb.dtype != torch.uint8:
        raise _not_ported(f"float I/O ({xb.dtype})")
    if xb.ndim != 4 or xb.shape[1] != 3 or 0 in xb.shape:
        raise ValueError(f"expected a (B,3,HB,WB) block, got "
                         f"{tuple(xb.shape)}")


def _check_plane(t: torch.Tensor, xb: torch.Tensor, what: str) -> None:
    """A float32 (B, HB, WB) plane on the block's device."""
    b, _, hb, wb = xb.shape
    if t.dtype != torch.float32 or tuple(t.shape) != (b, hb, wb):
        raise ValueError(f"expected a f32 {what} (B,HB,WB) for block "
                         f"{tuple(xb.shape)}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != xb.device:
        raise ValueError(f"block and {what} lie on different devices")


def _check_window(cfg: PipelineConfig, xb: torch.Tensor, halo: int,
                  rows: int, img_w=None) -> int:
    """The block holds rows [halo - m, halo + rows + m) and, where given,
    ``img_w`` image columns after m margin columns; returns m."""
    m = canvas_margin(cfg)
    hb, wb = xb.shape[-2:]
    if rows < 1 or halo < m or hb < halo + rows + m:
        raise ValueError(f"block of {hb} rows cannot hold {rows} rows "
                         f"with halo {halo} >= margin {m}")
    if img_w is not None and not 0 < img_w <= wb - m:
        raise ValueError(f"img_w={img_w} does not fit block width {wb}")
    return m


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


def _denoise_quantize(y: torch.Tensor, cfg: PipelineConfig, r0: int,
                      rows: int) -> torch.Tensor:
    """The plain versions' common end: the denoise tail (wrap shifts),
    clip, rows [r0, r0 + rows), u8."""
    if cfg.denoise_strength > 0.0:
        y = denoise_tail(y, cfg)
    return quantize_u8(torch.clamp(y, 0.0, 1.0)[..., r0:r0 + rows, :])


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
                  stages=None) -> torch.Tensor:
    """K1: (B, H, W, 3) uint8 -> (B, H, W, 3) uint8, the default retinex
    graph (max-RGB illumination, blur, boost, denoise, quantize). Its form
    with an external gain plane is ``fused_retinex_gain``."""
    if cfg.method != "retinex":
        raise ValueError(f"fused_retinex runs method='retinex', not "
                         f"{cfg.method!r}")
    _check_options(cfg, stages)
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


def fused_retinex_gain_plain(xb, gain, cfg, halo, rows):
    """Plain version of K1's gain form: ``y = clip(x * gain)``, the denoise
    tail and quantize on the window ``[halo - m, halo + rows + m)``, with
    wrap shifts."""
    m = canvas_margin(cfg)
    win = slice(halo - m, halo + rows + m)
    y = torch.clamp(normalize_u8(xb[..., win, :]) * gain[:, None, win, :],
                    0.0, 1.0)
    return _denoise_quantize(y, cfg, m, rows)


def fused_retinex_gain(xb: torch.Tensor, gain: torch.Tensor,
                       cfg: PipelineConfig, halo: int,
                       rows: int) -> torch.Tensor:
    """K1 with an external gain plane: u8 block (B, 3, HB, WB) + f32 gain
    (B, HB, WB) -> u8 (B, 3, rows, WB), the block's rows [halo, halo +
    rows). The gain is read where it lies: it already carries the margin
    column replica. Counts its launches on ``fused_retinex``."""
    if cfg.method != "retinex":
        raise ValueError(f"fused_retinex_gain runs method='retinex', not "
                         f"{cfg.method!r}")
    _check_options(cfg)
    _check_block(xb)
    _check_plane(gain, xb, "gain")
    _check_window(cfg, xb, halo, rows)
    if xb.device.type == "cpu":
        return fused_retinex_gain_plain(xb, gain, cfg, halo, rows)
    _check_cuda_tensor(xb)
    _check_cuda_tensor(gain)
    lib = _build.load_library()
    b, _, hb, wb = xb.shape
    out = torch.empty((b, 3, rows, wb), dtype=torch.uint8, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_fused_retinex_gain_u8(
            xb.data_ptr(), gain.data_ptr(), out.data_ptr(), b, hb, wb, halo,
            rows, *_tail_args(cfg), stream)
    _raise_on(rc, lib, "fused_retinex_gain")
    fused_retinex.launches += 1
    return out


# --------------------------------------------------------------------- K3 #

def fused_curve_enhance_plain(xb, maps, cfg, halo, rows, img_w, ds=1,
                              gain=None):
    """Plain version of K3: the JAX kernel's graph on the window
    ``[halo - m, halo + rows + m)`` of the block, with wrap shifts. Maps at
    1/ds are first upsampled over the whole block (``upsample_maps``,
    columns then rows, clamped at the block's edges)."""
    m = canvas_margin(cfg)
    win = slice(halo - m, halo + rows + m)
    y = normalize_u8(xb[..., win, :])
    if gain is not None:
        y = torch.clamp(y * gain[:, None, win, :], 0.0, 1.0)
    elif cfg.method == "hybrid":
        y = replicate_margin_cols(illumination_boost(y, cfg), img_w, m)
    maps = upsample_maps(maps, ds)
    y = torch.clamp(apply_curves(y, maps[..., win, :]), 0.0, 1.0)
    return _denoise_quantize(y, cfg, m, rows)


def fused_curve_enhance(
    xb: torch.Tensor,
    maps: torch.Tensor,
    cfg: PipelineConfig,
    halo: int,
    rows: int,
    img_w: int,
    *,
    ds: int = 1,
    gain=None,
) -> torch.Tensor:
    """K3: u8 block (B, 3, HB, WB) + f32 curve maps (B, n_iter, 3, HB/ds,
    WB/ds), ds 1, 2 or 4, -> u8 (B, 3, rows, WB), the block's rows
    [halo, halo + rows).

    The block has ``canvas_margin(cfg)`` replicate columns before the
    image's column 0 and ``img_w`` image columns. Output columns outside
    [m, m + img_w) are not defined (the caller crops them). With ``gain``
    (f32 (B, HB, WB), the video path's temporally smoothed gain) the image
    is ``clip(x * gain)`` before the curves, in place of hybrid's boost and
    its column replica."""
    if cfg.method not in ("curve", "hybrid"):
        raise ValueError(f"fused_curve_enhance runs curve/hybrid, not "
                         f"{cfg.method!r}")
    _check_options(cfg)
    _check_block(xb)
    b, _, hb, wb = xb.shape
    if ds not in (1, 2, 4) or hb % ds or wb % ds:
        raise ValueError(f"maps at 1/{ds} need ds in (1, 2, 4) dividing "
                         f"the block {hb}x{wb}")
    if (maps.dtype != torch.float32 or maps.ndim != 5
            or maps.shape[0] != b
            or maps.shape[2:] != (3, hb // ds, wb // ds)):
        raise ValueError(f"expected f32 maps (B,it,3,HB/{ds},WB/{ds}) for "
                         f"block {tuple(xb.shape)}, got {maps.dtype} "
                         f"{tuple(maps.shape)}")
    if maps.device != xb.device:
        raise ValueError("block and maps lie on different devices")
    if gain is not None:
        _check_plane(gain, xb, "gain")
    m = _check_window(cfg, xb, halo, rows, img_w)
    if xb.device.type == "cpu":
        return fused_curve_enhance_plain(xb, maps, cfg, halo, rows, img_w,
                                         ds, gain)
    _check_cuda_tensor(xb)
    _check_cuda_tensor(maps)
    if gain is not None:
        _check_cuda_tensor(gain)
    lib = _build.load_library()
    phases = (ctypes.c_float * 8)(*_phase_consts(ds))
    out = torch.empty((b, 3, rows, wb), dtype=torch.uint8, device=xb.device)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_fused_curve_u8(
            xb.data_ptr(), maps.data_ptr(),
            None if gain is None else gain.data_ptr(), out.data_ptr(), b,
            hb, wb, halo, rows, maps.shape[1],
            int(cfg.method == "hybrid" and gain is None), m, img_w, ds,
            phases, *_boost_args(cfg, lib), *_tail_args(cfg), stream)
    _raise_on(rc, lib, "fused_curve_enhance")
    fused_curve_enhance.launches += 1
    return out


fused_curve_enhance.launches = 0


# --------------------------------------------------------------------- K4 #

def fused_retinex_ema_plain(xb, carry, cfg, halo, rows, img_w, alpha):
    """Plain version of K4: the JAX kernel's graph on the whole block with
    wrap shifts; the new carry is l_mix on the band [m, HB - m),
    edge-padded by m rows."""
    m = canvas_margin(cfg)
    x = normalize_u8(xb)
    l_now = separable_blur(torch.amax(x, dim=-3), cfg.blur_radius,
                           cfg.blur_sigma, roll2d)
    l_mix = torch.where(carry < 0.0, l_now,
                        alpha * l_now + (1.0 - alpha) * carry)
    gain = torch.exp(
        cfg.gamma * torch.log(torch.clamp(l_mix, cfg.illum_eps, 1.0))
        - torch.log(torch.clamp(l_now, cfg.illum_eps, 1.0)))
    gain = replicate_margin_cols(gain, img_w, m)
    out = _denoise_quantize(torch.clamp(x * gain[:, None], 0.0, 1.0), cfg,
                            halo, rows)
    band = l_mix[..., m:xb.shape[-2] - m, :]
    return out, pad_edge(band, m, m, 0, 0)


def fused_retinex_ema(
    xb: torch.Tensor,
    carry: torch.Tensor,
    cfg: PipelineConfig,
    halo: int,
    rows: int,
    img_w: int,
    alpha: float,
):
    """K4, one temporally smoothed retinex video step on a block: u8 block
    (B, 3, HB, WB) + f32 EMA carry (B, HB, WB) -> (u8 (B, 3, rows, WB), the
    block's rows [halo, halo + rows); the new f32 carry (B, HB, WB)).

    Per pixel: l_now = blur(max RGB); l_mix = l_now where the carry is
    negative (the not-set-yet sentinel), else alpha * l_now + (1 - alpha) *
    carry; gain = exp(gamma * log l_mix - log l_now), both clipped to
    [eps, 1], read at the nearest image column; then y = clip(x * gain),
    the denoise tail and quantize. The new carry is l_mix on the band
    [m, HB - m) and its edge rows repeated m times above and below; the
    carry rows outside the band are never read by a consumed pixel. Columns
    outside [m, m + img_w) of the output are not defined; those of the
    carry within the blur radius of the block's edges differ between the
    kernel (clamped reads) and the plain version (wrap shifts)."""
    if cfg.method != "retinex":
        raise ValueError(f"fused_retinex_ema runs method='retinex', not "
                         f"{cfg.method!r}")
    if not isinstance(alpha, numbers.Real):
        raise TypeError(f"alpha is a Python number, got {type(alpha)}")
    alpha = float(alpha)
    _check_options(cfg)
    _check_block(xb)
    _check_plane(carry, xb, "carry")
    m = _check_window(cfg, xb, halo, rows, img_w)
    if xb.device.type == "cpu":
        return fused_retinex_ema_plain(xb, carry, cfg, halo, rows, img_w,
                                       alpha)
    _check_cuda_tensor(xb)
    _check_cuda_tensor(carry)
    lib = _build.load_library()
    b, _, hb, wb = xb.shape
    out = torch.empty((b, 3, rows, wb), dtype=torch.uint8, device=xb.device)
    new_carry = torch.empty_like(carry)
    radius, taps, _, eps = _boost_args(cfg, lib)
    with torch.cuda.device(xb.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_fused_retinex_ema_u8(
            xb.data_ptr(), carry.data_ptr(), out.data_ptr(),
            new_carry.data_ptr(), b, hb, wb, halo, rows, m, img_w, alpha,
            1.0 - alpha, cfg.gamma, radius, taps, eps, *_tail_args(cfg),
            stream)
    _raise_on(rc, lib, "fused_retinex_ema")
    fused_retinex_ema.launches += 1
    return out, new_carry


fused_retinex_ema.launches = 0
