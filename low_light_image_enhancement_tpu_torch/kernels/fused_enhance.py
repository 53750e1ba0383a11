"""K1 (fused retinex), K3 (fused curve/hybrid tail) and K4 (the fused
retinex video step): wrappers, plain PyTorch versions and launch counts.

Each wrapper dispatches on the device of its input alone: a CPU tensor goes
to the plain version, a CUDA tensor to the hand-written kernels on the tile
engine of ``csrc/retinex_tile.cuh`` with the bilateral tails, or none
(``csrc/retinex_tile.cu``: K1 and K4; ``csrc/curve_tile.cu``: K3 and K1's
gain form), to the guided tail kernel ``fused_guided``
(``csrc/fused_guided.cuh``: ``fused_guided.cu``, ``guided_curve.cu``,
``guided_ema.cu``) and ``csrc/fused_enhance.cu`` (the blur past the
tiles), or the call raises. ``<wrapper>.launches`` counts the launches of
the wrapper's own kernel, and nothing else: the guided tail's launches
count on ``fused_guided.launches``, not on the wrapper that called it.

Every form of the JAX kernels runs: u8 or f32 I/O (f32 in [0, 1], clipped
and not quantized out), the bilateral or guided tail, any blur radius (past
``MAX_BLUR_RADIUS`` the blur runs first as ``blur_illumination`` into an
f32 plane that the kernel reads), and K1's ``stages``.

- K1 ``fused_retinex`` replaces the JAX package's
  ``kernels/fused_enhance.py::fused_retinex`` (``_retinex_kernel``) on
  (B, H, W, 3) images; ``fused_retinex_gain`` is its external-gain form on
  a block, with the contract of ``video._fused_gain_tail``, and counts its
  bilateral launches on ``fused_retinex``; ``fused_retinex_canvas`` is its
  form on the padded planar canvas (the JAX kernel's own input, which the
  planar and canvas entry points of ``pipeline`` stage), K3's kernel with
  K1's boost and no curve step, counted on its own.
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
    shift2d,
    upsample_maps,
)

STAGES = ("blur", "boost", "denoise")
_STAGE_BITS = {"blur": 1, "boost": 2, "denoise": 4}
# blur radii the kernels run on their tiles (csrc/fused_enhance.cuh
# MAX_BLUR_RADIUS, the size of _Boost.taps, which the library checks); a
# wider blur runs first as blur_illumination
MAX_BLUR_RADIUS = 8
_IO_DTYPES = (torch.uint8, torch.float32)


def _stage_set(stages) -> frozenset:
    """``stages`` (None: all three) as a set, each one of STAGES."""
    if stages is None:
        return frozenset(STAGES)
    stages = frozenset(stages)
    if not stages <= set(STAGES):
        raise ValueError(f"stages are a subset of {STAGES}: "
                         f"{sorted(stages)}")
    return stages


def _tail_runs(cfg: PipelineConfig, stages=frozenset(STAGES)) -> bool:
    return cfg.denoise_strength > 0.0 and "denoise" in stages


def _guided(cfg: PipelineConfig, stages=frozenset(STAGES)) -> bool:
    """The guided tail runs (``fused_guided``)."""
    return cfg.denoise_taps == "guided" and _tail_runs(cfg, stages)


def _check_io(x: torch.Tensor, what: str) -> None:
    if x.dtype not in _IO_DTYPES:
        raise TypeError(f"{what} is uint8 or float32, got {x.dtype}")


def _check_block(xb: torch.Tensor) -> None:
    _check_io(xb, "the block")
    if xb.ndim != 4 or xb.shape[1] != 3 or 0 in xb.shape:
        raise ValueError(f"expected a (B,3,HB,WB) block, got "
                         f"{tuple(xb.shape)}")


def _finish(y: torch.Tensor, u8: bool) -> torch.Tensor:
    """Clipped y out: quantized for u8 I/O, as it is for f32."""
    y = torch.clamp(y, 0.0, 1.0)
    return quantize_u8(y) if u8 else y


def _to_float(x: torch.Tensor) -> torch.Tensor:
    """A u8 tensor normalized to [0, 1]; an f32 one as it is."""
    _check_io(x, "the input")
    return normalize_u8(x) if x.dtype == torch.uint8 else x


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


def _boost_args(cfg: PipelineConfig):
    """radius, the host taps (read up to MAX_BLUR_RADIUS), gamma - 1,
    eps."""
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


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


# ------------------------------------------------- the guided tail's args #

class _Boost(ctypes.Structure):
    _fields_ = [("radius", ctypes.c_int),
                ("taps", ctypes.c_float * (2 * MAX_BLUR_RADIUS + 1)),
                ("gm1", ctypes.c_float), ("eps", ctypes.c_float)]


class _Up(ctypes.Structure):
    _fields_ = [("f", ctypes.c_float * 8)]


class _Ema(ctypes.Structure):
    _fields_ = [("alpha", ctypes.c_float), ("beta", ctypes.c_float),
                ("gamma", ctypes.c_float)]


class _GuidedParams(ctypes.Structure):
    _fields_ = [("radius", ctypes.c_int), ("k", ctypes.c_float),
                ("eps", ctypes.c_float), ("strength", ctypes.c_float),
                ("joint", ctypes.c_int)]


class _GuidedArgs(ctypes.Structure):
    """csrc/fused_guided.cuh FusedGuidedArgs."""
    _fields_ = [(n, ctypes.c_void_p) for n in
                ("inp", "out", "maps", "gain", "lp", "carry", "ncarry")] + [
        (n, ctypes.c_int) for n in
        ("family", "f32", "B", "H", "W", "halo", "rows", "m", "img_w",
         "n_iter", "ds", "boost", "stages", "lpe", "parts")] + [
        ("bp", _Boost), ("up", _Up), ("ep", _Ema), ("gp", _GuidedParams)]


_FAMILY = {"retinex": 0, "gain": 1, "curve": 2, "ema": 3}


def _ptr(t):
    return None if t is None else t.data_ptr()


PARTS_ALL = 3   # csrc/fused_guided.cuh PART_TAIL | PART_STORE


def fused_guided(family: str, cfg: PipelineConfig, xin, out, *, B, H, W,
                 stages=frozenset(STAGES), halo=0, rows=0, m=0, img_w=0,
                 maps=None, gain=None, lp=None, lpe=0, carry=None,
                 ncarry=None, n_iter=0, ds=1, boost=0, ema=None,
                 what="", parts=PARTS_ALL) -> None:
    """The guided tail kernel (``csrc/fused_guided.cuh``) of K1
    (``family`` "retinex"), K1's gain form ("gain"), K3 ("curve") or K4
    ("ema") on CUDA tensors, as ``fused_retinex``, ``fused_retinex_gain``,
    ``fused_curve_enhance`` and ``fused_retinex_ema`` call it for
    ``denoise_taps="guided"``; ``out`` is written. ``parts`` runs fewer
    of the kernel's parts after its staging (tools/profile_torch.py
    ``stages_guided``). Counts its launches on ``fused_guided.launches``."""
    lib = _build.load_library()
    if lib.llie_fused_guided_args_size() != ctypes.sizeof(_GuidedArgs):
        raise RuntimeError("csrc/fused_guided.cuh FusedGuidedArgs and its "
                           "mirror _GuidedArgs differ")
    a = _GuidedArgs()
    a.inp, a.out = xin.data_ptr(), out.data_ptr()
    a.maps, a.gain, a.lp = _ptr(maps), _ptr(gain), _ptr(lp)
    a.carry, a.ncarry = _ptr(carry), _ptr(ncarry)
    a.family, a.f32 = _FAMILY[family], int(xin.dtype == torch.float32)
    a.B, a.H, a.W = B, H, W
    a.halo, a.rows, a.m, a.img_w = halo, rows, m, img_w
    a.n_iter, a.ds, a.boost = n_iter, ds, boost
    a.stages = sum(_STAGE_BITS[s] for s in stages)
    a.lpe, a.parts = lpe, parts
    radius, taps, gm1, eps = _boost_args(cfg)
    # the taps on the tile; a wider blur comes in lp (or is not run)
    a.bp.radius = radius if lp is None and radius <= MAX_BLUR_RADIUS else 0
    for k in range(2 * a.bp.radius + 1):
        a.bp.taps[k] = taps[k]
    a.bp.gm1, a.bp.eps = gm1, eps
    for k, f in enumerate(_phase_consts(ds)):
        a.up.f[k] = f
    if ema is not None:
        a.ep.alpha, a.ep.beta, a.ep.gamma = ema
    r = cfg.guided_radius
    a.gp.radius, a.gp.k, a.gp.eps = r, 1.0 / (2 * r + 1), cfg.guided_eps
    a.gp.strength = cfg.denoise_strength
    a.gp.joint = int(cfg.denoise_guide == "luma")
    with torch.cuda.device(xin.device):
        rc = lib.llie_fused_guided(ctypes.byref(a), _stream(xin))
    _raise_on(rc, lib, what)
    fused_guided.launches += 1


fused_guided.launches = 0


# ------------------------------------------- blurs past MAX_BLUR_RADIUS #

_TAPS = {}
# blur_illumination reads its taps in blocks of 16 (csrc/fused_enhance.cu
# blur::KB): zero-padded to a whole block, 16-byte aligned
BLUR_TAP_BLOCK = 16


def _device_taps(cfg: PipelineConfig, device) -> torch.Tensor:
    key = (cfg.blur_radius, cfg.blur_sigma, str(device))
    if key not in _TAPS:
        taps = gaussian_kernel_1d(cfg.blur_radius, cfg.blur_sigma)
        n = -(-len(taps) // BLUR_TAP_BLOCK) * BLUR_TAP_BLOCK
        padded = torch.zeros(n, dtype=torch.float32, device=device)
        padded[:len(taps)] = torch.tensor(taps, dtype=torch.float32)
        _TAPS[key] = padded
    return _TAPS[key]


def blur_illumination_plain(x: torch.Tensor, cfg: PipelineConfig, e: int,
                            hwc: bool) -> torch.Tensor:
    """Plain version of ``blur_illumination``: max RGB of the (B, H, W, 3)
    image (``hwc``) or the (B, 3, H, W) block, edge-padded by ``e``, blurred
    with clamped shifts."""
    xf = _to_float(x.permute(0, 3, 1, 2) if hwc else x)
    l0 = pad_edge(torch.amax(xf, dim=-3), e, e, e, e)
    return separable_blur(l0, cfg.blur_radius, cfg.blur_sigma, shift2d)


def blur_illumination(x: torch.Tensor, cfg: PipelineConfig, e: int,
                      hwc: bool) -> torch.Tensor:
    """The blurred illumination of ``cfg.blur_radius`` (any radius) as an
    f32 plane (B, H + 2e, W + 2e): grid (Y, X) <-> pixel (Y - e, X - e) of
    the (B, H, W, 3) image (``hwc``) or the (B, 3, H, W) block, from reads
    clamped into it, in the kernels' tap order. The kernels read it in
    place of their own blur for radii past MAX_BLUR_RADIUS; a CPU tensor
    gets the plain version, a CUDA tensor the one tiled launch of
    ``csrc/fused_enhance.cu`` (no scratch besides the plane)."""
    if x.device.type == "cpu":
        return blur_illumination_plain(x, cfg, e, hwc)
    _check_cuda_tensor(x)
    lib = _build.load_library()
    b, h, w = (x.shape[0], *x.shape[1:3]) if hwc else (x.shape[0],
                                                        *x.shape[2:])
    lplane = torch.empty((b, h + 2 * e, w + 2 * e), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.llie_blur_illumination(
            x.data_ptr(), int(x.dtype == torch.float32), int(hwc),
            lplane.data_ptr(), b, h, w, e, cfg.blur_radius,
            _device_taps(cfg, x.device).data_ptr(), _stream(x))
    _raise_on(rc, lib, "blur_illumination")
    blur_illumination.launches += 1
    return lplane


blur_illumination.launches = 0


def _wide_blur(cfg: PipelineConfig) -> bool:
    return cfg.blur_radius > MAX_BLUR_RADIUS


# --------------------------------------------------------------------- K1 #

def boost_stages(x: torch.Tensor, cfg: PipelineConfig,
                 stages=frozenset(STAGES)) -> torch.Tensor:
    """The JAX kernel's gated boost on a padded planar canvas (with both
    stages ``core.illumination_boost``, op for op): without "blur" the
    illumination is max RGB itself, without "boost" the gain is the
    clipped illumination, without either x is returned as it is."""
    blur, boost = "blur" in stages, "boost" in stages
    if not (blur or boost):
        return x
    l = torch.amax(x, dim=-3)
    if blur:
        l = separable_blur(l, cfg.blur_radius, cfg.blur_sigma, roll2d)
    l = torch.clamp(l, cfg.illum_eps, 1.0)
    if boost:
        l = torch.exp((cfg.gamma - 1.0) * torch.log(l))
    return torch.clamp(x * l[..., None, :, :], 0.0, 1.0)


def fused_retinex_plain(imgs: torch.Tensor, cfg: PipelineConfig,
                        stages=None) -> torch.Tensor:
    """Plain version of K1: replicate-pad to the canvas, the stages of
    ``core.enhance_core_padded`` with wrap shifts, crop."""
    stages = _stage_set(stages)
    _, h, w, _ = imgs.shape
    plan = plan_canvas(h, w, canvas_margin(cfg))
    xp = pad_planar(_to_float(imgs.permute(0, 3, 1, 2)), plan, h, w)
    y = boost_stages(xp, cfg, stages)
    if _tail_runs(cfg, stages):
        y = denoise_tail(y, cfg)
    m = plan.margin
    return _finish(y[..., m:m + h, m:m + w], imgs.dtype == torch.uint8) \
        .permute(0, 2, 3, 1).contiguous()


def fused_retinex(imgs: torch.Tensor, cfg: PipelineConfig, *,
                  stages=None) -> torch.Tensor:
    """K1: (B, H, W, 3) uint8 or float32 -> the same, the default retinex
    graph (max-RGB illumination, blur, boost, denoise, quantize or clip).
    ``stages``: a subset of ("blur", "boost", "denoise") that gates them as
    the JAX kernel does (for per-stage timing; None runs all). Its form with
    an external gain plane is ``fused_retinex_gain``."""
    if cfg.method != "retinex":
        raise ValueError(f"fused_retinex runs method='retinex', not "
                         f"{cfg.method!r}")
    stages = _stage_set(stages)
    _check_io(imgs, "the image")
    if imgs.ndim != 4 or imgs.shape[-1] != 3 or 0 in imgs.shape:
        raise ValueError(f"expected non-empty (B,H,W,3), got "
                         f"{tuple(imgs.shape)}")
    if imgs.device.type == "cpu":
        return fused_retinex_plain(imgs, cfg, stages)
    _check_cuda_tensor(imgs)
    lib = _build.load_library()
    b, h, w, _ = imgs.shape
    out = torch.empty_like(imgs)
    guided = _guided(cfg, stages)
    # the ring the kernel reads the illumination on: the tail's reach
    e = 2 * cfg.guided_radius if guided else 1
    lp = (blur_illumination(imgs, cfg, e, hwc=True)
          if _wide_blur(cfg) and "blur" in stages else None)
    if guided:
        fused_guided("retinex", cfg, imgs, out, B=b, H=h, W=w,
                     stages=stages, lp=lp, lpe=e, what="fused_retinex")
        return out
    with torch.cuda.device(imgs.device):
        rc = lib.llie_fused_retinex(
            imgs.data_ptr(), out.data_ptr(),
            int(imgs.dtype == torch.float32), _ptr(lp), b, h, w,
            sum(_STAGE_BITS[s] for s in stages), *_boost_args(cfg),
            *_tail_args(cfg), _stream(imgs))
    _raise_on(rc, lib, "fused_retinex")
    fused_retinex.launches += 1
    return out


fused_retinex.launches = 0


def fused_retinex_gain_plain(xb, gain, cfg, halo, rows):
    """Plain version of K1's gain form: ``y = clip(x * gain)``, the denoise
    tail and quantize (u8) or clip (f32) on the window ``[halo - m, halo +
    rows + m)``, with wrap shifts."""
    m = canvas_margin(cfg)
    win = slice(halo - m, halo + rows + m)
    y = torch.clamp(_to_float(xb[..., win, :]) * gain[:, None, win, :],
                    0.0, 1.0)
    return _denoise_finish(y, cfg, m, rows, xb.dtype == torch.uint8)


def _denoise_finish(y: torch.Tensor, cfg: PipelineConfig, r0: int,
                    rows: int, u8: bool) -> torch.Tensor:
    """The plain versions' common end: the denoise tail (wrap shifts),
    rows [r0, r0 + rows), clipped, u8 or f32."""
    if cfg.denoise_strength > 0.0:
        y = denoise_tail(y, cfg)
    return _finish(y[..., r0:r0 + rows, :], u8)


def fused_retinex_gain(xb: torch.Tensor, gain: torch.Tensor,
                       cfg: PipelineConfig, halo: int,
                       rows: int) -> torch.Tensor:
    """K1 with an external gain plane: u8 or f32 block (B, 3, HB, WB) + f32
    gain (B, HB, WB) -> (B, 3, rows, WB) of the block's dtype, the block's
    rows [halo, halo + rows). The gain is read where it lies: it already
    carries the margin column replica. Counts its bilateral launches on
    ``fused_retinex`` (the guided tail's on ``fused_guided``)."""
    if cfg.method != "retinex":
        raise ValueError(f"fused_retinex_gain runs method='retinex', not "
                         f"{cfg.method!r}")
    _check_block(xb)
    _check_plane(gain, xb, "gain")
    m = _check_window(cfg, xb, halo, rows)
    if xb.device.type == "cpu":
        return fused_retinex_gain_plain(xb, gain, cfg, halo, rows)
    _check_cuda_tensor(xb)
    _check_cuda_tensor(gain)
    lib = _build.load_library()
    b, _, hb, wb = xb.shape
    out = torch.empty((b, 3, rows, wb), dtype=xb.dtype, device=xb.device)
    if _guided(cfg):
        fused_guided("gain", cfg, xb, out, B=b, H=hb, W=wb, halo=halo,
                     rows=rows, m=m, gain=gain, what="fused_retinex_gain")
        return out
    with torch.cuda.device(xb.device):
        rc = lib.llie_fused_retinex_gain(
            xb.data_ptr(), gain.data_ptr(), out.data_ptr(),
            int(xb.dtype == torch.float32), b, hb, wb, halo, rows,
            *_tail_args(cfg), _stream(xb))
    _raise_on(rc, lib, "fused_retinex_gain")
    fused_retinex.launches += 1
    return out


BOOST_CANVAS = 2   # csrc/fused_enhance.cuh: K1's boost, no margin replica


def fused_retinex_canvas_plain(xb, cfg, halo, rows):
    """Plain version of K1's canvas form: the K1 graph (``core``'s
    illumination boost and denoise tail, wrap shifts) on the window
    ``[halo - m, halo + rows + m)`` of the block, quantized (u8) or
    clipped (f32)."""
    m = canvas_margin(cfg)
    y = illumination_boost(_to_float(xb[..., halo - m:halo + rows + m, :]),
                           cfg)
    return _denoise_finish(y, cfg, m, rows, xb.dtype == torch.uint8)


def fused_retinex_canvas(xb: torch.Tensor, cfg: PipelineConfig, halo: int,
                         rows: int) -> torch.Tensor:
    """K1's canvas form: u8 or f32 planar block (B, 3, HB, WB), replicate
    padded with ``halo`` rows above the output rows and
    ``canvas_margin(cfg)`` columns before the image (``core.pad_planar``'s
    canvas, halo = margin), -> (B, 3, rows, WB) of the block's dtype: output
    row r is block row halo + r (row 0 the image's row 0), columns keep the
    margin offset. Only the image's rows x [m, m + w) are defined; the
    margin columns and the rows past the image are not (the caller crops
    them). It runs K1's graph: max RGB, blur, boost, the denoise tail, then
    quantize or clip; past MAX_BLUR_RADIUS the blur runs first as
    ``blur_illumination`` into a plane of the block. Its bilateral launches
    count on ``fused_retinex_canvas.launches``, the guided tail's on
    ``fused_guided.launches``."""
    if cfg.method != "retinex":
        raise ValueError(f"fused_retinex_canvas runs method='retinex', not "
                         f"{cfg.method!r}")
    _check_block(xb)
    m = _check_window(cfg, xb, halo, rows)
    if xb.device.type == "cpu":
        return fused_retinex_canvas_plain(xb, cfg, halo, rows)
    _check_cuda_tensor(xb)
    lib = _build.load_library()
    b, _, hb, wb = xb.shape
    out = torch.empty((b, 3, rows, wb), dtype=xb.dtype, device=xb.device)
    lp = blur_illumination(xb, cfg, 0, hwc=False) if _wide_blur(cfg) \
        else None
    if _guided(cfg):
        fused_guided("curve", cfg, xb, out, B=b, H=hb, W=wb, halo=halo,
                     rows=rows, m=m, lp=lp, boost=BOOST_CANVAS,
                     what="fused_retinex_canvas")
        return out
    with torch.cuda.device(xb.device):
        rc = lib.llie_fused_retinex_canvas(
            xb.data_ptr(), _ptr(lp), out.data_ptr(),
            int(xb.dtype == torch.float32), b, hb, wb, halo, rows,
            *_boost_args(cfg), *_tail_args(cfg), _stream(xb))
    _raise_on(rc, lib, "fused_retinex_canvas")
    fused_retinex_canvas.launches += 1
    return out


fused_retinex_canvas.launches = 0


# --------------------------------------------------------------------- K3 #

def fused_curve_enhance_plain(xb, maps, cfg, halo, rows, img_w, ds=1,
                              gain=None):
    """Plain version of K3: the JAX kernel's graph on the window
    ``[halo - m, halo + rows + m)`` of the block, with wrap shifts. Maps at
    1/ds are first upsampled over the whole block (``upsample_maps``,
    columns then rows, clamped at the block's edges)."""
    m = canvas_margin(cfg)
    win = slice(halo - m, halo + rows + m)
    y = _to_float(xb[..., win, :])
    if gain is not None:
        y = torch.clamp(y * gain[:, None, win, :], 0.0, 1.0)
    elif cfg.method == "hybrid":
        y = replicate_margin_cols(illumination_boost(y, cfg), img_w, m)
    maps = upsample_maps(maps, ds)
    y = torch.clamp(apply_curves(y, maps[..., win, :]), 0.0, 1.0)
    return _denoise_finish(y, cfg, m, rows, xb.dtype == torch.uint8)


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
    """K3: u8 or f32 block (B, 3, HB, WB) + f32 curve maps (B, n_iter, 3,
    HB/ds, WB/ds), ds 1, 2 or 4, -> (B, 3, rows, WB) of the block's dtype,
    the block's rows [halo, halo + rows).

    The block has ``canvas_margin(cfg)`` replicate columns before the
    image's column 0 and ``img_w`` image columns. Output columns outside
    [m, m + img_w) are not defined (the caller crops them). With ``gain``
    (f32 (B, HB, WB), the video path's temporally smoothed gain) the image
    is ``clip(x * gain)`` before the curves, in place of hybrid's boost and
    its column replica."""
    if cfg.method not in ("curve", "hybrid"):
        raise ValueError(f"fused_curve_enhance runs curve/hybrid, not "
                         f"{cfg.method!r}")
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
    out = torch.empty((b, 3, rows, wb), dtype=xb.dtype, device=xb.device)
    boost = int(cfg.method == "hybrid" and gain is None)
    lp = (blur_illumination(xb, cfg, 0, hwc=False)
          if boost and _wide_blur(cfg) else None)
    if _guided(cfg):
        fused_guided("curve", cfg, xb, out, B=b, H=hb, W=wb, halo=halo,
                     rows=rows, m=m, img_w=img_w, maps=maps, gain=gain,
                     lp=lp, n_iter=maps.shape[1], ds=ds, boost=boost,
                     what="fused_curve_enhance")
        return out
    phases = (ctypes.c_float * 8)(*_phase_consts(ds))
    with torch.cuda.device(xb.device):
        rc = lib.llie_fused_curve(
            xb.data_ptr(), maps.data_ptr(), _ptr(gain), _ptr(lp),
            out.data_ptr(), int(xb.dtype == torch.float32), b, hb, wb,
            halo, rows, maps.shape[1], boost, m, img_w, ds, phases,
            *_boost_args(cfg), *_tail_args(cfg), _stream(xb))
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
    x = _to_float(xb)
    l_now = separable_blur(torch.amax(x, dim=-3), cfg.blur_radius,
                           cfg.blur_sigma, roll2d)
    l_mix = torch.where(carry < 0.0, l_now,
                        alpha * l_now + (1.0 - alpha) * carry)
    gain = torch.exp(
        cfg.gamma * torch.log(torch.clamp(l_mix, cfg.illum_eps, 1.0))
        - torch.log(torch.clamp(l_now, cfg.illum_eps, 1.0)))
    gain = replicate_margin_cols(gain, img_w, m)
    out = _denoise_finish(torch.clamp(x * gain[:, None], 0.0, 1.0), cfg,
                          halo, rows, xb.dtype == torch.uint8)
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
    """K4, one temporally smoothed retinex video step on a block: u8 or f32
    block (B, 3, HB, WB) + f32 EMA carry (B, HB, WB) -> ((B, 3, rows, WB) of
    the block's dtype, the block's rows [halo, halo + rows); the new f32
    carry (B, HB, WB)).

    Per pixel: l_now = blur(max RGB); l_mix = l_now where the carry is
    negative (the not-set-yet sentinel), else alpha * l_now + (1 - alpha) *
    carry; gain = exp(gamma * log l_mix - log l_now), both clipped to
    [eps, 1], read at the nearest image column; then y = clip(x * gain),
    the denoise tail and quantize (or clip). The new carry is l_mix on the
    band [m, HB - m) and its edge rows repeated m times above and below; the
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
    out = torch.empty((b, 3, rows, wb), dtype=xb.dtype, device=xb.device)
    new_carry = torch.empty_like(carry)
    lp = blur_illumination(xb, cfg, 0, hwc=False) if _wide_blur(cfg) \
        else None
    if _guided(cfg):
        fused_guided("ema", cfg, xb, out, B=b, H=hb, W=wb, halo=halo,
                     rows=rows, m=m, img_w=img_w, lp=lp, carry=carry,
                     ncarry=new_carry, ema=(alpha, 1.0 - alpha, cfg.gamma),
                     what="fused_retinex_ema")
        return out, new_carry
    radius, taps, _, eps = _boost_args(cfg)
    with torch.cuda.device(xb.device):
        rc = lib.llie_fused_retinex_ema(
            xb.data_ptr(), carry.data_ptr(), _ptr(lp), out.data_ptr(),
            new_carry.data_ptr(), int(xb.dtype == torch.float32), b, hb,
            wb, halo, rows, m, img_w, alpha, 1.0 - alpha, cfg.gamma,
            radius, taps, eps, *_tail_args(cfg), _stream(xb))
    _raise_on(rc, lib, "fused_retinex_ema")
    fused_retinex_ema.launches += 1
    return out, new_carry


fused_retinex_ema.launches = 0
