"""Block-form graph of the learned methods: curve and hybrid (at every
``curve_downsample``), fcn and decom, each net under ``conv_impl`` "xla"
(``F.conv2d``), "pallas" (K6; fcn also "cascade", K7), "gemm" (patch and
im2col GEMMs) or "packed"/"packed12" (convs on space-to-depth lanes; see
``resolve_conv_impl``).

The net consumes the image extended by ``canvas_margin`` replicate
rows/cols on each side and zeros beyond (``_mask_extent``); conv SAME
zero padding at the block edge coincides with that mask, so alignment
padding never reaches a consumed pixel. The curve/hybrid tail (curves,
denoise, quantize) runs as K3, ``kernels.fused_enhance.fused_curve_enhance``,
which takes the contract of the JAX package's ``blocks._fused_curve_tail``:
at ``curve_downsample`` 2 and 4 it takes the CNN's 1/ds maps and upsamples
them itself, at 1 and 8 it takes full-resolution maps (ds 8 is upsampled
here first, with ``ops.filters.upsample_maps``). The fcn/decom tail
(denoise) runs as K5, ``kernels.tiled_denoise.tiled_denoise``, and the
quantize after it.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
    denoise_radius,
)
from low_light_image_enhancement_tpu_torch.core import (
    MARGIN,
    illumination_boost,
    replicate_margin_cols,
)
from low_light_image_enhancement_tpu_torch.kernels.fcn_cascade import (
    apply_fcn_cascade,
)
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    _to_float,
    fused_curve_enhance,
)
from low_light_image_enhancement_tpu_torch.kernels.tiled_denoise import (
    tiled_denoise,
)
from low_light_image_enhancement_tpu_torch.models.curve_cnn import (
    apply_curve_cnn,
    apply_curve_cnn_gemm,
    apply_curve_cnn_packed,
    apply_curve_cnn_pallas,
)
from low_light_image_enhancement_tpu_torch.models.decom import (
    apply_decom_net,
    apply_decom_net_gemm,
    apply_decom_net_packed,
    apply_decom_net_pallas,
)
from low_light_image_enhancement_tpu_torch.models.fcn import (
    _dilations,
    apply_fcn,
    apply_fcn_gemm,
    apply_fcn_packed,
    apply_fcn_pallas,
)
from low_light_image_enhancement_tpu_torch.ops.colorspace import quantize_u8
from low_light_image_enhancement_tpu_torch.ops.filters import upsample_maps
from low_light_image_enhancement_tpu_torch.utils.profiling import stage

__all__ = ["cnn_radius", "learned_halo", "single_block_halo",
           "block_geometry", "resolve_conv_impl", "replicate_margin_cols",
           "kernel_maps_ds", "maps_at_kernel_ds", "curve_maps_for_kernel",
           "block_curve_maps",
           "block_net_image", "enhance_learned_block"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cnn_radius(cfg: PipelineConfig) -> int:
    """Receptive-field radius (full-resolution pixels) of the method's net;
    0 for methods with no net."""
    if cfg.method in ("curve", "hybrid"):
        ds = cfg.curve_downsample
        return 7 if ds == 1 else 9 * ds
    if cfg.method == "fcn":
        return sum(_dilations())
    if cfg.method == "decom":
        return 5
    return 0


def learned_halo(cfg: PipelineConfig) -> int:
    """Halo rows per side of a block that must carry real neighbor content
    (the sharded contract): the full receptive radius, rounded to 8 (8*ds
    for the curve methods), floored at margin + denoise radius."""
    r = cnn_radius(cfg)
    if cfg.method == "hybrid":
        r += cfg.blur_radius
    r += denoise_radius(cfg)
    granule = 8 * cfg.curve_downsample if cfg.method in ("curve", "hybrid") \
        else 8
    floor = canvas_margin(cfg) + denoise_radius(cfg)
    return _round_up(max(r, floor), granule)


def single_block_halo(cfg: PipelineConfig) -> int:
    """Halo rows of an unsharded block (the whole image is one block):
    smaller than ``learned_halo`` and giving the same consumed pixels, since
    the input mask zeroes beyond image + margin either way (the JAX
    package's derivation at ``blocks.single_block_halo``)."""
    if cfg.denoise_taps == "guided":
        return learned_halo(cfg)
    if cfg.method == "fcn":
        return _round_up(sum(_dilations()[1:]) + denoise_radius(cfg), 8)
    r = canvas_margin(cfg)
    if cfg.method == "hybrid":
        r += cfg.blur_radius
    granule = 8 * cfg.curve_downsample if cfg.method in ("curve", "hybrid") \
        else 8
    return _round_up(r, granule)


def block_geometry(cfg: PipelineConfig, h: int, w: int, n_shards: int = 1):
    """(rows_per_shard, padded_w) of the block graph: rows rounded to the
    granule, width padded to 128 with ``canvas_margin`` cols before the
    image origin."""
    halo = learned_halo(cfg)
    granule = 8
    if cfg.method in ("curve", "hybrid"):
        granule = 8 * cfg.curve_downsample
    hl = _round_up(int(math.ceil(h / n_shards)), granule)
    if n_shards > 1 and hl < halo:
        raise ValueError(
            f"{n_shards} spatial shards of a {h}-row image give {hl} "
            f"rows/shard, below the {halo}-row receptive-field halo of "
            f"method={cfg.method!r}; use fewer shards or larger frames"
        )
    wp = _round_up(w + 2 * canvas_margin(cfg), 128)
    return hl, wp


def resolve_conv_impl(cfg: PipelineConfig) -> PipelineConfig:
    """The conv arm the nets run, as the JAX package resolves it:

    - ``auto`` and ``xla`` -> ``xla``, the nets' convs as ``F.conv2d``.
      ``auto`` never picks another arm here: the JAX package's TPU batch
      bands (``blocks.AUTO_CONV_BANDS``) were measured on a TPU.
    - ``pallas`` stays: every net's 3x3 convs past the stem run as K6
      (``kernels/mxu_conv.py``), K6a for curve, hybrid and decom, K6b for
      fcn.
    - ``cascade`` stays on fcn (its c2-c7 as one K7 launch,
      ``kernels/fcn_cascade.py``) and is ``xla`` on the other methods.
    - ``gemm``, ``packed`` and ``packed12`` stay: the JAX package's arms of
      ``ops/patch_conv.py``, plain PyTorch here as plain jnp there
      (``gemm`` the nets' convs as patch or im2col GEMMs, ``packed`` and
      ``packed12`` one conv a layer on space-to-depth lanes, block (2, 2)
      and (1, 2)).

    ``auto`` may pick the fastest arm for the batch once the port's
    benchmark has measured the arms on the card (ROADMAP Queue 1, item 1).
    The device of the tensors picks a kernel or its plain version, as for
    every kernel of this package; ``use_pallas`` has no effect."""
    if cfg.conv_impl in ("auto", "xla") or (
            cfg.conv_impl == "cascade" and cfg.method != "fcn"):
        return cfg.replace(conv_impl="xla")
    return cfg


def _mask_extent(y: torch.Tensor, row0: int, h: int, w: int,
                 m: int = MARGIN) -> torch.Tensor:
    """Zero everything outside the image extended by ``m`` replicate
    rows/cols. Block row l <-> image row row0 + l; block col c <-> image
    col c - m."""
    hb, wb = y.shape[-2], y.shape[-1]
    g = row0 + torch.arange(hb, device=y.device)
    row_ok = (g >= -m) & (g < h + m)
    col_ok = torch.arange(wb, device=y.device) < w + 2 * m
    return torch.where(row_ok[:, None] & col_ok[None, :], y,
                       torch.zeros((), dtype=y.dtype, device=y.device))


def _curve_maps_lowres(cnn_in: torch.Tensor, cfg: PipelineConfig,
                       params: Dict[str, Any]) -> torch.Tensor:
    """LE-curve maps (B, n_iter, 3, HB/ds, WB/ds) of the CNN run on the
    block downsampled by ``ds = curve_downsample``, float32, not
    upsampled. The downsample antialiases, as ``jax.image.resize(method=
    "bilinear")`` does when it shrinks (the two agree within 1.2e-7)."""
    ds = cfg.curve_downsample
    if ds > 1:
        hb, wb = cnn_in.shape[-2:]
        if hb % ds or wb % ds:
            raise ValueError(
                f"block {hb}x{wb} not divisible by curve_downsample={ds}")
        cnn_in = F.interpolate(cnn_in, size=(hb // ds, wb // ds),
                               mode="bilinear", antialias=True,
                               align_corners=False)
    apply = {"pallas": apply_curve_cnn_pallas,
             "gemm": apply_curve_cnn_gemm,
             "packed": apply_curve_cnn_packed,
             "packed12": partial(apply_curve_cnn_packed, block=(1, 2)),
             }.get(cfg.conv_impl, apply_curve_cnn)
    with stage("nets.curve_cnn", cnn_in.device, batch=cnn_in.shape[0]):
        return apply(params, cnn_in, n_iter=cfg.curve_iters,
                     compute_dtype=cfg.compute_dtype)


def _curve_maps(cnn_in: torch.Tensor, cfg: PipelineConfig,
                params: Dict[str, Any]) -> torch.Tensor:
    """Full-resolution LE-curve maps (B, n_iter, 3, HB, WB): the low-res
    maps, then the upsample of record, columns first, then rows."""
    return upsample_maps(_curve_maps_lowres(cnn_in, cfg, params),
                         cfg.curve_downsample)


def kernel_maps_ds(cfg: PipelineConfig) -> int:
    """The resolution factor of the maps K3 takes for ``cfg``: 2 and 4 go
    in low-res and K3 upsamples them; 1 and 8 go in full-res."""
    return cfg.curve_downsample if cfg.curve_downsample in (2, 4) else 1


def maps_at_kernel_ds(maps: torch.Tensor, cfg: PipelineConfig
                      ) -> torch.Tensor:
    """Maps at 1/``curve_downsample`` brought to ``kernel_maps_ds(cfg)``:
    ds 8 upsampled here to full resolution, the others as they are."""
    return upsample_maps(maps, cfg.curve_downsample // kernel_maps_ds(cfg))


def curve_maps_for_kernel(cnn_in: torch.Tensor, cfg: PipelineConfig,
                          params: Dict[str, Any]) -> torch.Tensor:
    """The maps of a masked CNN input at ``kernel_maps_ds(cfg)``."""
    return maps_at_kernel_ds(_curve_maps_lowres(cnn_in, cfg, params), cfg)


def block_curve_maps(
    xb: torch.Tensor,
    cfg: PipelineConfig,
    model_params: Dict[str, Any],
    row0: int,
    h: int,
    w: int,
) -> torch.Tensor:
    """Curve maps of a u8 or f32 block as K3 takes them, (B, n_iter, 3, HB/k,
    WB/k) with ``k = kernel_maps_ds(cfg)``: the CNN runs on the normalized
    block (hybrid: boosted, margin cols re-replicated, so the
    CNN never sees the wrap shifts' opposite-edge content), zeroed beyond
    image + margin."""
    cfg = resolve_conv_impl(cfg)
    if cfg.method not in ("curve", "hybrid"):
        raise ValueError(
            f"method {cfg.method!r} has no curve maps (curve and hybrid do)")
    m = canvas_margin(cfg)
    y = _to_float(xb)
    if cfg.method == "hybrid":
        y = replicate_margin_cols(illumination_boost(y, cfg), w, m)
    return curve_maps_for_kernel(_mask_extent(y, row0, h, w, m), cfg,
                                 model_params)


def block_net_image(
    xb: torch.Tensor,
    cfg: PipelineConfig,
    model_params: Dict[str, Any],
    row0: int,
    h: int,
    w: int,
) -> torch.Tensor:
    """fcn/decom: the net's enhanced f32 block (B, 3, HB, WB) in [0, 1],
    before the denoise tail. The net runs on the normalized block, zeroed
    beyond image + margin; decom relights its reflectance by
    ``clip(L, illum_eps, 1) ** decom_gamma``."""
    cfg = resolve_conv_impl(cfg)
    if cfg.method not in ("fcn", "decom"):
        raise ValueError(f"method {cfg.method!r} is not fcn or decom")
    cnn_in = _mask_extent(_to_float(xb), row0, h, w, canvas_margin(cfg))
    b = cnn_in.shape[0]
    if cfg.method == "fcn":
        apply = {"pallas": apply_fcn_pallas,
                 "cascade": apply_fcn_cascade,
                 "gemm": apply_fcn_gemm,
                 "packed": apply_fcn_packed,
                 "packed12": partial(apply_fcn_packed, block=(1, 2)),
                 }.get(cfg.conv_impl, apply_fcn)
        with stage("nets.fcn", cnn_in.device, batch=b):
            y = apply(model_params, cnn_in, compute_dtype=cfg.compute_dtype)
        return torch.clamp(y, 0.0, 1.0)
    apply = {"pallas": apply_decom_net_pallas,
             "gemm": apply_decom_net_gemm,
             "packed": apply_decom_net_packed,
             "packed12": partial(apply_decom_net_packed, block=(1, 2)),
             }.get(cfg.conv_impl, apply_decom_net)
    with stage("nets.decom_net", cnn_in.device, batch=b):
        r, l = apply(model_params, cnn_in, compute_dtype=cfg.compute_dtype)
    l_boost = torch.clamp(l, cfg.illum_eps, 1.0) ** cfg.decom_gamma
    return torch.clamp(r * l_boost, 0.0, 1.0)


def enhance_learned_block(
    xb: torch.Tensor,
    cfg: PipelineConfig,
    model_params: Dict[str, Any],
    row0: int,
    h: int,
    w: int,
    halo: Optional[int] = None,
) -> torch.Tensor:
    """Learned-method enhance on one halo'd u8 row block.

    Args:
      xb: (B, 3, HB, WB) uint8, or float32 in [0, 1]; HB = owned rows + 2 *
        halo, WB a multiple of 128 with ``canvas_margin`` replicate cols
        before the image.
      row0: image-row index of block row 0.
      h, w: true image extent, for the zero mask beyond the margin.
      halo: rows per side; defaults to ``learned_halo(cfg)``.

    Returns (B, 3, HB - 2*halo, WB) of the block's dtype (f32 clipped to
    [0, 1]), columns uncropped.
    """
    if halo is None:
        halo = learned_halo(cfg)
    rows = xb.shape[-2] - 2 * halo
    if cfg.method in ("curve", "hybrid"):
        maps = block_curve_maps(xb, cfg, model_params, row0, h, w)
        return fused_curve_enhance(xb, maps, cfg, halo, rows, img_w=w,
                                   ds=kernel_maps_ds(cfg))
    y = block_net_image(xb, cfg, model_params, row0, h, w)
    if cfg.denoise_strength > 0.0:
        y = tiled_denoise(y, cfg, halo, rows)
    else:
        y = y[..., halo:halo + rows, :]
    return quantize_u8(y) if xb.dtype == torch.uint8 else y
