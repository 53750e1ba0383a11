"""Pipeline assembly: the public ``enhance`` API over the enhancement graph.

u8 HWC in, u8 HWC out; the layout-persistent entry points take planar u8
(``enhance_batch_device_planar``) or the padded planar canvas
(``enhance_batch_device_canvas``, staged on the host by ``stage_canvas``),
``enhance_stream`` runs a stream of frames through a pinned prefetch queue
and ``enhance_file`` a file; ``enhance_raw``/``enhance_raw_batch`` take RGGB
Bayer mosaics through the ISP (``ops.isp``), then the same u8 path.
``device`` is explicit: a pipeline on ``"cuda"`` runs the CUDA kernels
(K1 for retinex; the curve CNN and K3 for curve/hybrid, at every
``curve_downsample``; the fcn or decom net and K5
for their denoise tail; every method with the bilateral or the guided
tail and any blur radius; the nets' convs through ``F.conv2d``, or under
``conv_impl="pallas"`` through K6 and ``"cascade"`` through K7), one on
``"cpu"`` their plain versions. There is no fallback from one to the
other. ``spatial_shards`` splits the rows over a mesh of devices
(``parallel.enhance_spatial_sharded``, BASELINE config 5) and
``data_shards`` the batch (``parallel.shard_batch_fn``); on CUDA each count
is clamped to the cards there are (a count clamped to one runs the
single-device path), on the CPU the mesh repeats the CPU device.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from low_light_image_enhancement_tpu_torch.blocks import (
    block_geometry,
    enhance_learned_block,
    single_block_halo,
)
from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import pad_edge, pad_planar
from low_light_image_enhancement_tpu_torch.io.codec import (
    decode_image,
    encode_image,
)
from low_light_image_enhancement_tpu_torch.io.prefetch import (
    PrefetchQueue,
    from_planar,
    to_planar,
)
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    fused_retinex,
    fused_retinex_canvas,
)
from low_light_image_enhancement_tpu_torch.kernels.striping import (
    CanvasPlan,
    plan_canvas,
)
from low_light_image_enhancement_tpu_torch.models.curve_cnn import (
    init_curve_cnn,
)
from low_light_image_enhancement_tpu_torch.models.decom import init_decom_net
from low_light_image_enhancement_tpu_torch.models.fcn import init_fcn
from low_light_image_enhancement_tpu_torch.models.weights import (
    load_pretrained,
    params_from_numpy,
    resolve_weights,
)
from low_light_image_enhancement_tpu_torch.ops.colorspace import quantize_u8
from low_light_image_enhancement_tpu_torch.ops.isp import (
    DEFAULT_CCM,
    color_correction,
    demosaic_bilinear_rggb,
    gray_world_gains,
    white_balance,
)
from low_light_image_enhancement_tpu_torch.utils.profiling import stage

__all__ = ["pad_planar", "pad_block", "pad_block_planar", "resolve_device",
           "params_on", "EnhancePipeline", "enhance", "enhance_batch"]


def resolve_device(device, who: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` as a ``torch.device``; a CUDA device that is
    not there raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{who}(device='cuda'): CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"device must be cuda or cpu: {device!r}")
    return device


def params_on(model_params: Optional[Dict[str, Any]], device):
    """The net's parameters moved to ``device`` (None stays None)."""
    if model_params is None:
        return None
    return {name: {k: t.to(device) for k, t in layer.items()}
            for name, layer in model_params.items()}


def pad_block_planar(x: torch.Tensor, cfg: PipelineConfig):
    """(B, 3, H, W) -> the learned methods' planar block (B, 3, HB, WB)
    and its halo: ``single_block_halo`` replicate rows above and below the
    rounded rows, ``canvas_margin`` replicate cols before the image, the
    width rounded to 128."""
    h, w = x.shape[-2:]
    m = canvas_margin(cfg)
    halo = single_block_halo(cfg)
    h_core, wp = block_geometry(cfg, h, w)
    xb = pad_edge(x, halo, halo + h_core - h, m, wp - w - m)
    return xb.contiguous(), halo


def pad_block(imgs_u8: torch.Tensor, cfg: PipelineConfig):
    """(B, H, W, 3) u8 -> ``pad_block_planar``'s block and halo."""
    return pad_block_planar(imgs_u8.permute(0, 3, 1, 2), cfg)


def _reflect_index(n: int, pad: int, device) -> torch.Tensor:
    """The source index of each position of a ``pad``-wide reflect pad of
    an axis of ``n`` (``np.pad(mode="reflect")``, any pad)."""
    i = torch.arange(-pad, n + pad, device=device)
    p = 2 * (n - 1)
    r = torch.remainder(i, p)
    return torch.where(r >= n, p - r, r)


def _isp_u8_hwc(raws: torch.Tensor, wb_gains, ccm, raw_gamma: float,
                valid_hw=None) -> torch.Tensor:
    """The ISP front end: (B, H, W) f32 RGGB mosaics -> (B, H, W, 3) u8
    sRGB, on the mosaics' device.

    Reflect-pads 2 px a side before the demosaic and crops after it: the
    roll-based interpolation wraps at the edges, and the reflection keeps
    the Bayer phase (-k mirrors +k, the same parity), so the borders come
    out exact. Gray-world gains (``wb_gains=None``) are taken on the cropped
    demosaic; with ``valid_hw=(h, w)`` only on the real image region of a
    bucket-padded mosaic (a masked sum over its pixel count)."""
    _, h, w = raws.shape
    dev = raws.device
    rp = raws.index_select(-2, _reflect_index(h, 2, dev)).index_select(
        -1, _reflect_index(w, 2, dev))
    rgb = demosaic_bilinear_rggb(rp)[..., 2:-2, 2:-2]
    if wb_gains is None:
        if valid_hw is None:
            gains = gray_world_gains(rgb)   # (B, 3): per-image auto-WB
        else:
            mask = ((torch.arange(h, device=dev)[:, None] < valid_hw[0])
                    & (torch.arange(w, device=dev)[None, :] < valid_hw[1])
                    ).to(rgb.dtype)
            cnt = float(max(valid_hw[0] * valid_hw[1], 1))
            means = torch.sum(rgb * mask, dim=(-2, -1)) / cnt
            gains = means[..., 1:2] / torch.clamp(means, min=1e-6)
        gains = gains.reshape(gains.shape[:-1] + (3, 1, 1))
        rgb = torch.clamp(rgb * gains, 0.0, 1.0)
    else:
        rgb = white_balance(rgb, wb_gains)
    rgb = color_correction(rgb, ccm)
    rgb = torch.clamp(rgb, 0.0, 1.0) ** raw_gamma
    return quantize_u8(rgb).permute(0, 2, 3, 1).contiguous()


def _enhance_u8_batch(
    imgs_u8: torch.Tensor,
    model_params: Optional[Dict[str, Any]],
    *,
    cfg: PipelineConfig,
) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (B, H, W, 3) u8 enhanced, on the input's device.

    retinex is one K1 call: it reads HWC, so the transpose, canvas pad,
    crop and transpose back fold into the kernel's clamped reads. The
    learned methods run the block graph on ``pad_block``'s block and
    crop."""
    if cfg.method == "retinex":
        return fused_retinex(imgs_u8, cfg)
    _, h, w, _ = imgs_u8.shape
    m = canvas_margin(cfg)
    xb, halo = pad_block(imgs_u8, cfg)
    yb = enhance_learned_block(xb, cfg, model_params, row0=-halo, h=h, w=w,
                               halo=halo)
    return yb[..., :h, m:m + w].permute(0, 2, 3, 1).contiguous()


def _enhance_u8_planar(
    x: torch.Tensor,
    model_params: Optional[Dict[str, Any]],
    *,
    cfg: PipelineConfig,
) -> torch.Tensor:
    """(B, 3, H, W) u8 -> (B, 3, H, W) u8 enhanced, on the input's device.

    retinex pads the canvas on the device (``pad_planar``), runs K1's
    canvas form and crops; the learned methods run the block graph on
    ``pad_block_planar``'s block and crop."""
    _, _, h, w = x.shape
    m = canvas_margin(cfg)
    if cfg.method == "retinex":
        plan = plan_canvas(h, w, m)
        canvas = pad_planar(x, plan, h, w).contiguous()
        y = fused_retinex_canvas(canvas, cfg, m, plan.padded_h - 2 * m)
    else:
        xb, halo = pad_block_planar(x, cfg)
        y = enhance_learned_block(xb, cfg, model_params, row0=-halo, h=h,
                                  w=w, halo=halo)
    return y[..., :h, m:m + w].contiguous()


class EnhancePipeline:
    """Low-light enhancement pipeline on one device.

    Example::

        pipe = EnhancePipeline(PipelineConfig(gamma=0.5), device="cuda")
        out = pipe.enhance(img_u8_hwc)
    """

    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        model_params: Optional[Dict[str, Any]] = None,
        rng_seed: int = 0,
        device="cuda",
        bucket: Optional[int] = None,
    ):
        """``model_params``: the method's net (curve CNN, fcn or decom) as
        this package's tensors (``models.weights.params_from_numpy``); when
        omitted, the shipped weights for the method, or a random init from
        ``rng_seed`` if they are missing or do not fit the config.

        ``device``: ``"cuda"`` or ``"cpu"``; a CUDA device that is not
        there raises.

        ``bucket``: optional size granularity. ``enhance_batch`` edge-pads
        inputs up to multiples of it and crops the output back."""
        self.device = resolve_device(device, "EnhancePipeline")
        self.config = config
        self.bucket = bucket
        if model_params is None:
            model_params = self._default_params(config, rng_seed)
        self.model_params = params_on(model_params, self.device)

    @staticmethod
    def _default_params(config: PipelineConfig, rng_seed: int):
        """Shipped weights when present and shape-compatible with the
        config, a random init otherwise; ``weights_name`` picks a shipped
        set by name. None for retinex."""
        if config.weights_name is not None:
            return params_from_numpy(resolve_weights(config.weights_name))
        if config.method == "retinex":
            return None
        pre = load_pretrained(config.method)
        gen = torch.Generator().manual_seed(rng_seed)
        if config.method == "fcn":
            return params_from_numpy(pre) if pre is not None \
                else init_fcn(gen)
        if config.method == "decom":
            return params_from_numpy(pre) if pre is not None \
                else init_decom_net(gen)
        if (
            pre is not None
            and pre["c1"]["w"].shape[-1] == config.curve_features
            and pre["c7"]["w"].shape[-1] == 3 * config.curve_iters
        ):
            return params_from_numpy(pre)
        return init_curve_cnn(
            gen,
            features=config.curve_features,
            n_iter=config.curve_iters,
        )

    def _bucketed(self, h: int, w: int):
        g = self.bucket
        return (-(-h // g) * g, -(-w // g) * g) if g else (h, w)

    def warmup(self, shapes) -> None:
        """Run each (batch, height, width) once (bucket-rounded) through
        the real dispatch (the sharded one under ``spatial_shards`` or
        ``data_shards``), so the kernel build and cuDNN's first-call set-up
        happen before traffic."""
        for b, h, w in shapes:
            h, w = self._bucketed(h, w)
            self.enhance_batch_device(
                torch.zeros((b, h, w, 3), dtype=torch.uint8,
                            device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _check_on_device(self, x: torch.Tensor) -> None:
        if x.dtype != torch.uint8:
            raise TypeError(f"expected uint8 input, got {x.dtype}")
        if x.device.type != self.device.type:
            raise ValueError(f"input on {x.device}, pipeline on "
                             f"{self.device}")

    @torch.inference_mode()
    def enhance_batch_device(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) u8 tensor on the pipeline's device -> enhanced u8
        tensor there (no host sync)."""
        if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 3:
            raise ValueError(
                f"expected RGB (B,H,W,3), got {tuple(imgs_u8.shape)}")
        self._check_on_device(imgs_u8)
        cfg = self.config
        b, h, w, _ = imgs_u8.shape
        with stage("pipeline.enhance_batch_device", batch=b, h=h, w=w):
            if cfg.spatial_shards > 1:
                mesh = self._mesh(1, cfg.spatial_shards)
                if mesh.shape["spatial"] > 1:
                    from low_light_image_enhancement_tpu_torch.parallel \
                        .sharding import enhance_spatial_sharded

                    y = enhance_spatial_sharded(imgs_u8.permute(0, 3, 1, 2),
                                                cfg, mesh, self.model_params)
                    return y.permute(0, 2, 3, 1).contiguous()
            if cfg.data_shards > 1:
                return self._data_sharded(_enhance_u8_batch, imgs_u8)
            return _enhance_u8_batch(imgs_u8, self.model_params, cfg=cfg)

    def _mesh(self, n_data: int, n_spatial: int):
        """The mesh of the sharded configs: ``n_data x n_spatial`` devices
        of the pipeline's type, each count clamped to the cards there are
        (``parallel.sharding.mesh_for``)."""
        from low_light_image_enhancement_tpu_torch.parallel.sharding import (
            mesh_for,
        )

        return mesh_for(self.device, n_data, n_spatial)

    def _data_sharded(self, fn, imgs: torch.Tensor) -> torch.Tensor:
        """``fn(chunk, params, cfg=...)`` on the batch split over the
        ``data_shards`` mesh; the batch must divide by the mesh's size
        (``enhance_batch`` pads it for you). A mesh clamped to one device
        runs ``fn`` on the whole batch."""
        from low_light_image_enhancement_tpu_torch.parallel.sharding import (
            shard_batch_fn,
        )

        mesh = self._mesh(self.config.data_shards, 1)
        n = mesh.shape["data"]
        if imgs.shape[0] % n:
            raise ValueError(
                f"batch {imgs.shape[0]} not divisible by data_shards={n}; "
                "enhance_batch pads the batch for you")
        cfg = self.config
        if n == 1:
            return fn(imgs, self.model_params, cfg=cfg)
        return shard_batch_fn(lambda x, p: fn(x, p, cfg=cfg), mesh)(
            imgs, self.model_params)

    @torch.inference_mode()
    def enhance_batch_device_planar(self, imgs_pu8: torch.Tensor
                                    ) -> torch.Tensor:
        """(B, 3, H, W) PLANAR u8 tensor on the pipeline's device ->
        enhanced planar u8 tensor there: no HWC transpose runs on the
        device (the host stages planar in the prefetch workers,
        ``io.prefetch.to_planar``). Equal to ``enhance_batch_device``."""
        if imgs_pu8.ndim != 4 or imgs_pu8.shape[1] != 3:
            raise ValueError(f"expected planar RGB (B,3,H,W), got "
                             f"{tuple(imgs_pu8.shape)}")
        self._check_on_device(imgs_pu8)
        if self.config.spatial_shards > 1:
            raise NotImplementedError(
                "planar I/O is a single-device/DP fast path; the spatially "
                "sharded route is already planar inside: use "
                "parallel.enhance_spatial_sharded directly")
        if self.config.data_shards > 1:
            return self._data_sharded(_enhance_u8_planar, imgs_pu8)
        return _enhance_u8_planar(imgs_pu8, self.model_params,
                                  cfg=self.config)

    def _pad_batch(self, arr: np.ndarray) -> np.ndarray:
        """Under ``data_shards``, the host batch with its last item
        replicated up to a multiple of the mesh's size."""
        b = arr.shape[0]
        if self.config.data_shards > 1:
            n = self._mesh(self.config.data_shards, 1).shape["data"]
            if b % n:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], n - b % n, axis=0)])
        return arr

    def enhance_batch(self, imgs_u8) -> np.ndarray:
        """(B, H, W, 3) u8 -> (B, H, W, 3) u8 enhanced (host numpy)."""
        imgs_u8 = np.ascontiguousarray(imgs_u8)
        if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 3:
            raise ValueError(f"expected RGB (B,H,W,3), got {imgs_u8.shape}")
        b, h, w, _ = imgs_u8.shape
        imgs_u8 = self._pad_batch(imgs_u8)
        hb, wb = self._bucketed(h, w)
        if (hb, wb) != (h, w):
            imgs_u8 = np.pad(imgs_u8, ((0, 0), (0, hb - h), (0, wb - w),
                                       (0, 0)), mode="edge")
        x = torch.from_numpy(imgs_u8).to(self.device)
        return self.enhance_batch_device(x).cpu().numpy()[:b, :h, :w]

    def enhance(self, img_u8) -> np.ndarray:
        """(H, W, 3) u8 -> (H, W, 3) u8 enhanced."""
        img_u8 = np.asarray(img_u8)
        if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
            raise ValueError(f"expected RGB (H,W,3), got {img_u8.shape}")
        return self.enhance_batch(img_u8[None])[0]

    __call__ = enhance

    def enhance_file(self, in_path, out_path) -> None:
        """Decode an image file, enhance it, encode the result (the format
        from ``out_path``'s extension; ``io.codec``)."""
        encode_image(self.enhance(decode_image(in_path)), out_path)

    # ------------------------------------------------------------------ #
    # RAW (Bayer) ingest: the ISP, then the standard u8 path
    # ------------------------------------------------------------------ #

    @torch.inference_mode()
    def enhance_raw_batch_device(self, raws: torch.Tensor, wb_gains=None,
                                 ccm=None, raw_gamma: float = 1.0 / 2.2,
                                 valid_hw=None) -> torch.Tensor:
        """(B, H, W) float32 RGGB mosaics in [0, 1] on the pipeline's
        device -> (B, H, W, 3) u8 enhanced there (no host sync): the ISP
        (``_isp_u8_hwc``), then ``enhance_batch_device`` on its u8 output,
        so the sharded configs take their own dispatch. The arguments are
        ``enhance_raw_batch``'s after its host-side checks; ``valid_hw``
        restricts the gray-world statistics to a bucket-padded mosaic's
        real region."""
        if raws.ndim != 3 or raws.dtype != torch.float32:
            raise ValueError(f"expected (B, H, W) float32 mosaics, got "
                             f"{tuple(raws.shape)} {raws.dtype}")
        if raws.device.type != self.device.type:
            raise ValueError(f"input on {raws.device}, pipeline on "
                             f"{self.device}")
        srgb = _isp_u8_hwc(raws, wb_gains, DEFAULT_CCM if ccm is None
                           else ccm, float(raw_gamma), valid_hw)
        return self.enhance_batch_device(srgb)

    def enhance_raw_batch(self, raws, wb_gains=None, ccm=None,
                          raw_gamma: float = 1.0 / 2.2,
                          white_level: Optional[float] = None) -> np.ndarray:
        """(B, H, W) RGGB Bayer mosaics -> (B, H, W, 3) u8 enhanced (host
        numpy): the ISP front end (bilinear demosaic, white balance, CCM,
        display gamma; ``ops.isp``) on the device, then the standard
        enhance of its u8 output.

        Args:
          raws: uint16 (divided by ``white_level``, default 65535, and
            clipped at it), uint8 (/255), or float (clipped to [0, 1]).
            Other integer dtypes raise: int16/int32 RAW containers must be
            converted first (the CLI's ``_load_raw_mosaic`` does so for
            data in the 16-bit range), since clipping integer DNs to [0, 1]
            would give an all-white result. H and W must be even (RGGB).
          wb_gains: (3,) per-channel gains; None: per-image gray-world gains
            on the device, over the real image region only.
          ccm: 3x3 colour-correction matrix; None: ``ops.isp.DEFAULT_CCM``.
          raw_gamma: the display gamma after the CCM (1.0 turns it off).
          white_level: the uint16 full-scale value (4095 for a 12-bit
            sensor stored in u16); for uint16 input only, raises otherwise.

        ``bucket`` (the constructor's) applies here too: mosaics are
        reflect-padded (even offsets, which keep the Bayer phase) up to
        multiples of it, rounded up to even, and the output cropped back.
        """
        raws = np.asarray(raws)
        if raws.ndim != 3:
            raise ValueError(f"expected (B, H, W) Bayer mosaics, "
                             f"got {raws.shape}")
        b, h, w = raws.shape
        if h % 2 or w % 2:
            raise ValueError(f"RGGB mosaic needs even H and W, got {h}x{w}")
        if white_level is not None and raws.dtype != np.uint16:
            raise ValueError(
                f"white_level applies to uint16 mosaics; got {raws.dtype} "
                "(uint8 is always /255, float is taken as already in [0, 1])")
        if raws.dtype == np.uint16:
            scale = float(white_level) if white_level else 65535.0
            # clipped at the white level: a 12-bit sensor's occasional DN
            # above it saturates instead of skewing the gray-world means
            raws = np.clip(raws.astype(np.float32) / scale, 0.0, 1.0)
        elif raws.dtype == np.uint8:
            raws = raws.astype(np.float32) / 255.0
        elif np.issubdtype(raws.dtype, np.floating):
            raws = np.clip(raws.astype(np.float32), 0.0, 1.0)
        else:
            raise ValueError(
                f"unsupported mosaic dtype {raws.dtype}: use uint16 (with "
                "white_level for sub-16-bit sensors), uint8, or float in "
                "[0, 1]; integer RAW containers (int16/int32) must be "
                "converted explicitly so DNs aren't clipped to [0, 1]")
        valid_hw = None
        if self.bucket:
            g = self.bucket + self.bucket % 2   # even: keeps the RGGB phase
            hb, wb = -(-h // g) * g, -(-w // g) * g
            if (hb, wb) != (h, w):
                raws = np.pad(raws, ((0, 0), (0, hb - h), (0, wb - w)),
                              mode="reflect")
                valid_hw = (h, w)
        x = torch.from_numpy(np.ascontiguousarray(self._pad_batch(raws)))
        out = self.enhance_raw_batch_device(
            x.to(self.device), wb_gains=wb_gains, ccm=ccm,
            raw_gamma=raw_gamma, valid_hw=valid_hw)
        return out.cpu().numpy()[:b, :h, :w]

    def enhance_raw(self, raw, **kwargs) -> np.ndarray:
        """(H, W) RGGB Bayer mosaic -> (H, W, 3) u8 enhanced RGB; the
        dtypes and keywords of ``enhance_raw_batch``."""
        raw = np.asarray(raw)
        if raw.ndim != 2:
            raise ValueError(f"expected (H, W) Bayer mosaic, got {raw.shape}")
        return self.enhance_raw_batch(raw[None], **kwargs)[0]

    # ------------------------------------------------------------------ #
    # Canvas I/O: the device step is K1's canvas form alone
    # ------------------------------------------------------------------ #

    def canvas_plan(self, h: int, w: int) -> CanvasPlan:
        """The padded canvas that :meth:`enhance_batch_device_canvas` takes
        for images of (h, w): ``margin`` replicate rows and columns before
        the image, rows rounded to 8 and the width to 128."""
        return plan_canvas(h, w, canvas_margin(self.config))

    def stage_canvas(self, imgs_u8, plan: Optional[CanvasPlan] = None
                     ) -> np.ndarray:
        """Host-side staging for the canvas path: (B, H, W, 3) or (H, W, 3)
        u8 HWC -> (B, 3, Hp, Wp) planar edge-padded canvas (numpy). Run it
        in a prefetch worker, so that it overlaps the device's work."""
        imgs_u8 = np.asarray(imgs_u8)
        if imgs_u8.ndim == 3:
            imgs_u8 = imgs_u8[None]
        _, h, w, _ = imgs_u8.shape
        if plan is None:
            plan = self.canvas_plan(h, w)
        m = plan.margin
        return np.pad(np.moveaxis(imgs_u8, -1, 1),
                      ((0, 0), (0, 0), (m, plan.padded_h - h - m),
                       (m, plan.padded_w - w - m)), mode="edge")

    def crop_canvas(self, canvas_out, h: int, w: int,
                    plan: Optional[CanvasPlan] = None) -> np.ndarray:
        """Host-side inverse of :meth:`stage_canvas` for the output canvas:
        (B, 3, rows, Wp) -> (B, H, W, 3) u8 numpy (row 0 of the output is
        image row 0; columns keep the margin offset)."""
        if plan is None:
            plan = self.canvas_plan(h, w)
        if isinstance(canvas_out, torch.Tensor):
            canvas_out = canvas_out.cpu().numpy()
        m = plan.margin
        return from_planar(np.asarray(canvas_out)[..., :h, m:m + w])

    @torch.inference_mode()
    def enhance_batch_device_canvas(self, canvas_u8: torch.Tensor, h: int,
                                    w: int) -> torch.Tensor:
        """(B, 3, Hp, Wp) u8 staged canvas (``stage_canvas``) on the
        pipeline's device -> (B, 3, Hp - 2 margin, Wp) u8 enhanced canvas
        there (``crop_canvas`` recovers HWC); (h, w) is the images' size.
        The device step is K1's canvas form alone: no transpose, pad or
        crop runs on the device. retinex only."""
        if self.config.method != "retinex":
            raise NotImplementedError(
                "canvas I/O is the fused retinex path (method="
                f"{self.config.method!r}); use enhance_batch_device for the "
                "general path")
        if canvas_u8.ndim != 4 or canvas_u8.shape[1] != 3 or \
                canvas_u8.dtype != torch.uint8:
            raise ValueError(f"expected a (B, 3, Hp, Wp) u8 canvas, got "
                             f"{tuple(canvas_u8.shape)} {canvas_u8.dtype}")
        self._check_on_device(canvas_u8)
        plan = self.canvas_plan(h, w)
        if tuple(canvas_u8.shape[-2:]) != (plan.padded_h, plan.padded_w):
            raise ValueError(
                f"canvas {canvas_u8.shape[-2]}x{canvas_u8.shape[-1]} does "
                f"not match the canvas plan for ({h}, {w}) "
                f"({plan.padded_h}x{plan.padded_w}); stage with "
                "stage_canvas/canvas_plan")
        m = plan.margin
        return fused_retinex_canvas(canvas_u8, self.config, m,
                                    plan.padded_h - 2 * m)

    def enhance_stream(self, frames, depth: int = 2, staging: str = "hwc",
                       workers: int = 1):
        """Streaming enhancement: iterate u8 HWC frames (or (B, H, W, 3)
        batches) and yield the enhanced ones as numpy, in order. The host's
        staging and the host -> device copy run ahead of the device's work
        in a :class:`~io.prefetch.PrefetchQueue` (pinned buffers on CUDA);
        one batch stays in flight, its device -> host copy issued into a
        pinned buffer on a stream of its own, so that fetching batch N
        overlaps the compute of batch N + 1.

        ``staging`` says where the layout work runs: ``"hwc"`` sends the
        frames as they are (``enhance_batch_device``); ``"planar"`` has the
        workers transpose them (``enhance_batch_device_planar``);
        ``"canvas"`` has the workers stage the whole padded canvas, so that
        the device step is K1's canvas form alone, and crops on the host
        (retinex only). The output is the same in every mode. ``workers``
        sizes the staging pool."""
        if staging not in ("hwc", "planar", "canvas"):
            raise ValueError(f"staging must be hwc|planar|canvas: "
                             f"{staging!r}")
        plans: Dict[Any, CanvasPlan] = {}
        # (h, w, was_single) per staged item, in the order the source is
        # pulled (one coordinator pulls it, even with a worker pool)
        metas: "collections.deque" = collections.deque()

        def tag(it):
            for f in it:
                a = np.asarray(f)
                single = a.ndim == 3
                if single:
                    a = a[None]
                metas.append((a.shape[1], a.shape[2], single))
                yield a

        def stage(a):
            if staging == "planar":
                return to_planar(a)
            shp = a.shape[1:3]
            if shp not in plans:
                plans[shp] = self.canvas_plan(*shp)
            return self.stage_canvas(a, plans[shp])

        cuda = self.device.type == "cuda"
        if cuda:
            d2h = torch.cuda.Stream(self.device)
            ring = [None, None]   # pinned output buffers, used in turn
        turn = [0]

        def fetch(out):
            """Start the device -> host copy of a batch: (host tensor, the
            copy's event or None)."""
            if not cuda:
                return out, None
            k = turn[0]
            turn[0] = 1 - k
            buf = ring[k]
            if buf is None or buf.shape != out.shape:
                buf = ring[k] = torch.empty(out.shape, dtype=out.dtype,
                                            pin_memory=True)
            d2h.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(d2h):
                buf.copy_(out, non_blocking=True)
                event = torch.cuda.Event()
                event.record(d2h)
            out.record_stream(d2h)
            return buf, event

        def finish(host, event, h, w, single):
            if event is not None:
                event.synchronize()
            res = host.numpy()
            if staging == "canvas":
                res = self.crop_canvas(res, h, w)
            elif staging == "planar":
                res = from_planar(res)
            elif cuda:
                res = res.copy()   # the pinned buffer is filled again
            return res[0] if single else res

        pending = []
        # hwc has no host staging: no worker pool between the source and
        # the copies
        with PrefetchQueue(tag(frames), depth=depth, device=self.device,
                           transform=None if staging == "hwc" else stage,
                           workers=workers) as q:
            for item in q:
                h, w, single = metas.popleft()
                if staging == "canvas":
                    out = self.enhance_batch_device_canvas(item, h, w)
                elif staging == "planar":
                    out = self.enhance_batch_device_planar(item)
                else:
                    out = self.enhance_batch_device(item)
                pending.append((*fetch(out), h, w, single))
                if len(pending) > 1:
                    yield finish(*pending.pop(0))
        for args in pending:
            yield finish(*args)


# ---------------------------------------------------------------------- #
# Module-level convenience API: the default config on CUDA.
# ---------------------------------------------------------------------- #

_default_pipeline: Optional[EnhancePipeline] = None
_default_lock = threading.Lock()


def _default() -> EnhancePipeline:
    global _default_pipeline
    with _default_lock:
        if _default_pipeline is None:
            _default_pipeline = EnhancePipeline(device="cuda")
        return _default_pipeline


def enhance(img_u8) -> np.ndarray:
    """Enhance one u8 HWC RGB image with the default config on CUDA."""
    return _default().enhance(img_u8)


def enhance_batch(imgs_u8) -> np.ndarray:
    """Enhance a u8 BHWC RGB batch with the default config on CUDA."""
    return _default().enhance_batch(imgs_u8)
