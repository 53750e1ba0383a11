"""Pipeline assembly: the public ``enhance`` API over the enhancement graph.

u8 HWC in, u8 HWC out. ``device`` is explicit: a pipeline on ``"cuda"``
runs the CUDA kernels (K1 for retinex; the curve CNN and K3 for
curve/hybrid, at every ``curve_downsample``; the fcn or decom net and K5
for their denoise tail; every method with the bilateral or the guided
tail and any blur radius; the nets' convs through ``F.conv2d``, or under
``conv_impl="pallas"`` through K6 and ``"cascade"`` through K7), one on
``"cpu"`` their plain versions. There is no fallback from one to the
other.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from low_light_image_enhancement_tpu_torch.blocks import (
    block_geometry,
    enhance_learned_block,
    resolve_conv_impl,
    single_block_halo,
)
from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import pad_edge, pad_planar
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    fused_retinex,
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

__all__ = ["pad_planar", "pad_block", "resolve_device", "params_on",
           "EnhancePipeline", "enhance", "enhance_batch"]


def check_ported(cfg: PipelineConfig) -> None:
    """Raise for configs whose path is not ported yet."""
    if cfg.spatial_shards > 1 or cfg.data_shards > 1:
        raise NotImplementedError(
            "spatial_shards/data_shards > 1 are not ported yet (ROADMAP "
            "Queue 1: parallel)")
    if cfg.method != "retinex":
        resolve_conv_impl(cfg)  # raises for the conv arms not ported


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


def pad_block(imgs_u8: torch.Tensor, cfg: PipelineConfig):
    """(B, H, W, 3) u8 -> the learned methods' planar u8 block
    (B, 3, HB, WB) and its halo: ``single_block_halo`` replicate rows above
    and below the rounded rows, ``canvas_margin`` replicate cols before the
    image, the width rounded to 128."""
    _, h, w, _ = imgs_u8.shape
    m = canvas_margin(cfg)
    halo = single_block_halo(cfg)
    h_core, wp = block_geometry(cfg, h, w)
    xb = pad_edge(imgs_u8.permute(0, 3, 1, 2), halo, halo + h_core - h,
                  m, wp - w - m)
    return xb.contiguous(), halo


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
        check_ported(config)
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
        """Run each (batch, height, width) once (bucket-rounded), so the
        kernel build and cuDNN's first-call set-up happen before traffic."""
        for b, h, w in shapes:
            h, w = self._bucketed(h, w)
            self.enhance_batch_device(
                torch.zeros((b, h, w, 3), dtype=torch.uint8,
                            device=self.device))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def enhance_batch_device(self, imgs_u8: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) u8 tensor on the pipeline's device -> enhanced u8
        tensor there (no host sync)."""
        if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 3:
            raise ValueError(
                f"expected RGB (B,H,W,3), got {tuple(imgs_u8.shape)}")
        if imgs_u8.dtype != torch.uint8:
            raise TypeError(f"expected uint8 input, got {imgs_u8.dtype}")
        if imgs_u8.device.type != self.device.type:
            raise ValueError(f"input on {imgs_u8.device}, pipeline on "
                             f"{self.device}")
        return _enhance_u8_batch(imgs_u8, self.model_params, cfg=self.config)

    def enhance_batch(self, imgs_u8) -> np.ndarray:
        """(B, H, W, 3) u8 -> (B, H, W, 3) u8 enhanced (host numpy)."""
        imgs_u8 = np.ascontiguousarray(imgs_u8)
        if imgs_u8.ndim != 4 or imgs_u8.shape[-1] != 3:
            raise ValueError(f"expected RGB (B,H,W,3), got {imgs_u8.shape}")
        _, h, w, _ = imgs_u8.shape
        hb, wb = self._bucketed(h, w)
        if (hb, wb) != (h, w):
            imgs_u8 = np.pad(imgs_u8, ((0, 0), (0, hb - h), (0, wb - w),
                                       (0, 0)), mode="edge")
        x = torch.from_numpy(imgs_u8).to(self.device)
        return self.enhance_batch_device(x).cpu().numpy()[:, :h, :w]

    def enhance(self, img_u8) -> np.ndarray:
        """(H, W, 3) u8 -> (H, W, 3) u8 enhanced."""
        img_u8 = np.asarray(img_u8)
        if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
            raise ValueError(f"expected RGB (H,W,3), got {img_u8.shape}")
        return self.enhance_batch(img_u8[None])[0]

    __call__ = enhance


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
