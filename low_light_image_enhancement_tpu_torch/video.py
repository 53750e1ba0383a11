"""Temporally stable video enhancement.

Per-frame enhancement flickers when the per-frame estimates jitter, so each
method smooths its natural temporal quantity with an exponential moving
average across frames (``alpha`` is the new frame's weight; 1.0 is the
stateless pipeline):

  * retinex / hybrid: the illumination plane. Each frame's reflectance stays
    its own while the gain follows the smoothed illumination:
    ``gain = exp(gamma * log l_mix - log l_now)``.
  * curve: the Zero-DCE curve maps, at the CNN's 1/ds resolution.
  * fcn / decom have no such carry; they raise.

``video_step`` runs one frame (or one frame of each of S streams) on a
halo'd u8 block with an explicit state ``(initialized flag, carry)``; the
enhancers wrap it with a state holder and the u8 HWC API. On a CUDA device
the default retinex step is one kernel, K4 ``fused_retinex_ema``
(illumination, EMA, gain, denoise, quantize and the new carry);
``ema_in_kernel=False`` computes the illumination, the EMA and the gain in
PyTorch ops and runs K1's gain form for the tail. hybrid computes the gain
the same way and runs the curve CNN and K3 with the gain plane; curve runs
the CNN and K3 on the smoothed maps. On the CPU every kernel is its plain
version. The port of the JAX package's ``video.py``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from low_light_image_enhancement_tpu_torch.blocks import (
    _curve_maps_lowres,
    _mask_extent,
    block_geometry,
    curve_maps_for_kernel,
    kernel_maps_ds,
    learned_halo,
    maps_at_kernel_ds,
    resolve_conv_impl,
)
from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import (
    pad_edge,
    replicate_margin_cols,
)
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    _to_float,
    fused_curve_enhance,
    fused_retinex_ema,
    fused_retinex_gain,
)
from low_light_image_enhancement_tpu_torch.ops.filters import (
    roll2d,
    separable_blur,
)
from low_light_image_enhancement_tpu_torch.pipeline import (
    EnhancePipeline,
    params_on,
    resolve_device,
)

__all__ = ["State", "ema_gain", "video_step", "pad_video_block",
           "VideoEnhancer", "MultiStreamVideoEnhancer"]

State = Tuple[torch.Tensor, torch.Tensor]  # (initialized flag, EMA carry)

_VIDEO_METHODS = ("retinex", "hybrid", "curve")


def _bcast_flag(flag: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The flag (one per stream) with singleton axes appended, so that it
    broadcasts against the carry."""
    return flag.reshape(tuple(flag.shape) + (1,) * (like.ndim - flag.ndim))


def ema_gain(xf: torch.Tensor, initialized: torch.Tensor,
             carry: torch.Tensor, cfg: PipelineConfig, alpha: float,
             w: int):
    """The smoothed gain plane and l_mix of the retinex/hybrid step on a
    float block (B, 3, HB, WB), in PyTorch ops: l_now = blur(max RGB) with
    wrap shifts, l_mix = alpha * l_now + (1 - alpha) * carry where the
    stream is initialized, gain = exp(gamma * log l_mix - log l_now) (both
    clipped to [eps, 1]) with the margin columns re-replicated."""
    l_now = separable_blur(torch.amax(xf, dim=-3), cfg.blur_radius,
                           cfg.blur_sigma, roll2d)
    l_mix = torch.where(_bcast_flag(initialized, l_now),
                        alpha * l_now + (1.0 - alpha) * carry, l_now)
    gain = torch.exp(
        cfg.gamma * torch.log(torch.clamp(l_mix, cfg.illum_eps, 1.0))
        - torch.log(torch.clamp(l_now, cfg.illum_eps, 1.0)))
    return replicate_margin_cols(gain, w, canvas_margin(cfg)), l_mix


def video_step(
    state: State,
    xb: torch.Tensor,
    cfg: PipelineConfig,
    alpha: float,
    model_params: Optional[Dict[str, Any]] = None,
    h: Optional[int] = None,
    w: Optional[int] = None,
    row0: Optional[int] = None,
    ema_in_kernel: bool = True,
) -> Tuple[State, torch.Tensor]:
    """One frame per stream on a halo'd u8 or f32 block (S, 3, HB, WB):
    HB = rows + 2 * ``learned_halo(cfg)``, ``canvas_margin`` replicate
    columns before the image. The state is a bool flag (S,) and the carry:
    (S, HB, WB) for retinex/hybrid, (S, n_iter, 3, HB/ds, WB/ds) for curve.
    Returns the new state and the rows (S, 3, rows, WB) of the block's
    dtype (f32 clipped to [0, 1]), columns uncropped.

    ``ema_in_kernel`` picks K4 for retinex; ``h``, ``w`` (the image's size)
    and ``row0`` (the image row of block row 0) default to a single block
    holding the whole image."""
    initialized, carry = state
    cfg = resolve_conv_impl(cfg)
    m = canvas_margin(cfg)
    halo = learned_halo(cfg)
    rows = xb.shape[-2] - 2 * halo
    h = rows if h is None else h
    w = xb.shape[-1] - 2 * m if w is None else w
    row0 = -halo if row0 is None else row0
    done = torch.ones_like(initialized)

    if cfg.method == "retinex" and ema_in_kernel:
        # the flag becomes the per-pixel negative sentinel K4 reads
        carry_eff = torch.where(_bcast_flag(initialized, carry), carry,
                                carry.new_full((), -1.0))
        out, new_carry = fused_retinex_ema(xb, carry_eff, cfg, halo, rows, w,
                                           alpha)
        return (done, new_carry), out
    xf = _to_float(xb)
    if cfg.method in ("retinex", "hybrid"):
        gain, l_mix = ema_gain(xf, initialized, carry, cfg, alpha, w)
        if cfg.method == "retinex":
            return (done, l_mix), fused_retinex_gain(xb, gain, cfg, halo,
                                                     rows)
        boosted = torch.clamp(xf * gain[:, None], 0.0, 1.0)
        maps = curve_maps_for_kernel(_mask_extent(boosted, row0, h, w, m),
                                     cfg, model_params)
        return (done, l_mix), fused_curve_enhance(
            xb, maps, cfg, halo, rows, w, ds=kernel_maps_ds(cfg), gain=gain)
    if cfg.method == "curve":
        maps_now = _curve_maps_lowres(_mask_extent(xf, row0, h, w, m), cfg,
                                      model_params)
        maps = torch.where(_bcast_flag(initialized, maps_now),
                           alpha * maps_now + (1.0 - alpha) * carry,
                           maps_now)
        return (done, maps), fused_curve_enhance(
            xb, maps_at_kernel_ds(maps, cfg), cfg, halo, rows, w,
            ds=kernel_maps_ds(cfg))
    raise ValueError(
        f"video path supports methods {_VIDEO_METHODS}; no temporal carry "
        f"exists for {cfg.method!r}")


def pad_video_block(frames_u8: torch.Tensor,
                    cfg: PipelineConfig) -> torch.Tensor:
    """(S, H, W, 3) u8 frames -> the video step's u8 block (S, 3, HB, WB):
    ``learned_halo(cfg)`` replicate rows above and below the rounded rows,
    ``canvas_margin(cfg)`` replicate columns before the image, the width
    rounded to 128."""
    _, h, w, _ = frames_u8.shape
    m = canvas_margin(cfg)
    halo = learned_halo(cfg)
    h_core, wp = block_geometry(cfg, h, w)
    return pad_edge(frames_u8.permute(0, 3, 1, 2), halo, halo + h_core - h,
                    m, wp - w - m).contiguous()


def _make_step(cfg: PipelineConfig, alpha: float, params, h: int, w: int,
               ema_in_kernel: bool):
    """The frame step for an (h, w) frame size and the per-stream carry
    shape. The step takes a state and a u8 frame (h, w, 3), or a batch
    (S, h, w, 3) with a state of one flag per stream, on the state's
    device, and returns the new state and the enhanced u8 frame(s)."""
    m = canvas_margin(cfg)
    halo = learned_halo(cfg)
    h_core, wp = block_geometry(cfg, h, w)

    @torch.no_grad()
    def step(state: State, u8: torch.Tensor):
        single = u8.ndim == 3
        if single:
            u8, state = u8[None], (state[0][None], state[1][None])
        state, yb = video_step(state, pad_video_block(u8, cfg), cfg, alpha,
                               params, h, w, ema_in_kernel=ema_in_kernel)
        out = yb[..., :h, m:m + w].permute(0, 2, 3, 1).contiguous()
        if single:
            return (state[0][0], state[1][0]), out[0]
        return state, out

    ds = cfg.curve_downsample
    carry_shape = (
        (cfg.curve_iters, 3, (h_core + 2 * halo) // ds, wp // ds)
        if cfg.method == "curve"
        else (h_core + 2 * halo, wp)
    )
    return step, carry_shape


class _VideoBase:
    """What the single- and multi-stream enhancers share: method and device
    checks, the default weights, the step built at the first frame."""

    def _init_common(self, config: PipelineConfig, alpha: float,
                     model_params: Optional[Dict[str, Any]], device,
                     ema_in_kernel: bool) -> None:
        if config.method not in _VIDEO_METHODS:
            raise ValueError(
                f"video path supports methods {_VIDEO_METHODS}, got "
                f"{config.method!r}: it has no temporal carry; enhance its "
                "frames with EnhancePipeline")
        self.device = resolve_device(device, type(self).__name__)
        self.config = config
        self.alpha = float(alpha)
        if model_params is None and config.method != "retinex":
            model_params = EnhancePipeline._default_params(config, 0)
        self.model_params = params_on(model_params, self.device)
        # True: the retinex step is K4; False: PyTorch ops and K1's gain form
        self.ema_in_kernel = bool(ema_in_kernel)
        self._state: Optional[State] = None
        self._step = None
        self._shape: Optional[Tuple[int, int]] = None

    def _build(self, h: int, w: int) -> None:
        self._shape = (h, w)
        self._step, self._carry_shape = _make_step(
            resolve_conv_impl(self.config), self.alpha, self.model_params,
            h, w, self.ema_in_kernel)

    def _prepare(self, frames: np.ndarray) -> torch.Tensor:
        """Build the step at the first frame size, refuse another size, and
        start the state; the frames as a tensor on the device."""
        h, w = frames.shape[-3:-1]
        if self._shape is None:
            self._build(h, w)
        elif (h, w) != self._shape:
            raise ValueError(
                f"frame size changed {self._shape} -> {(h, w)}; create a "
                f"new {type(self).__name__}")
        if self._state is None:
            lead = frames.shape[:-3]
            self._state = (
                torch.zeros(lead, dtype=torch.bool, device=self.device),
                torch.zeros(lead + self._carry_shape, dtype=torch.float32,
                            device=self.device))
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)

    def _carry_elements(self) -> int:
        if self._shape is None:
            raise RuntimeError("carry_bytes is defined after a first frame")
        return int(np.prod(self._carry_shape))


def _check_u8(frames: np.ndarray) -> None:
    if frames.dtype != np.uint8:
        raise TypeError(f"expected uint8 frames, got {frames.dtype}")


class VideoEnhancer(_VideoBase):
    """Stateful u8 HWC video interface::

        ve = VideoEnhancer(PipelineConfig(), alpha=0.3, device="cuda")
        for frame in frames:            # (H, W, 3) u8, fixed size
            out = ve.process(frame)
        ve.reset()                       # scene cut
    """

    def __init__(self, config: PipelineConfig = PipelineConfig(),
                 alpha: float = 0.3,
                 model_params: Optional[Dict[str, Any]] = None,
                 device="cuda",
                 ema_in_kernel: bool = True):
        self._init_common(config, alpha, model_params, device, ema_in_kernel)

    def reset(self) -> None:
        """Forget the carry: the next frame starts the EMA anew."""
        self._state = None

    @property
    def carry_bytes(self) -> int:
        """The EMA carry's size in bytes (after a first frame)."""
        return self._carry_elements() * 4

    def process(self, frame_u8) -> np.ndarray:
        frame_u8 = np.asarray(frame_u8)
        if frame_u8.ndim != 3 or frame_u8.shape[-1] != 3:
            raise ValueError(
                f"expected an (H, W, 3) u8 frame, got {frame_u8.shape}")
        _check_u8(frame_u8)
        x = self._prepare(frame_u8)
        self._state, out = self._step(self._state, x)
        return out.cpu().numpy()


class MultiStreamVideoEnhancer(_VideoBase):
    """S independent video streams enhanced in one batched step; the carry
    stays per stream, and stream i's output equals a lone
    :class:`VideoEnhancer`'s where the net's convolutions sum the same way
    at batch S and batch 1 (the plain versions on the CPU do)::

        mv = MultiStreamVideoEnhancer(8, PipelineConfig(method="curve"))
        for frames in batches:          # (8, H, W, 3) u8, one per stream
            outs = mv.process(frames)   # (8, H, W, 3)
        mv.reset(3)                      # scene cut in stream 3 only
    """

    def __init__(self, n_streams: int,
                 config: PipelineConfig = PipelineConfig(),
                 alpha: float = 0.3,
                 model_params: Optional[Dict[str, Any]] = None,
                 device="cuda",
                 ema_in_kernel: bool = True):
        if n_streams < 1:
            raise ValueError(f"n_streams must be >= 1, got {n_streams}")
        self.n_streams = int(n_streams)
        self._init_common(config, alpha, model_params, device, ema_in_kernel)

    def reset(self, stream: Optional[int] = None) -> None:
        """Re-seed the EMA of all streams, or of ``stream`` alone."""
        if stream is None:
            self._state = None
            return
        if not 0 <= stream < self.n_streams:
            raise ValueError(
                f"stream {stream} out of range [0, {self.n_streams})")
        if self._state is not None:
            flag, carry = self._state
            flag = flag.clone()
            flag[stream] = False
            self._state = (flag, carry)

    @property
    def carry_bytes(self) -> int:
        """The EMA carry of all streams in bytes (after a first frame)."""
        return self.n_streams * self._carry_elements() * 4

    def process(self, frames_u8) -> np.ndarray:
        frames_u8 = np.asarray(frames_u8)
        if (frames_u8.ndim != 4 or frames_u8.shape[0] != self.n_streams
                or frames_u8.shape[-1] != 3):
            raise ValueError(
                f"expected (n_streams={self.n_streams}, H, W, 3) u8 frames, "
                f"got {frames_u8.shape}")
        _check_u8(frames_u8)
        x = self._prepare(frames_u8)
        self._state, out = self._step(self._state, x)
        return out.cpu().numpy()
