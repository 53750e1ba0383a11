"""Spatially sharded, temporally stable video (config 5 x config 4).

One high-resolution stream (say one 4K feed) whose frames are too large or
too latency-sensitive for one device: rows shard over the mesh's
``spatial`` axis as in ``parallel.sharding.enhance_spatial_sharded`` (u8
halos), and each shard keeps the EMA carry of its OWN rows. The carry
never moves between devices, so the only per-frame traffic is the halo
exchange the stateless sharded path pays too.

Each shard's halo is the full receptive field (``blocks.learned_halo``),
so every carry row the tail reads (the ``[halo - margin, halo + rows +
margin)`` band) is computed from exactly the rows the single-device canvas
holds: the same values, the same EMA trajectories, and per-shard outputs
equal to a single-device :class:`~..video.VideoEnhancer`'s up to u8
rounding ties of the nets' convs. Carry rows outside the band may drift
from their single-device values; they are never read.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from low_light_image_enhancement_tpu_torch.blocks import (
    block_geometry,
    learned_halo,
    resolve_conv_impl,
)
from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.parallel.sharding import (
    Mesh,
    _sharded_rows,
    replicas,
)
from low_light_image_enhancement_tpu_torch.video import (
    _VideoBase,
    _check_u8,
    video_step,
)

__all__ = ["SpatialShardedVideoEnhancer"]


class SpatialShardedVideoEnhancer(_VideoBase):
    """One video stream, rows sharded over the mesh's ``spatial`` axis::

        mesh = make_mesh(n_data=1, n_spatial=4)
        sve = SpatialShardedVideoEnhancer(mesh, PipelineConfig(), alpha=0.3)
        for frame in frames_4k:          # (H, W, 3) u8, fixed size
            out = sve.process(frame)
        sve.reset()                       # scene cut

    The ``data`` axis is unused: the shards run on the mesh's first row.
    Methods: retinex (K4, or K1's gain form with ``ema_in_kernel=False``),
    curve and hybrid (K3), as :class:`~..video.VideoEnhancer`. ``device``
    is the mesh's device type ("cuda" or "cpu").
    """

    def __init__(self, mesh: Mesh,
                 config: PipelineConfig = PipelineConfig(),
                 alpha: float = 0.3,
                 model_params: Optional[Dict[str, Any]] = None,
                 device="cuda",
                 ema_in_kernel: bool = True):
        if "spatial" not in getattr(mesh, "axis_names", ()):
            raise ValueError(
                f"mesh needs a 'spatial' axis, has "
                f"{getattr(mesh, 'axis_names', None)}")
        mesh.require_local("SpatialShardedVideoEnhancer")
        self.mesh = mesh
        self._init_common(config, alpha, model_params, device, ema_in_kernel)
        self._row = Mesh([mesh.devices[0]])   # the shards: the first row
        self._devices = self._row.devices[0]
        if any(d.type != self.device.type for d in self._devices):
            raise ValueError(f"mesh devices {self._devices} are not "
                             f"{self.device.type} devices")
        self._params = replicas(self.model_params, self._row)

    def reset(self) -> None:
        """Forget the carry of every shard: the next frame starts the EMA
        anew."""
        self._state = None

    @property
    def carry_bytes(self) -> int:
        """The carries of all shards in bytes, the per-shard halo overlap
        rows included (after a first frame)."""
        return self._carry_elements() * 4

    def _build(self, h: int, w: int) -> None:
        self._shape = (h, w)
        cfg = resolve_conv_impl(self.config)
        n_sp = len(self._devices)
        halo = learned_halo(cfg)
        hl, wp = block_geometry(cfg, h, w, n_shards=n_sp)
        rows = hl + 2 * halo
        ds = cfg.curve_downsample
        per_shard = ((cfg.curve_iters, 3, rows // ds, wp // ds)
                     if cfg.method == "curve" else (rows, wp))
        self._carry_shape = (n_sp,) + per_shard
        self._cfg, self._hl, self._wp, self._halo = cfg, hl, wp, halo

    @torch.no_grad()
    def process(self, frame_u8) -> np.ndarray:
        frame_u8 = np.asarray(frame_u8)
        if frame_u8.ndim != 3 or frame_u8.shape[-1] != 3:
            raise ValueError(
                f"expected an (H, W, 3) u8 frame, got {frame_u8.shape}")
        _check_u8(frame_u8)
        h, w, _ = frame_u8.shape
        if self._shape is None:
            self._build(h, w)
        elif (h, w) != self._shape:
            raise ValueError(
                f"frame size changed {self._shape} -> {(h, w)}; create a "
                "new SpatialShardedVideoEnhancer")
        cfg, hl, wp, halo = self._cfg, self._hl, self._wp, self._halo
        if self._state is None:
            self._state = [
                (torch.zeros((1,), dtype=torch.bool, device=dev),
                 torch.zeros((1,) + self._carry_shape[1:],
                             dtype=torch.float32, device=dev))
                for dev in self._devices]
        states = list(self._state)

        def run(xb, s, dev):
            states[s], y = video_step(states[s], xb, cfg, self.alpha,
                                      self._params[dev], h, w,
                                      row0=s * hl - halo,
                                      ema_in_kernel=self.ema_in_kernel)
            return y

        x = torch.from_numpy(np.ascontiguousarray(frame_u8)).to(
            self._row.home)
        out = _sharded_rows(x.permute(2, 0, 1)[None], self._row, hl, wp,
                            canvas_margin(cfg), halo, run)
        self._state = states
        return out[0].permute(1, 2, 0).contiguous().cpu().numpy()
