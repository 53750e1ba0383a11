"""Training of the learned models: the curve CNN (zero-reference, the
config-3 workload: 512x512, batch 64; or paired, also on hybrid's
boosted inputs), the FCN (supervised) and the decomposition net.

The port of the JAX package's ``train.py``: the same losses, config,
AdamW step, microbatching, remat, EMA, early stopping, checkpoints and data
streams, in eager PyTorch on ``device`` ("cuda" unless the caller asks for
"cpu"). The convs run in cuDNN through ``models.layers.conv2d``; the curves,
the boost and the denoise tail are differentiable torch ops, as they are
jnp under ``jax.grad`` there (no Pallas kernel runs in training). A
step made with a mesh (``parallel.make_mesh``) is data parallel, its
gradients all-reduced over a process group when one is up
(``parallel.distributed``); with ``spatial_batch`` the crop's rows shard.

Zero-DCE-family losses, no ground truth needed:
  * exposure control: local mean luminance pulled toward a target level
  * colour constancy: channel means kept close (grey-world prior)
  * spatial consistency: local gradients of the output match the input's
  * illumination smoothness: TV penalty on the curve maps

Gradient ties: where the JAX package's ``jnp.clip`` or ``jnp.abs`` lies on
a gradient path, the port takes :func:`_clip` and :func:`_abs`, which
break ties as JAX does (half the gradient to each side of a clip bound, +1
for ``|0|``). ``torch.clamp`` (1 at a bound) and ``torch.abs`` (0 at 0) do
not, and ties are common here: the synthetic lows hold exact zeros, the
curves saturate at 0 and 1, decom's sigmoid illumination reaches 1.0.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.models.curve_cnn import (
    apply_curve_cnn,
    init_curve_cnn,
)
from low_light_image_enhancement_tpu_torch.ops.curves import apply_curves
from low_light_image_enhancement_tpu_torch.parallel.sharding import replicas
from low_light_image_enhancement_tpu_torch.pipeline import resolve_device

Params = Dict[str, Dict[str, torch.Tensor]]


# ------------------------------------------------------------ tie forms #

def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``: its gradient at a bound is 0.5, as
    ``torch.maximum``/``torch.minimum`` give it (``torch.clamp`` gives 1)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs``: its gradient at 0 is 1 (``torch.abs``'s is 0)."""
    return torch.where(x >= 0, x, -x)


# --------------------------------------------------------------- losses #

def _avg_pool_plane(x: torch.Tensor, k: int) -> torch.Tensor:
    """Non-overlapping k x k mean pool over the last two axes; rows and
    columns past the last whole window are dropped ("VALID")."""
    hh, ww = x.shape[-2] // k, x.shape[-1] // k
    x = x[..., :hh * k, :ww * k]
    x = x.reshape(*x.shape[:-2], hh, k, ww, k)
    return x.sum(dim=(-3, -1)) / float(k * k)


def exposure_loss(y: torch.Tensor, level: float = 0.6, patch: int = 16):
    """Mean squared distance of 16x16 local luminance from the target."""
    pooled = _avg_pool_plane(torch.mean(y, dim=-3), patch)
    return torch.mean((pooled - level) ** 2)


def color_constancy_loss(y: torch.Tensor):
    mean_rgb = torch.mean(y, dim=(-2, -1))  # (..., 3)
    r, g, b = mean_rgb[..., 0], mean_rgb[..., 1], mean_rgb[..., 2]
    return torch.mean((r - g) ** 2 + (r - b) ** 2 + (g - b) ** 2)


def spatial_consistency_loss(x: torch.Tensor, y: torch.Tensor,
                             patch: int = 4):
    """Pooled-gradient agreement between input and output."""
    gx = _avg_pool_plane(torch.mean(x, dim=-3), patch)
    gy = _avg_pool_plane(torch.mean(y, dim=-3), patch)

    def grads(g):
        return g[..., 1:, :] - g[..., :-1, :], g[..., :, 1:] - g[..., :, :-1]

    xh, xw = grads(gx)
    yh, yw = grads(gy)
    return torch.mean((_abs(yh) - _abs(xh)) ** 2) + torch.mean(
        (_abs(yw) - _abs(xw)) ** 2)


def smoothness_loss(a: torch.Tensor):
    """Total variation of the curve maps (..., n_iter, 3, H, W)."""
    dh = a[..., 1:, :] - a[..., :-1, :]
    dw = a[..., :, 1:] - a[..., :, :-1]
    return torch.mean(dh * dh) + torch.mean(dw * dw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``: the same fields and defaults
    (its comments there give each recipe's provenance)."""

    features: int = 32
    n_iter: int = 8
    batch_size: int = 64
    crop: int = 512
    learning_rate: float = 1e-4
    weight_decay: float = 1e-4
    # the zero-reference recipe's early-stop point; the paired, fcn and
    # decom objectives pass --steps
    steps: int = 600
    # zero-reference loss weights: the swept recipe of record
    w_exposure: float = 10.0
    w_color: float = 5.0
    w_spatial: float = 1.0
    w_smooth: float = 1600.0
    # TV weight of the paired curve objective (the GT gives the structure)
    w_smooth_paired: float = 20.0
    exposure_level: float = 0.32
    log_every: int = 50
    checkpoint_every: int = 500
    # the nets' conv compute dtype (f32 accumulation either way)
    compute_dtype: str = "bfloat16"
    # recompute the net's forward in the backward pass
    # (torch.utils.checkpoint), storing no conv activations
    remat: bool = True
    # gradient accumulation over equal chunks of this many images, one
    # optimizer update a batch: the full-batch step at a fraction of the
    # peak activation memory (None = off)
    microbatch: Optional[int] = None
    # EMA of the weights (decay a step); the loop checkpoints and returns
    # the EMA weights (None = off)
    ema_decay: Optional[float] = None
    # score the image after the pipeline's denoise tail in the loss
    denoise_in_loss: bool = False
    # which tail: "bilateral" (the shipping default) or "guided" (the
    # quality tail at loss_tail_guided_radius)
    loss_tail_taps: str = "bilateral"
    loss_tail_guided_radius: int = 4
    # decom: weight of an L1 + SSIM term on the relit image
    # R_low * L_low**relit_gamma against the bright GT (0 = off)
    w_relit: float = 0.0
    relit_gamma: float = 0.08  # PipelineConfig.decom_gamma's default
    # early stopping on a held-out metric every eval_every steps, stopping
    # after eval_patience evals that do not improve (0 = off)
    eval_every: int = 0
    eval_patience: int = 3


def _with_remat(net: Callable, tcfg: TrainConfig) -> Callable:
    """``net(params, x)``, its forward recomputed in the backward pass when
    ``tcfg.remat`` (``jax.checkpoint`` in the JAX package)."""
    if not tcfg.remat:
        return net
    return lambda p, x: checkpoint(net, p, x, use_reentrant=False,
                                   preserve_rng_state=False)


def _curve_net(tcfg: TrainConfig) -> Callable:
    return _with_remat(
        lambda p, x: apply_curve_cnn(p, x, n_iter=tcfg.n_iter,
                                     compute_dtype=tcfg.compute_dtype),
        tcfg)


def zero_reference_loss(
    params: Params, batch: torch.Tensor, tcfg: TrainConfig,
    net: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """batch: (B, 3, H, W) f32 low-light input in [0, 1]. ``net(params,
    x)`` gives the curve maps (default: the curve CNN; the row-sharded
    step passes its sharded form)."""
    a = (net or _curve_net(tcfg))(params, batch)
    y = _clip(apply_curves(batch, a), 0.0, 1.0)
    if tcfg.denoise_in_loss:
        y = _denoise_tail(y, tcfg)
    l_exp = exposure_loss(y, tcfg.exposure_level)
    l_col = color_constancy_loss(y)
    l_spa = spatial_consistency_loss(batch, y)
    l_tv = smoothness_loss(a)
    total = (tcfg.w_exposure * l_exp + tcfg.w_color * l_col
             + tcfg.w_spatial * l_spa + tcfg.w_smooth * l_tv)
    return total, {"loss": total, "exposure": l_exp, "color": l_col,
                   "spatial": l_spa, "smooth": l_tv}


def _denoise_tail(y: torch.Tensor,
                  tcfg: Optional[TrainConfig] = None) -> torch.Tensor:
    """The pipeline's shipping denoise tail inside a training loss, so the
    net optimizes the image the user receives: ``tcfg.loss_tail_taps``
    "bilateral" (the default ``PipelineConfig``'s) or "guided" (at
    ``loss_tail_guided_radius``), edge-replicate shifts on the crop."""
    from low_light_image_enhancement_tpu_torch.ops.denoise import (
        denoise_planar,
    )
    from low_light_image_enhancement_tpu_torch.ops.filters import shift2d

    if tcfg is not None and tcfg.loss_tail_taps == "guided":
        pcfg = PipelineConfig(denoise_taps="guided",
                              guided_radius=tcfg.loss_tail_guided_radius)
    elif tcfg is None or tcfg.loss_tail_taps == "bilateral":
        pcfg = PipelineConfig()
    else:
        raise ValueError(f"loss_tail_taps must be 'bilateral' or 'guided': "
                         f"{tcfg.loss_tail_taps!r}")
    inv2s2 = 1.0 / (2.0 * pcfg.denoise_sigma * pcfg.denoise_sigma)
    return _clip(
        denoise_planar(y, inv2s2, pcfg.denoise_strength, shift2d,
                       pcfg.denoise_kernel, pcfg.denoise_guide,
                       pcfg.denoise_taps, pcfg.guided_radius,
                       pcfg.guided_eps),
        0.0, 1.0)


def paired_curve_loss(
    params: Params, low: torch.Tensor, high: torch.Tensor,
    tcfg: TrainConfig, w_ssim: float = 0.5,
    net: Optional[Callable] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 + (1 - SSIM) of the curve-enhanced output against the paired
    ground truth, plus a weak TV prior on the maps (``w_smooth_paired``):
    the recipe of the shipped curve and hybrid weights. ``net`` as in
    :func:`zero_reference_loss`."""
    from low_light_image_enhancement_tpu_torch.eval.metrics import ssim

    a = (net or _curve_net(tcfg))(params, low)
    y = _clip(apply_curves(low, a), 0.0, 1.0)
    if tcfg.denoise_in_loss:
        y = _denoise_tail(y, tcfg)
    l1 = torch.mean(_abs(y - high))
    s = torch.mean(ssim(y, high))
    l_tv = smoothness_loss(a)
    total = l1 + w_ssim * (1.0 - s) + tcfg.w_smooth_paired * l_tv
    return total, {"loss": total, "l1": l1, "ssim": s, "smooth": l_tv}


def paired_loss(
    params: Params, low: torch.Tensor, high: torch.Tensor,
    tcfg: TrainConfig, w_ssim: float = 0.5,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 + (1 - SSIM) supervised loss of the FCN on (low, high) pairs."""
    from low_light_image_enhancement_tpu_torch.eval.metrics import ssim
    from low_light_image_enhancement_tpu_torch.models.fcn import apply_fcn

    net = _with_remat(
        lambda p, x: apply_fcn(p, x, compute_dtype=tcfg.compute_dtype), tcfg)
    y = net(params, low)
    if tcfg.denoise_in_loss:
        y = _denoise_tail(_clip(y, 0.0, 1.0), tcfg)
    l1 = torch.mean(_abs(y - high))
    s = torch.mean(ssim(y, high))
    total = l1 + w_ssim * (1.0 - s)
    return total, {"loss": total, "l1": l1, "ssim": s}


def decom_loss(
    params: Params, low: torch.Tensor, high: torch.Tensor,
    tcfg: TrainConfig, w_equal_r: float = 0.01, w_smooth: float = 0.1,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """RetinexNet-style decomposition objective on (low, high) pairs: both
    images reconstruct as R * L, share one reflectance and carry
    structure-aware smooth illumination; with ``w_relit`` > 0 also the
    relit image the decom pipeline ships against the GT. The net runs in
    float32, as the JAX package's objective runs it."""
    from low_light_image_enhancement_tpu_torch.models.decom import (
        apply_decom_net,
    )

    r_lo, l_lo = apply_decom_net(params, low)
    r_hi, l_hi = apply_decom_net(params, high)
    recon = torch.mean(_abs(r_lo * l_lo - low)) + torch.mean(
        _abs(r_hi * l_hi - high))
    equal_r = torch.mean(_abs(r_lo - r_hi))

    def smooth(l, img):
        # illumination gradients cheap where image gradients are strong
        gray = torch.mean(img, dim=-3, keepdim=True)
        dh_l = _abs(l[..., 1:, :] - l[..., :-1, :])
        dw_l = _abs(l[..., :, 1:] - l[..., :, :-1])
        dh_i = _abs(gray[..., 1:, :] - gray[..., :-1, :])
        dw_i = _abs(gray[..., :, 1:] - gray[..., :, :-1])
        return torch.mean(dh_l * torch.exp(-10.0 * dh_i)) + torch.mean(
            dw_l * torch.exp(-10.0 * dw_i))

    sm = smooth(l_lo, low) + smooth(l_hi, high)
    total = recon + w_equal_r * equal_r + w_smooth * sm
    metrics = {"loss": total, "recon": recon, "equal_r": equal_r,
               "smooth": sm}
    if tcfg.w_relit > 0.0:
        from low_light_image_enhancement_tpu_torch.eval.metrics import ssim

        eps = PipelineConfig().illum_eps
        l_boost = _clip(l_lo, eps, 1.0) ** tcfg.relit_gamma
        y = _clip(r_lo * l_boost, 0.0, 1.0)
        if tcfg.denoise_in_loss:
            y = _denoise_tail(y, tcfg)
        relit_l1 = torch.mean(_abs(y - high))
        relit_s = torch.mean(ssim(y, high))
        relit = relit_l1 + 0.5 * (1.0 - relit_s)
        total = total + tcfg.w_relit * relit
        metrics.update({"loss": total, "relit_l1": relit_l1,
                        "relit_ssim": relit_s})
    return total, metrics


# ----------------------------------------------------------------- step #

def _leaves(params: Params) -> List[torch.Tensor]:
    return [t for layer in params.values() for t in layer.values()]


def _rebuild(params: Params, leaves) -> Params:
    """A params dict of ``params``' names holding ``leaves`` in order."""
    it = iter(leaves)
    return {name: {k: next(it) for k in layer}
            for name, layer in params.items()}


class AdamW:
    """``optax.adamw(learning_rate, weight_decay=...)`` with optax's
    defaults (b1 0.9, b2 0.999, eps 1e-8, eps_root 0; the decoupled decay
    on every leaf, biases too) in optax's arithmetic order. The state is a
    dict of tensors (``count``, ``mu``, ``nu``) that a checkpoint holds, so
    a resumed run continues it exactly."""

    def __init__(self, learning_rate: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.lr, self.wd = learning_rate, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Params) -> Dict[str, Any]:
        zeros = lambda: {name: {k: torch.zeros_like(t)
                                for k, t in layer.items()}
                         for name, layer in params.items()}
        device = _leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    def update(self, grads, state: Dict[str, Any], params: Params
               ) -> Tuple[Params, Dict[str, Any]]:
        """One step: ``grads`` in ``_leaves(params)`` order -> (new params,
        new state)."""
        b1, b2 = self.b1, self.b2
        count = state["count"] + 1
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        new_p, new_mu, new_nu = [], [], []
        for g, p, mu, nu in zip(grads, _leaves(params),
                                _leaves(state["mu"]), _leaves(state["nu"])):
            mu = (1 - b1) * g + b1 * mu
            nu = (1 - b2) * (g * g) + b2 * nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.wd * p
            new_p.append(p + (-self.lr) * u)
            new_mu.append(mu)
            new_nu.append(nu)
        return _rebuild(params, new_p), {
            "count": count, "mu": _rebuild(params, new_mu),
            "nu": _rebuild(params, new_nu)}


def make_optimizer(tcfg: TrainConfig) -> AdamW:
    return AdamW(tcfg.learning_rate, tcfg.weight_decay)


def _accumulated_grads(loss_fn, params: Params, tcfg: TrainConfig,
                       *batches):
    """(metrics, grads) of the whole batch; with ``tcfg.microbatch`` the
    batch runs as equal chunks, their gradients and metrics summed and
    scaled by ``mb / n`` (the mean of equal chunks' means is the batch's
    mean). ``grads`` are in ``_leaves(params)`` order."""

    def grad_fn(*bs):
        leaves = [t.detach().requires_grad_(True) for t in _leaves(params)]
        loss, metrics = loss_fn(_rebuild(params, leaves), *bs, tcfg)
        grads = torch.autograd.grad(loss, leaves)
        return {k: v.detach() for k, v in metrics.items()}, list(grads)

    mb = tcfg.microbatch
    n = batches[0].shape[0]
    if not mb or mb >= n:
        return grad_fn(*batches)
    if n % mb:
        raise ValueError(f"batch {n} not divisible by microbatch {mb}")
    metrics, grads = None, None
    for i in range(0, n, mb):
        m, g = grad_fn(*(b[i:i + mb] for b in batches))
        if metrics is None:
            metrics, grads = m, g
        else:
            metrics = {k: metrics[k] + m[k] for k in metrics}
            grads = [a + b for a, b in zip(grads, g)]
    scale = mb / n
    return ({k: v * scale for k, v in metrics.items()},
            [g * scale for g in grads])


def _all_reduce(total: List[torch.Tensor]) -> List[torch.Tensor]:
    """Sum the tensors over the process group, when one is initialized, as
    one flat all-reduce."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return total
    flat = torch.cat([t.reshape(-1) for t in total])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, i = [], 0
    for t in total:
        out.append(flat[i:i + t.numel()].reshape(t.shape))
        i += t.numel()
    return out


def _data_parallel_grads(loss_fn, params: Params, tcfg: TrainConfig, mesh,
                         *batches):
    """(metrics, grads) of the batch split over every mesh device in order
    (the JAX package's ``P(("data", "spatial"))``): each shard's
    (microbatched) gradients and metrics, weighted by its share of the
    batch and summed onto the first device, then over the process group
    (``parallel.distributed``), whose processes each hold a part of the
    global batch. Equal to the unsharded step up to summation order."""
    devs = mesh.flat
    n = batches[0].shape[0]
    if n % len(devs):
        raise ValueError(f"batch {n} not divisible by the mesh's "
                         f"{len(devs)} devices")
    k = n // len(devs)
    home = _leaves(params)[0].device
    copies = replicas(params, mesh)
    names, total = None, None
    for i, dev in enumerate(devs):
        chunk = [b[i * k:(i + 1) * k].to(dev, non_blocking=True)
                 for b in batches]
        metrics, grads = _accumulated_grads(loss_fn, copies[dev], tcfg,
                                            *chunk)
        if names is None:
            names = list(metrics)
        part = [t.to(home, non_blocking=True) * float(k)
                for t in [metrics[m] for m in names] + grads]
        total = part if total is None else [a + b for a, b in
                                            zip(total, part)]
    count = torch.full((), float(n), device=home)
    *total, count = _all_reduce(total + [count])
    total = [t / count for t in total]
    return dict(zip(names, total[:len(names)])), total[len(names):]


def _row_sharded_net(net: Callable, mesh, halo: int) -> Callable:
    """``net(params, x)`` with the crop's rows split over the mesh's
    ``spatial`` axis and its batch over ``data``: each shard runs the net
    on its rows and ``halo`` rows of each neighbour (the net's receptive
    field), on its device, and keeps its own rows; the outputs are
    gathered onto ``x``'s device under autograd, so the losses run there
    unchanged. At the crop's top and bottom a shard's block ends where the
    crop does: the convs' zero padding then falls past the crop's edge, as
    it does for the unsharded crop, after every layer (edge-replicating
    the input instead would give another step)."""
    n_d, n_sp = mesh.shape["data"], mesh.shape["spatial"]

    def apply(params, x):
        b, _, h, _ = x.shape
        if h % n_sp:
            raise ValueError(f"crop rows {h} not divisible by the mesh's "
                             f"spatial axis ({n_sp})")
        if b % n_d:
            raise ValueError(f"batch {b} not divisible by the mesh's data "
                             f"axis ({n_d})")
        hl, bs = h // n_sp, b // n_d
        copies = replicas(params, mesh)
        chunks = []
        for d, row in enumerate(mesh.devices):
            parts = []
            for s, dev in enumerate(row):
                lo, hi = max(0, s * hl - halo), min(h, (s + 1) * hl + halo)
                xs = x[d * bs:(d + 1) * bs, :, lo:hi].to(dev,
                                                         non_blocking=True)
                a = net(copies[dev], xs)
                keep = a[..., s * hl - lo:s * hl - lo + hl, :]
                parts.append(keep.to(x.device, non_blocking=True))
            chunks.append(torch.cat(parts, dim=-2))
        return torch.cat(chunks)

    return apply


def _make_step(loss_fn: Callable, tcfg: TrainConfig, mesh=None,
               spatial_batch: bool = False) -> Callable:
    """``step(params, opt_state, *batch_args) -> (params, opt_state,
    metrics)`` for any ``loss_fn(params, *batch_args, tcfg) -> (loss,
    metrics)``.

    With a mesh (``parallel.make_mesh``) the batch args are split over all
    its devices and the parameters replicated (``_data_parallel_grads``);
    AdamW then runs once, on the parameters' device. ``spatial_batch=True``
    splits the crop ROWS over the mesh's ``spatial`` axis instead (the
    batch over ``data``): the curve CNN's convs run sharded with halos
    (``_row_sharded_net``), the losses on the gathered maps, for crops too
    large for one device; the crop rows must divide by the axis. It takes
    the curve objectives' ``net`` (zero-reference and paired)."""
    optimizer = make_optimizer(tcfg)
    if mesh is not None:
        mesh.require_local("a train step")
    if mesh is None:
        grads_of = lambda params, *b: _accumulated_grads(loss_fn, params,
                                                         tcfg, *b)
    elif spatial_batch:
        from low_light_image_enhancement_tpu_torch.blocks import cnn_radius

        halo = cnn_radius(PipelineConfig(method="curve"))
        sharded = functools.partial(
            loss_fn, net=_row_sharded_net(_curve_net(tcfg), mesh, halo))
        grads_of = lambda params, *b: _accumulated_grads(sharded, params,
                                                         tcfg, *b)
    else:
        grads_of = lambda params, *b: _data_parallel_grads(
            loss_fn, params, tcfg, mesh, *b)

    def step(params, opt_state, *batch_args):
        metrics, grads = grads_of(params, *batch_args)
        params, opt_state = optimizer.update(grads, opt_state, params)
        return params, opt_state, metrics

    return step


def make_train_step(tcfg: TrainConfig, mesh=None,
                    spatial_batch: bool = False) -> Callable:
    """Zero-reference step: ``step(params, opt_state, batch)``."""
    return _make_step(zero_reference_loss, tcfg, mesh, spatial_batch)


def make_paired_curve_train_step(tcfg: TrainConfig, mesh=None,
                                 spatial_batch: bool = False) -> Callable:
    """Supervised curve step: ``step(params, opt_state, low, high)``."""
    return _make_step(paired_curve_loss, tcfg, mesh, spatial_batch)


def make_supervised_train_step(tcfg: TrainConfig, mesh=None) -> Callable:
    """Supervised FCN step: ``step(params, opt_state, low, high)``."""
    return _make_step(paired_loss, tcfg, mesh)


def make_decom_train_step(tcfg: TrainConfig, mesh=None) -> Callable:
    """Decomposition step: ``step(params, opt_state, low, high)``."""
    return _make_step(decom_loss, tcfg, mesh)


def _on(params: Params, device) -> Params:
    return {name: {k: t.to(device) for k, t in layer.items()}
            for name, layer in params.items()}


def init_train_state(tcfg: TrainConfig, seed: int = 0,
                     device="cuda") -> Tuple[Params, Dict[str, Any]]:
    """The curve CNN's params from a generator seeded with ``seed`` (drawn
    on the CPU, so every device starts from the same weights) and a fresh
    optimizer state, on ``device``."""
    device = resolve_device(device, "init_train_state")
    g = torch.Generator().manual_seed(seed)
    params = _on(init_curve_cnn(g, features=tcfg.features,
                                n_iter=tcfg.n_iter), device)
    return params, make_optimizer(tcfg).init(params)


# ----------------------------------------------------------------- loop #

def _planar(u8: np.ndarray, device) -> torch.Tensor:
    """u8 (B, H, W, 3) -> planar f32 (B, 3, H, W) in [0, 1] on device."""
    x = torch.from_numpy(np.ascontiguousarray(u8)).to(device)
    return (x.to(torch.float32) / 255.0).permute(0, 3, 1, 2).contiguous()


def _synth_planar_pairs(tcfg: TrainConfig, seed: int, start_step: int,
                        device="cuda"):
    """Infinite (low, high) planar f32 pair batches of the numpy synthetic
    stream (the JAX package's, byte for byte), offset by the restored step
    so a resumed run continues the stream instead of replaying it."""
    from low_light_image_enhancement_tpu_torch.data.synth import synth_batch

    i = start_step * tcfg.batch_size
    while True:
        lows, highs = synth_batch(tcfg.batch_size, tcfg.crop, tcfg.crop,
                                  seed=seed, start=i)
        i += tcfg.batch_size
        yield _planar(lows, device), _planar(highs, device)


def _run_training_loop(
    tcfg: TrainConfig,
    params: Params,
    opt_state,
    make_step_fn: Callable,
    data_factory: Callable,
    mesh,
    checkpoint_dir: Optional[str],
    resume: bool,
    log_fn: Optional[Callable[[Dict[str, float]], None]],
    eval_fn: Optional[Callable] = None,
):
    """The shared trainer: checkpoint restore -> the data stream at the
    restored step (``data_factory(start_step)`` yields tuples of the step's
    batch args) -> the step loop with logging and periodic and final
    checkpoints. Returns (params, history).

    ``eval_fn(params) -> float`` (higher is better) turns on early
    stopping when ``tcfg.eval_every > 0``: the loop scores the shipping
    params (the EMA's when on) every ``eval_every`` steps, keeps a host
    copy of the best, stops after ``eval_patience`` evals that do not
    improve, and returns the best params (on the params' device)."""
    device = _leaves(params)[0].device
    ema_params = None
    if tcfg.ema_decay is not None:
        if not 0.0 < tcfg.ema_decay < 1.0:
            raise ValueError(f"ema_decay must be in (0, 1): {tcfg.ema_decay}")
        ema_params = params  # the EMA starts at the init/restored weights
    d = tcfg.ema_decay

    def _state(step):
        s = {"params": params, "opt_state": opt_state, "step": step}
        if ema_params is not None:
            s["ema_params"] = ema_params
        return s

    start_step = 0
    ckpt = None
    if checkpoint_dir is not None:
        from low_light_image_enhancement_tpu_torch.utils.checkpoint import (
            CheckpointManager,
        )

        ckpt = CheckpointManager(checkpoint_dir)
        if resume:
            # tolerate the EMA flag changing between runs: a checkpoint
            # without EMA resumed with ema_decay set (the EMA restarts at
            # the restored params), or one with EMA resumed without it
            # (its EMA tree is ignored)
            try:
                restored = ckpt.restore_latest(_state(0))
            except ValueError:
                alt = dict(_state(0))
                if "ema_params" in alt:
                    alt.pop("ema_params")
                else:
                    alt["ema_params"] = params
                restored = ckpt.restore_latest(alt)
            if restored is not None:
                params = restored["params"]
                opt_state = restored["opt_state"]
                start_step = int(restored["step"])
                if ema_params is not None:
                    ema_params = restored.get("ema_params", params)

    data_iter = data_factory(start_step)
    step_fn = make_step_fn(tcfg, mesh)
    history = []
    best_params, best_score, stale_evals = None, float("-inf"), 0
    early_stop = eval_fn is not None and tcfg.eval_every > 0
    t0 = time.time()
    last_step = start_step
    for step_idx in range(start_step, tcfg.steps):
        batch_args = next(data_iter)
        if not isinstance(batch_args, tuple):
            batch_args = (batch_args,)
        params, opt_state, metrics = step_fn(params, opt_state, *batch_args)
        last_step = step_idx + 1
        if ema_params is not None:
            ema_params = {name: {k: d * a + (1.0 - d) * params[name][k]
                                 for k, a in layer.items()}
                          for name, layer in ema_params.items()}
        if (step_idx + 1) % tcfg.log_every == 0 or step_idx == start_step:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step_idx
            m["imgs_per_sec"] = (tcfg.batch_size * (step_idx + 1 - start_step)
                                 / max(time.time() - t0, 1e-9))
            history.append(m)
            if log_fn is not None:
                log_fn(m)
        if early_stop and (step_idx + 1) % tcfg.eval_every == 0:
            shipping = ema_params if ema_params is not None else params
            score = float(eval_fn(shipping))
            em = {"step": step_idx, "eval_score": score}
            history.append(em)
            if log_fn is not None:
                log_fn(em)
            if score > best_score:
                best_score, stale_evals = score, 0
                # a host copy: the live params go on training
                best_params = _on(shipping, "cpu")
            else:
                stale_evals += 1
                if stale_evals >= tcfg.eval_patience:
                    break
        if ckpt is not None and (step_idx + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(_state(step_idx + 1), step=step_idx + 1)
    if ckpt is not None:
        if last_step > start_step and ckpt.latest_step() != last_step:
            ckpt.save(_state(last_step), step=last_step)
        ckpt.wait()
    if early_stop and best_params is not None:
        return _on(best_params, device), history
    # with EMA on, the averaged weights are the ones to ship
    return (ema_params if ema_params is not None else params), history


def _external(data_factory, data_iter, device, prepare: Callable):
    """The resume-aware factory over external data: ``data_factory``
    (which wins) or ``data_iter``, each item put on ``device`` as float32
    (as ``jnp.asarray`` takes float data with 64-bit types off) and
    through ``prepare``."""
    def put(x):
        return torch.as_tensor(x, dtype=torch.float32, device=device)

    def factory(start):
        src = (data_factory(start) if data_factory is not None
               else iter(data_iter))
        for item in src:
            if isinstance(item, (tuple, list)):
                yield prepare(*map(put, item))
            else:
                yield prepare(put(item))

    return factory


def train_curve_cnn(
    tcfg: TrainConfig = TrainConfig(),
    data_iter=None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    seed: int = 0,
    objective: str = "zeroref",
    hybrid: bool = False,
    data_factory: Optional[Callable] = None,
    eval_fn: Optional[Callable] = None,
    device="cuda",
):
    """The curve CNN's training loop (config 3).

    ``objective``: "zeroref" (the Zero-DCE recipe, input only) or
    "paired" (L1 + SSIM against the GT + weak TV: the shipped curve and
    hybrid weights' recipe). ``hybrid``: train on retinex-boosted inputs,
    the image the hybrid pipeline's curves adjust.

    ``data_iter`` yields (B, 3, H, W) f32 batches for zeroref or (low,
    high) pairs for paired; by default the numpy synthetic stream.
    ``data_factory(start_step) -> iterator`` is the resume-aware form
    (``LOLDataset.train_batch_plans``); it wins over ``data_iter``.
    Returns (params, history)."""
    if objective not in ("zeroref", "paired"):
        raise ValueError(f"objective must be 'zeroref' or 'paired': "
                         f"{objective!r}")
    device = resolve_device(device, "train_curve_cnn")
    params, opt_state = init_train_state(tcfg, seed, device)
    paired = objective == "paired"

    def _boost(low):
        if not hybrid:
            return low
        from low_light_image_enhancement_tpu_torch.core import (
            illumination_boost,
        )

        with torch.no_grad():
            return illumination_boost(low, PipelineConfig())

    if data_factory is not None or data_iter is not None:
        # hybrid's boost applies to external data too: the curves adjust
        # the boosted image at inference, so they must train on it
        prepare = ((lambda low, high: (_boost(low), high)) if paired
                   else _boost)
        factory = _external(data_factory, data_iter, device, prepare)
    elif paired:
        factory = lambda start: (
            (_boost(low), high)
            for low, high in _synth_planar_pairs(tcfg, seed, start, device))
    else:
        factory = lambda start: (
            _boost(low)
            for low, _ in _synth_planar_pairs(tcfg, seed, start, device))
    make_fn = make_paired_curve_train_step if paired else make_train_step
    if eval_fn is None and tcfg.eval_every > 0:
        eval_fn = make_synth_eval_fn(tcfg, hybrid=hybrid, device=device)
    return _run_training_loop(tcfg, params, opt_state, make_fn, factory,
                              mesh, checkpoint_dir, resume, log_fn,
                              eval_fn=eval_fn)


def make_synth_eval_fn(tcfg: TrainConfig, hybrid: bool = False,
                       n_images: int = 8, seed: int = 17,
                       device="cuda") -> Callable:
    """The curve trainers' held-out early-stop metric: mean SSIM against
    the GT on a fixed synthetic batch (a seed apart from the training
    stream's), through the forward the pipeline ships: the boost
    (hybrid), the curves and the full-strength denoise tail."""
    from low_light_image_enhancement_tpu_torch.core import illumination_boost
    from low_light_image_enhancement_tpu_torch.eval.metrics import ssim

    device = resolve_device(device, "make_synth_eval_fn")
    lows, highs = _synth_eval_pair(tcfg, n_images, seed, device)

    @torch.no_grad()
    def score(params):
        x = illumination_boost(lows, PipelineConfig()) if hybrid else lows
        a = apply_curve_cnn(params, x, n_iter=tcfg.n_iter)
        y = _clip(apply_curves(x, a), 0.0, 1.0)
        return torch.mean(ssim(_denoise_tail(y, tcfg), highs))

    return score


def _synth_eval_pair(tcfg: TrainConfig, n_images: int, seed: int,
                     device="cuda"):
    from low_light_image_enhancement_tpu_torch.data.synth import synth_batch

    lows, highs = synth_batch(n_images, tcfg.crop, tcfg.crop, seed=seed)
    return _planar(lows, device), _planar(highs, device)


def _pairs_factory(tcfg, seed, data_iter, data_factory, device):
    if data_factory is not None or data_iter is not None:
        return _external(data_factory, data_iter, device,
                         lambda low, high: (low, high))
    return lambda start: _synth_planar_pairs(tcfg, seed, start, device)


def train_fcn(
    tcfg: TrainConfig = TrainConfig(features=24, batch_size=16, crop=256),
    data_iter=None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    seed: int = 0,
    data_factory: Optional[Callable] = None,
    device="cuda",
):
    """Supervised training loop of the FCN on (low, high) planar f32
    pairs (``data_iter``, or the resume-aware ``data_factory``; by
    default the synthetic stream). Returns (params, history)."""
    from low_light_image_enhancement_tpu_torch.models.fcn import init_fcn

    device = resolve_device(device, "train_fcn")
    params = _on(init_fcn(torch.Generator().manual_seed(seed),
                          features=tcfg.features), device)
    opt_state = make_optimizer(tcfg).init(params)
    return _run_training_loop(
        tcfg, params, opt_state, make_supervised_train_step,
        _pairs_factory(tcfg, seed, data_iter, data_factory, device), mesh,
        checkpoint_dir, resume, log_fn)


def train_decom(
    tcfg: TrainConfig = TrainConfig(),
    data_iter=None,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    resume: bool = False,
    log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
    seed: int = 0,
    data_factory: Optional[Callable] = None,
    device="cuda",
):
    """Decomposition-objective training loop of the DecomNet (the shipped
    decom weights' recipe) on (low, high) planar f32 pairs, as
    :func:`train_fcn`. Returns (params, history)."""
    from low_light_image_enhancement_tpu_torch.models.decom import (
        init_decom_net,
    )

    device = resolve_device(device, "train_decom")
    params = _on(init_decom_net(torch.Generator().manual_seed(seed)), device)
    opt_state = make_optimizer(tcfg).init(params)
    return _run_training_loop(
        tcfg, params, opt_state, make_decom_train_step,
        _pairs_factory(tcfg, seed, data_iter, data_factory, device), mesh,
        checkpoint_dir, resume, log_fn)
