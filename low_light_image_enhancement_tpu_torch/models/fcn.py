"""Context-aggregation FCN enhancer.

A stack of 3x3 convs with exponentially growing dilation (1, 2, 4, ..., 1)
at 24 features, then a 1x1 sigmoid head to RGB. Parameters are a dict
``{"c1": {"w": (Cout, Cin, 3, 3), "b": (Cout,)}, ..., "out": {...}}``
(``models.weights.params_from_numpy`` converts the JAX package's HWIO).

``apply_fcn`` is the ``conv_impl="xla"`` arm (``F.conv2d``);
``apply_fcn_pallas`` runs c2-c7 as K6b, one launch a layer, and
``kernels.fcn_cascade.apply_fcn_cascade`` all six as one K7 launch;
``apply_fcn_gemm`` (im2col GEMMs) and ``apply_fcn_packed`` (convs on
space-to-depth lanes) are the ``"gemm"`` and ``"packed"``/``"packed12"``
arms (``ops/patch_conv.py``). ``EnhanceFCN`` is the net as an
``nn.Module``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from low_light_image_enhancement_tpu_torch.kernels.mxu_conv import (
    conv2d_dense9_mxu,
)
from low_light_image_enhancement_tpu_torch.models.layers import (
    ParamsNet,
    as_dtype,
    conv2d,
    nhwc,
    sigmoid,
)
from low_light_image_enhancement_tpu_torch.ops.patch_conv import (
    cached_pack,
    conv2d_block_xla,
    conv2d_im2col_gemm,
    depth_to_space,
    pack_block_conv_weights,
    pack_im2col_weights,
    space_to_depth,
)

Params = Dict[str, Dict[str, torch.Tensor]]


def _dilations(depth: int = 7) -> Tuple[int, ...]:
    """1, 2, 4, ... capped at 32, then a closing dilation-1 layer."""
    return tuple(min(2 ** i, 32) for i in range(depth - 1)) + (1,)


def init_fcn(generator: torch.Generator, features: int = 24,
             depth: int = 7) -> Params:
    """He-normal initialized parameters of the dilated stack and head."""
    sizes = [(3, features)] + [(features, features)] * (depth - 1)
    params: Params = {}
    for i, (cin, cout) in enumerate(sizes, start=1):
        w = torch.randn((cout, cin, 3, 3), generator=generator,
                        dtype=torch.float32)
        params[f"c{i}"] = {"w": w * math.sqrt(2.0 / (3 * 3 * cin)),
                           "b": torch.zeros((cout,), dtype=torch.float32)}
    w = torch.randn((3, features, 1, 1), generator=generator,
                    dtype=torch.float32)
    params["out"] = {"w": w * math.sqrt(2.0 / features),
                     "b": torch.zeros((3,), dtype=torch.float32)}
    return params


def _leaky(h: torch.Tensor) -> torch.Tensor:
    """leaky_relu 0.2 in h's dtype, the slope rounded to it, as JAX's."""
    return torch.where(h >= 0, h, h * torch.tensor(0.2, dtype=h.dtype))


def apply_fcn(params: Params, x: torch.Tensor,
              compute_dtype="float32") -> torch.Tensor:
    """(..., 3, H, W) in [0,1] -> enhanced (..., 3, H, W) in [0,1],
    float32. The activations and the head's sigmoid run in the compute
    dtype, as in the JAX package."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    cd = as_dtype(compute_dtype)
    depth = sum(1 for k in params if k.startswith("c"))
    h = x
    for i, dil in enumerate(_dilations(depth), start=1):
        p = params[f"c{i}"]
        h = _leaky(conv2d(h, p["w"], p["b"], cd, dilation=dil))
    out = sigmoid(conv2d(h, params["out"]["w"], params["out"]["b"],
                               cd)).to(torch.float32)
    return out if batched else out[0]


def fcn_stem_nhwc(params: Params, x: torch.Tensor, cd: torch.dtype
                  ) -> torch.Tensor:
    """The kernel arms' stem: NCHW (B, 3, H, W) in -> NHWC c1 activations
    in ``cd``. The JAX package's ``conv2d_im2col_gemm``: an f32 sum of the
    ``cd`` products, + the f32 bias, one cast; then leaky in ``cd``. The
    input is transposed to NHWC once, here."""
    p = params["c1"]
    dil = _dilations(sum(1 for k in params if k.startswith("c")))[0]
    xc = x.to(cd).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(xc.float(), p["w"].to(cd).float(), padding=dil,
                 dilation=dil)
    y = (y + p["b"].float()[:, None, None]).to(cd)
    return nhwc(_leaky(y))


def fcn_head_nhwc(params: Params, h: torch.Tensor) -> torch.Tensor:
    """The kernel arms' head on NHWC activations: the 1x1 conv as an f32
    sum of the compute-dtype products, + the f32 bias, the sigmoid in f32
    -> NCHW (B, 3, H, W) float32 (the transpose back, once)."""
    po = params["out"]
    w = po["w"][:, :, 0, 0].to(h.dtype).float()            # (3, C)
    y = torch.matmul(h.float(), w.t()) + po["b"].float()
    return sigmoid(y).permute(0, 3, 1, 2).contiguous()


def apply_fcn_pallas(params: Params, x: torch.Tensor,
                     compute_dtype="bfloat16") -> torch.Tensor:
    """:func:`apply_fcn` with the dilated stack c2-c7 as K6b
    (``kernels.mxu_conv.conv2d_dense9_mxu``, bias and leaky in f32 in the
    kernel), on NHWC from the stem to the head; the JAX package's
    ``apply_fcn_pallas``."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    cd = as_dtype(compute_dtype)
    depth = sum(1 for k in params if k.startswith("c"))
    h = fcn_stem_nhwc(params, x, cd)
    for i, dil in enumerate(_dilations(depth)[1:], start=2):
        p = params[f"c{i}"]
        h = conv2d_dense9_mxu(h, p["w"], p["b"], act="leaky", dilation=dil)
    out = fcn_head_nhwc(params, h)
    return out if batched else out[0]


def apply_fcn_gemm(params: Params, x: torch.Tensor,
                   compute_dtype="float32") -> torch.Tensor:
    """:func:`apply_fcn` with every 3x3 layer, dilated or not, as three
    accumulated im2col GEMMs (``ops.patch_conv.conv2d_im2col_gemm``) on
    NHWC, and the 1x1 head as an f32-accumulated channel matmul; the JAX
    package's ``apply_fcn_gemm``."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    cd = as_dtype(compute_dtype)
    depth = sum(1 for k in params if k.startswith("c"))
    h = x.permute(0, 2, 3, 1).to(cd)
    for i, dil in enumerate(_dilations(depth), start=1):
        p = params[f"c{i}"]
        w9 = cached_pack((p["w"],), cd, "im2col",
                         lambda: pack_im2col_weights(p["w"]))
        h = _leaky(conv2d_im2col_gemm(h, w9, p["b"], cd, dilation=dil))
    out = fcn_head_nhwc(params, h)
    return out if batched else out[0]


def apply_fcn_packed(params: Params, x: torch.Tensor,
                     compute_dtype="bfloat16",
                     block: tuple = (2, 2)) -> torch.Tensor:
    """:func:`apply_fcn` with the dilated stack c2-c7 as one ``F.conv2d``
    each on space-to-depth lanes (``ops.patch_conv.conv2d_block_xla``; an
    even dilation d is the packed conv's dilation ``d // block`` on each
    packed axis, with phase-keeping weights), the stem a normal conv and
    the head an f32-accumulated channel matmul; the JAX package's
    ``apply_fcn_packed``. ``block=(1, 2)`` packs the columns alone.
    Differentiable."""
    bh, bw = block
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    cd = as_dtype(compute_dtype)
    dils = _dilations(sum(1 for k in params if k.startswith("c")))
    p1 = params["c1"]
    h = _leaky(conv2d(x, p1["w"], p1["b"], cd, dilation=dils[0]))
    h = space_to_depth(nhwc(h), block)
    for i, dil in enumerate(dils[1:], start=2):
        p = params[f"c{i}"]
        wk = cached_pack((p["w"],), cd, f"block {block} d{dil}",
                         lambda: pack_block_conv_weights(
                             p["w"], dilation=dil, block=block))
        h = _leaky(conv2d_block_xla(
            h, wk, p["b"], cd, step=(max(1, dil // bh), max(1, dil // bw))))
    out = fcn_head_nhwc(params, depth_to_space(h, block))
    return out if batched else out[0]


class EnhanceFCN(ParamsNet):
    """The dilated FCN as an ``nn.Module`` (parameters ``c1.w``, ...,
    ``out.b``; ``params`` given, or ``init`` from ``generator``, seed 0 by
    default); ``forward`` is :func:`apply_fcn`."""

    def __init__(self, features: int = 24, depth: int = 7,
                 compute_dtype="float32", params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features, self.depth = features, depth
        self.compute_dtype = compute_dtype
        if params is None:
            params = self.init(generator if generator is not None
                               else torch.Generator().manual_seed(0))
        self.set_params(params)

    def init(self, generator: torch.Generator) -> Params:
        return init_fcn(generator, self.features, self.depth)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return apply_fcn(params, x, self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, x)
