"""Learned Retinex decomposition net (RetinexNet-style DecomNet).

Maps an RGB image to reflectance R in [0,1]^3 and illumination L in [0,1]:
five 3x3 convs at 32 features on RGB plus its channel max (4 channels in),
ReLU after the first four, a sigmoid head of 4 channels split into R and L.
Parameters as in ``models/curve_cnn.py``. ``apply_decom_net`` is the
``conv_impl="xla"`` arm (``F.conv2d``), ``apply_decom_net_pallas`` the
``"pallas"`` arm (c2-c4 as K6a), ``apply_decom_net_gemm`` and
``apply_decom_net_packed`` the ``"gemm"`` and ``"packed"``/``"packed12"``
arms (``ops/patch_conv.py``); ``DecomNet`` is the net as an
``nn.Module``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from low_light_image_enhancement_tpu_torch.kernels.mxu_conv import (
    conv2d_patch_mxu,
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
    conv2d_patch_gemm,
    depth_to_space,
    pack_bias,
    pack_block_conv_weights,
    pack_patch_weights,
    space_to_depth,
)

Params = Dict[str, Dict[str, torch.Tensor]]


def init_decom_net(generator: torch.Generator,
                   features: int = 32) -> Params:
    """He-normal initialized parameters of the five convs."""
    sizes = [(4, features), (features, features), (features, features),
             (features, features), (features, 4)]
    params: Params = {}
    for i, (cin, cout) in enumerate(sizes, start=1):
        w = torch.randn((cout, cin, 3, 3), generator=generator,
                        dtype=torch.float32)
        params[f"c{i}"] = {"w": w * math.sqrt(2.0 / (3 * 3 * cin)),
                           "b": torch.zeros((cout,), dtype=torch.float32)}
    return params


def _split_rl(out: torch.Tensor):
    """The head's (B, 4, H, W), in any memory format -> float32, contiguous
    (R (B, 3, H, W), L (B, 1, H, W))."""
    out = out.to(torch.float32, memory_format=torch.contiguous_format)
    return out[:, :3], out[:, 3:4]


def apply_decom_net(params: Params, x: torch.Tensor,
                    compute_dtype="float32"):
    """(..., 3, H, W) -> (R (..., 3, H, W), L (..., 1, H, W)), both float32
    in [0,1]."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    h = torch.cat([x, torch.amax(x, dim=1, keepdim=True)], dim=1)
    for i in range(1, 5):
        p = params[f"c{i}"]
        h = torch.relu(conv2d(h, p["w"], p["b"], compute_dtype))
    p = params["c5"]
    r, l = _split_rl(sigmoid(conv2d(h, p["w"], p["b"], compute_dtype)))
    return (r, l) if batched else (r[0], l[0])


def apply_decom_net_pallas(params: Params, x: torch.Tensor,
                           compute_dtype="bfloat16"):
    """:func:`apply_decom_net` with c2-c4 as K6a
    (``kernels.mxu_conv.conv2d_patch_mxu``, bias and relu in f32 in the
    kernel), on NHWC from the stem to the head; the JAX package's
    ``apply_decom_net_pallas``. The 4-channel stem and head are
    ``layers.conv2d``, the head's sigmoid in the compute dtype, as
    there."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    h = torch.cat([x, torch.amax(x, dim=1, keepdim=True)], dim=1) \
        .contiguous(memory_format=torch.channels_last)
    p = params["c1"]
    h = nhwc(torch.relu(conv2d(h, p["w"], p["b"], compute_dtype)))
    for i in range(2, 5):
        p = params[f"c{i}"]
        h = conv2d_patch_mxu((h,), p["w"], p["b"], act="relu")
    p = params["c5"]
    r, l = _split_rl(sigmoid(conv2d(h.permute(0, 3, 1, 2), p["w"], p["b"],
                                    compute_dtype)))
    return (r, l) if batched else (r[0], l[0])


def apply_decom_net_gemm(params: Params, x: torch.Tensor,
                         compute_dtype="float32"):
    """:func:`apply_decom_net` with all five convs as patch GEMMs
    (``ops.patch_conv.conv2d_patch_gemm``) on space-to-depth activations;
    the JAX package's ``apply_decom_net_gemm``."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    cd = as_dtype(compute_dtype)
    h = torch.cat([x, torch.amax(x, dim=1, keepdim=True)], dim=1)
    h = space_to_depth(h.permute(0, 2, 3, 1)).to(cd)

    def cv(name, t):
        p = params[name]
        wp = cached_pack((p["w"],), cd, "patch",
                         lambda: pack_patch_weights(p["w"]))
        return conv2d_patch_gemm(t, wp, pack_bias(p["b"]), cd)

    for i in range(1, 5):
        h = torch.relu(cv(f"c{i}", h))
    r, l = _split_rl(sigmoid(depth_to_space(cv("c5", h)).permute(0, 3, 1,
                                                                  2)))
    return (r, l) if batched else (r[0], l[0])


def apply_decom_net_packed(params: Params, x: torch.Tensor,
                           compute_dtype="bfloat16",
                           block: tuple = (2, 2)):
    """:func:`apply_decom_net` with c2-c4 as one ``F.conv2d`` each on
    space-to-depth lanes (``ops.patch_conv.conv2d_block_xla``), the
    4-channel stem and head normal convs; the JAX package's
    ``apply_decom_net_packed``. Differentiable."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    cd = as_dtype(compute_dtype)
    h = torch.cat([x, torch.amax(x, dim=1, keepdim=True)], dim=1)
    p = params["c1"]
    h = space_to_depth(nhwc(torch.relu(conv2d(h, p["w"], p["b"], cd))),
                       block)
    for i in range(2, 5):
        p = params[f"c{i}"]
        wk = cached_pack((p["w"],), cd, f"block {block}",
                         lambda: pack_block_conv_weights(p["w"],
                                                         block=block))
        h = torch.relu(conv2d_block_xla(h, wk, p["b"], cd))
    p = params["c5"]
    r, l = _split_rl(sigmoid(conv2d(
        depth_to_space(h, block).permute(0, 3, 1, 2), p["w"], p["b"], cd)))
    return (r, l) if batched else (r[0], l[0])


class DecomNet(ParamsNet):
    """The decomposition net as an ``nn.Module`` (parameters ``c1.w``,
    ...; ``params`` given, or ``init`` from ``generator``, seed 0 by
    default); ``forward`` is :func:`apply_decom_net`."""

    def __init__(self, features: int = 32, compute_dtype="float32",
                 params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features, self.compute_dtype = features, compute_dtype
        if params is None:
            params = self.init(generator if generator is not None
                               else torch.Generator().manual_seed(0))
        self.set_params(params)

    def init(self, generator: torch.Generator) -> Params:
        return init_decom_net(generator, self.features)

    def apply(self, params: Params, x: torch.Tensor):
        return apply_decom_net(params, x, self.compute_dtype)

    def forward(self, x: torch.Tensor):
        return self.apply(self.params, x)
