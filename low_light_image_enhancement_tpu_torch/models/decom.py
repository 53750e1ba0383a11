"""Learned Retinex decomposition net (RetinexNet-style DecomNet).

Maps an RGB image to reflectance R in [0,1]^3 and illumination L in [0,1]:
five 3x3 convs at 32 features on RGB plus its channel max (4 channels in),
ReLU after the first four, a sigmoid head of 4 channels split into R and L.
Parameters as in ``models/curve_cnn.py``. ``apply_decom_net`` is the
``conv_impl="xla"`` arm (``F.conv2d``), ``apply_decom_net_pallas`` the
``"pallas"`` arm (c2-c4 as K6a); ``DecomNet`` is the net as an
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
    conv2d,
    nhwc,
    sigmoid,
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
    out = sigmoid(conv2d(h, p["w"], p["b"], compute_dtype)) \
        .to(torch.float32)
    r, l = out[:, :3], out[:, 3:4]
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
    out = sigmoid(conv2d(h.permute(0, 3, 1, 2), p["w"], p["b"],
                         compute_dtype)).to(
        torch.float32, memory_format=torch.contiguous_format)
    r, l = out[:, :3], out[:, 3:4]
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
