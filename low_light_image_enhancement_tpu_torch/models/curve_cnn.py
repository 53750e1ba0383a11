"""Zero-DCE-style curve-estimation CNN.

Seven 3x3 convs with U-style skip concatenations; the head emits
``3 * n_iter`` tanh-bounded per-pixel curve maps for ``ops.curves``.
Parameters are a dict ``{"c1": {"w": (Cout, Cin, 3, 3), "b": (Cout,)}, ...}``
(``models.weights.params_from_numpy`` converts the JAX package's HWIO).
``apply_curve_cnn`` is the ``conv_impl="xla"`` arm (``F.conv2d``),
``apply_curve_cnn_pallas`` the ``"pallas"`` arm (c2-c7 as K6a),
``apply_curve_cnn_gemm`` the ``"gemm"`` arm and ``apply_curve_cnn_packed``
the ``"packed"``/``"packed12"`` arms (``ops/patch_conv.py``);
``CurveEstimatorCNN`` is the net as an ``nn.Module``.
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


def init_curve_cnn(
    generator: torch.Generator, features: int = 32, n_iter: int = 8
) -> Params:
    """He-normal initialized parameters for the 7-conv curve estimator."""
    sizes = [
        (3, features),                 # c1
        (features, features),          # c2
        (features, features),          # c3
        (features, features),          # c4
        (2 * features, features),      # c5 (cat x3, x4)
        (2 * features, features),      # c6 (cat x2, x5)
        (2 * features, 3 * n_iter),    # c7 (cat x1, x6)
    ]
    params: Params = {}
    for i, (cin, cout) in enumerate(sizes, start=1):
        w = torch.randn((cout, cin, 3, 3), generator=generator,
                        dtype=torch.float32)
        params[f"c{i}"] = {
            "w": w * math.sqrt(2.0 / (3 * 3 * cin)),
            "b": torch.zeros((cout,), dtype=torch.float32),
        }
    return params


def apply_curve_cnn(
    params: Params,
    x: torch.Tensor,
    n_iter: int = 8,
    compute_dtype="float32",
) -> torch.Tensor:
    """(..., 3, H, W) in [0,1] -> curve maps (..., n_iter, 3, H, W) in
    [-1,1], float32. Map channel ``i*3 + c`` is iteration i, color c."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]

    def cv(name, h):
        return conv2d(h, params[name]["w"], params[name]["b"], compute_dtype)

    x1 = torch.relu(cv("c1", x))
    x2 = torch.relu(cv("c2", x1))
    x3 = torch.relu(cv("c3", x2))
    x4 = torch.relu(cv("c4", x3))
    x5 = torch.relu(cv("c5", torch.cat([x3, x4], dim=1)))
    x6 = torch.relu(cv("c6", torch.cat([x2, x5], dim=1)))
    a = torch.tanh(cv("c7", torch.cat([x1, x6], dim=1))).to(torch.float32)
    b, _, h, w = a.shape
    a = a.reshape(b, n_iter, 3, h, w)
    return a if batched else a[0]


def _maps_from_nhwc(a: torch.Tensor, n_iter: int) -> torch.Tensor:
    """The head's NHWC (B, H, W, 3*n_iter) -> float32 maps (B, n_iter, 3,
    H, W)."""
    b, h, w, _ = a.shape
    return a.permute(0, 3, 1, 2).to(
        torch.float32, memory_format=torch.contiguous_format).reshape(
        b, n_iter, 3, h, w)


def apply_curve_cnn_pallas(
    params: Params,
    x: torch.Tensor,
    n_iter: int = 8,
    compute_dtype="bfloat16",
) -> torch.Tensor:
    """:func:`apply_curve_cnn` with c2-c7 as K6a
    (``kernels.mxu_conv.conv2d_patch_mxu``: the skip concats read in place,
    bias and relu/tanh in f32 in the kernel), on NHWC from the stem to the
    head; the JAX package's ``apply_curve_cnn_pallas``. The 3-channel stem
    is ``layers.conv2d`` and relu, as there."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    p1 = params["c1"]
    xc = x.contiguous(memory_format=torch.channels_last)
    x1 = nhwc(torch.relu(conv2d(xc, p1["w"], p1["b"], compute_dtype)))

    def cv(name, hs, act="relu"):
        p = params[name]
        return conv2d_patch_mxu(hs, p["w"], p["b"], act=act)

    x2 = cv("c2", (x1,))
    x3 = cv("c3", (x2,))
    x4 = cv("c4", (x3,))
    x5 = cv("c5", (x3, x4))
    x6 = cv("c6", (x2, x5))
    a = _maps_from_nhwc(cv("c7", (x1, x6), act="tanh"), n_iter)
    return a if batched else a[0]


def apply_curve_cnn_gemm(
    params: Params,
    x: torch.Tensor,
    n_iter: int = 8,
    compute_dtype="float32",
) -> torch.Tensor:
    """:func:`apply_curve_cnn` with all seven convs as patch GEMMs
    (``ops.patch_conv.conv2d_patch_gemm``: 2x2 output blocks, K = 16*Cin,
    N = 4*Cout) on space-to-depth activations, packed once on entry and
    unpacked once at exit; the JAX package's ``apply_curve_cnn_gemm``."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    f = params["c1"]["w"].shape[0]
    xp = space_to_depth(x.permute(0, 2, 3, 1)).to(
        as_dtype(compute_dtype))

    def cv(name, h, groups):
        p = params[name]
        wp = cached_pack((p["w"],), compute_dtype, f"patch {groups}",
                         lambda: pack_patch_weights(p["w"], groups))
        return conv2d_patch_gemm(h, wp, pack_bias(p["b"]), compute_dtype,
                                 groups=groups)

    x1 = torch.relu(cv("c1", xp, (3,)))
    x2 = torch.relu(cv("c2", x1, (f,)))
    x3 = torch.relu(cv("c3", x2, (f,)))
    x4 = torch.relu(cv("c4", x3, (f,)))
    x5 = torch.relu(cv("c5", torch.cat([x3, x4], -1), (f, f)))
    x6 = torch.relu(cv("c6", torch.cat([x2, x5], -1), (f, f)))
    a = torch.tanh(cv("c7", torch.cat([x1, x6], -1), (f, f)))
    a = _maps_from_nhwc(depth_to_space(a), n_iter)
    return a if batched else a[0]


def apply_curve_cnn_packed(
    params: Params,
    x: torch.Tensor,
    n_iter: int = 8,
    compute_dtype="bfloat16",
    block: tuple = (2, 2),
) -> torch.Tensor:
    """:func:`apply_curve_cnn` with c2-c7 as one ``F.conv2d`` each on
    space-to-depth lanes (``ops.patch_conv.conv2d_block_xla``: 4x the
    lanes at ``block`` (2, 2), 2x at the half packing (1, 2)), the
    3-channel stem a normal conv; the JAX package's
    ``apply_curve_cnn_packed``. Differentiable."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    f = params["c1"]["w"].shape[0]

    def cv(name, h, groups, act):
        p = params[name]
        wk = cached_pack((p["w"],), compute_dtype, f"block {block} {groups}",
                         lambda: pack_block_conv_weights(
                             p["w"], groups=groups, block=block))
        return act(conv2d_block_xla(h, wk, p["b"], compute_dtype))

    p1 = params["c1"]
    x1 = space_to_depth(
        nhwc(torch.relu(conv2d(x, p1["w"], p1["b"], compute_dtype))), block)
    x2 = cv("c2", x1, (f,), torch.relu)
    x3 = cv("c3", x2, (f,), torch.relu)
    x4 = cv("c4", x3, (f,), torch.relu)
    x5 = cv("c5", torch.cat([x3, x4], -1), (f, f), torch.relu)
    x6 = cv("c6", torch.cat([x2, x5], -1), (f, f), torch.relu)
    a = cv("c7", torch.cat([x1, x6], -1), (f, f), torch.tanh)
    a = _maps_from_nhwc(depth_to_space(a, block), n_iter)
    return a if batched else a[0]


class CurveEstimatorCNN(ParamsNet):
    """The curve CNN as an ``nn.Module``: its parameters are the params
    dict (``c1.w``, ...; ``params`` given, or ``init`` from ``generator``,
    seed 0 by default), ``forward`` is :func:`apply_curve_cnn`.
    ``init``/``apply`` are the JAX package's functional pair."""

    def __init__(self, features: int = 32, n_iter: int = 8,
                 compute_dtype="float32", params: Optional[Params] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.features, self.n_iter = features, n_iter
        self.compute_dtype = compute_dtype
        if params is None:
            params = self.init(generator if generator is not None
                               else torch.Generator().manual_seed(0))
        self.set_params(params)

    def init(self, generator: torch.Generator) -> Params:
        return init_curve_cnn(generator, self.features, self.n_iter)

    def apply(self, params: Params, x: torch.Tensor) -> torch.Tensor:
        return apply_curve_cnn(params, x, self.n_iter, self.compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.apply(self.params, x)
