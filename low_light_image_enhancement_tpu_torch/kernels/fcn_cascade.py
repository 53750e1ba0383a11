"""K7 (the fcn stack's dilated layers in one launch): wrapper, plain
PyTorch version and launch count.

``fcn_cascade_mxu`` replaces the JAX package's
``kernels/fcn_cascade.py::fcn_cascade_mxu`` (``_cascade_kernel``), and
``apply_fcn_cascade`` its ``apply_fcn_cascade``: the fcn net with layers
c2-c7 (24 channels, dilations 2, 4, 8, 16, 32, 1, bias and leaky 0.2 in
f32, one cast a layer) in one launch of the CUDA kernel in
``csrc/fcn_cascade.cu``: bf16 runs K6's tensor-core layer, f32 its
CUDA-core layer, each layer after a grid-wide barrier. Each layer sees
conv-SAME zeros beyond the tensor, as each layer of the JAX cascade does
beyond the block, so the stack equals K6b applied layer by layer (bit for
bit on the card, in both dtypes). The wrapper dispatches on the device of
its input alone: a CPU tensor goes to ``fcn_cascade_plain``, a CUDA tensor
to the kernel (or the call raises).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    _raise_on,
)
from low_light_image_enhancement_tpu_torch.kernels.mxu_conv import (
    _check_aligned,
    _check_layer,
    conv3x3_plain,
    pack_conv_weights,
    pack_conv_weights_wgmma,
    packed_params,
)
from low_light_image_enhancement_tpu_torch.models.fcn import (
    _dilations,
    fcn_head_nhwc,
    fcn_stem_nhwc,
)
from low_light_image_enhancement_tpu_torch.models.layers import as_dtype

# the kernel's limits on the layers of one launch and on their width
MAX_LAYERS = 8
CASCADE_CHANNELS = (8, 16, 24, 32)


def fcn_cascade_plain(x: torch.Tensor, ws: Sequence[torch.Tensor],
                      bs: Sequence[torch.Tensor],
                      dilations: Sequence[int]) -> torch.Tensor:
    """Plain version of K7: K6b's plain version, leaky, layer by layer."""
    for w, b, d in zip(ws, bs, dilations):
        x = conv3x3_plain((x,), w, b, "leaky", d)
    return x


def fcn_cascade_mxu(x: torch.Tensor, ws: Sequence[torch.Tensor],
                    bs: Sequence[torch.Tensor],
                    dilations: Sequence[int]) -> torch.Tensor:
    """K7: NHWC (B, H, W, C) through the 3x3 layers ``ws`` (C, C, 3, 3),
    ``bs`` (C,) at ``dilations``, each with bias and leaky 0.2 in f32 ->
    (B, H, W, C) in x's dtype, in one launch. The packed weights are cached
    per parameter set."""
    ws, bs, dilations = tuple(ws), tuple(bs), tuple(int(d) for d in dilations)
    nl = len(ws)
    if not 1 <= nl <= MAX_LAYERS or len(bs) != nl or len(dilations) != nl:
        raise ValueError(f"1 to {MAX_LAYERS} layers, each with a weight, a "
                         f"bias and a dilation: {nl}, {len(bs)}, "
                         f"{len(dilations)}")
    c = x.shape[-1] if x.ndim == 4 else -1
    for w, b, d in zip(ws, bs, dilations):
        _check_layer((x,), w, b, "leaky", d)
        if w.shape[0] != c:
            raise ValueError(f"the cascade keeps its width: {tuple(w.shape)}"
                             f" on {c} channels")
    if x.device.type == "cpu":
        return fcn_cascade_plain(x, ws, bs, dilations)
    lib = _build.load_library()
    _check_aligned(x)
    if c not in CASCADE_CHANNELS:
        raise ValueError(f"the cascade kernel takes C in {CASCADE_CHANNELS}"
                         f", got {c}")
    dt = x.dtype
    bf16 = dt == torch.bfloat16
    if bf16:
        wk, bk = packed_params(
            ws + bs, dt,
            lambda: (torch.cat([pack_conv_weights_wgmma(w, (c,)).reshape(-1)
                                for w in ws]),
                     torch.stack([b.detach().float() for b in bs])),
            form="cascade wgmma")
    else:
        wk, bk = packed_params(
            ws + bs, dt,
            lambda: (torch.stack([pack_conv_weights(w, dt) for w in ws]),
                     torch.stack([b.detach().float() for b in bs])),
            form="cascade")
    out = torch.empty_like(x)
    scratch = torch.empty_like(x)
    bsz, h, w, _ = x.shape
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_fcn_cascade(
            x.data_ptr(), scratch.data_ptr(), out.data_ptr(), wk.data_ptr(),
            bk.data_ptr(), (ctypes.c_int * nl)(*dilations), nl, c, bsz, h, w,
            int(bf16), stream)
    _raise_on(rc, lib, "fcn_cascade")
    fcn_cascade_mxu.launches += 1
    return out


fcn_cascade_mxu.launches = 0


def apply_fcn_cascade(params, x: torch.Tensor,
                      compute_dtype="bfloat16") -> torch.Tensor:
    """``models.fcn.apply_fcn`` with c2-c7 as one K7 launch: the stem and
    the 1x1 sigmoid head of ``models.fcn.apply_fcn_pallas`` around it, on
    NHWC from the stem to the head."""
    batched = x.ndim == 4
    if not batched:
        x = x[None]
    cd = as_dtype(compute_dtype)
    depth = sum(1 for k in params if k.startswith("c"))
    layers = [params[f"c{i}"] for i in range(2, depth + 1)]
    h = fcn_cascade_mxu(fcn_stem_nhwc(params, x, cd),
                        [p["w"] for p in layers], [p["b"] for p in layers],
                        _dilations(depth)[1:])
    out = fcn_head_nhwc(params, h)
    return out if batched else out[0]
