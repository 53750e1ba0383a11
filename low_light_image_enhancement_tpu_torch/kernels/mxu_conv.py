"""K6 (one 3x3 conv layer of the learned nets): wrappers, plain PyTorch
version, weight packing and launch counts.

- K6a ``conv2d_patch_mxu`` replaces the JAX package's
  ``kernels/mxu_conv.py::conv2d_patch_mxu`` (``_patch_kernel``): dilation
  1, the input a concat of 1-2 groups, relu or tanh (the curve CNN's c2-c7,
  the decom net's c2-c4 under ``conv_impl="pallas"``).
- K6b ``conv2d_dense9_mxu`` replaces its ``conv2d_dense9_mxu``
  (``_conv_kernel``): dilation 1 or even, leaky 0.2 (the fcn stack's c2-c7).

Both run the CUDA kernels of ``csrc/mxu_conv.cu`` and count their
launches apart: bf16 on the tensor cores (``csrc/conv3x3_wgmma.cuh``, an
implicit GEMM of wgmma fed by TMA, weights from
``pack_conv_weights_wgmma``), f32 on the CUDA cores (``csrc/conv3x3.cuh``,
weights from ``pack_conv_weights``). They take unpacked NHWC activations:
the JAX kernels' space-to-depth packing fills the TPU's 128-lane matrix
unit and has no use on the card. The arithmetic is the Pallas arm's: the
activations and the weights in bf16 (or f32), an f32 accumulator, the bias
added in f32, the activation in f32, one cast to the input dtype. Each
wrapper dispatches on the device of its input alone: a CPU tensor goes to
``conv3x3_plain``, a CUDA tensor to the kernel (or the call raises).

Widths: every width the nets' configs reach. Cout runs in chunks of
``chunk_channels(Cout)`` output channels, Cout padded to a multiple of 8
with zero weights and bias and stored unpadded (curve_iters 4's head is 12
channels); an input group whose width is not a multiple of 8 (a
``curve_features`` of 20) is copied once, zero-padded, since TMA reads
16-byte strides. The bf16 form takes any Cin: past one chunk's weights
beside a ring of halo rows it streams the weights by group of input pieces
(``_check_kernel_shapes``).
"""

from __future__ import annotations

import threading
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    _check_cuda_tensor,
    _raise_on,
)

ACTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "none": lambda y: y,
    "relu": torch.relu,
    "leaky": lambda y: torch.where(y >= 0, y, y * 0.2),
    "tanh": torch.tanh,
}
_ACT_CODE = {"none": 0, "relu": 1, "leaky": 2, "tanh": 3}
# the kernel's channel step (one 16-byte bf16 read) and its widest chunk of
# output channels (a consumer's accumulators: 64 registers a thread)
CIN_STEP = 8
MAX_CHUNK = 64
_DTYPES = (torch.bfloat16, torch.float32)


def conv3x3_plain(xs: Sequence[torch.Tensor], w: torch.Tensor,
                  b: torch.Tensor, act: str,
                  dilation: int = 1) -> torch.Tensor:
    """Plain version of K6: the NHWC groups ``xs`` concatenated, ``w``
    (Cout, Cin, 3, 3) rounded to their dtype, both upcast to f32, a SAME
    conv in f32, + the f32 bias, the activation, one cast back."""
    x = torch.cat(list(xs), dim=-1) if len(xs) > 1 else xs[0]
    dt = x.dtype
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), w.to(dt).float(),
                 padding=dilation, dilation=dilation)
    y = ACTS[act](y + b.float()[:, None, None])
    return y.to(dt).permute(0, 2, 3, 1).contiguous()


# (ids of the source tensors, dtype, form) -> (weak references, their
# versions, the packed tensors); an entry goes when a source tensor is freed
_PACKED: Dict[Tuple, Tuple] = {}
_PACKED_LOCK = threading.Lock()


def packed_params(sources: Sequence[torch.Tensor], dtype: torch.dtype,
                  pack: Callable[[], Tuple[torch.Tensor, ...]],
                  form: str = "direct"):
    """``pack()``'s tensors, built once per parameter set, dtype and
    ``form`` (the layout a kernel reads: ``"direct"`` for the CUDA-core
    layer, ``"wgmma (groups)"`` for the tensor-core one, ``"cascade"`` for
    K7): the cache is keyed on the source tensors themselves and refreshed
    if one of them was changed in place."""
    key = (tuple(id(t) for t in sources), dtype, form)
    versions = tuple(t._version for t in sources)
    with _PACKED_LOCK:
        hit = _PACKED.get(key)
        if hit is not None and hit[1] == versions \
                and all(r() is t for r, t in zip(hit[0], sources)):
            return hit[2]
        refs = tuple(weakref.ref(t, lambda _, k=key: _PACKED.pop(k, None))
                     for t in sources)
        packed = pack()
        _PACKED[key] = (refs, versions, packed)
        return packed


def padded(c: int) -> int:
    """c channels rounded up to the kernels' step of 8."""
    return -(-c // CIN_STEP) * CIN_STEP


def chunk_channels(cout: int) -> int:
    """The output channels the kernels run at a time for a layer of
    ``cout``: the widest multiple of 8 up to 64 that divides
    ``padded(cout)`` (csrc/mxu_conv.cu takes it as ``nc``)."""
    c8 = padded(cout) // CIN_STEP
    return CIN_STEP * max(d for d in range(1, MAX_CHUNK // CIN_STEP + 1)
                          if c8 % d == 0)


def _pad_weights(w: torch.Tensor, groups: Sequence[int]) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (padded(Cout), sum of padded(groups), 3, 3):
    zero output rows past Cout and zero input channels past each group's
    width, as the kernels see the padded tensors."""
    parts, start = [], 0
    for c in groups:
        parts.append(F.pad(w[:, start:start + c],
                           (0, 0, 0, 0, 0, padded(c) - c)))
        start += c
    wp = torch.cat(parts, 1) if len(parts) > 1 else parts[0]
    return F.pad(wp, (0, 0, 0, 0, 0, 0, 0, padded(w.shape[0]) - w.shape[0]))


def pack_conv_weights(w: torch.Tensor, dtype: torch.dtype,
                      groups: Sequence[int] = ()) -> torch.Tensor:
    """(Cout, Cin, 3, 3) with Cin the concat of ``groups`` (one group by
    default) -> the CUDA-core kernel's f32 (9, Cin', Cout'), tap-major (dy,
    dx), each value rounded to ``dtype`` first; Cin' and Cout' padded to
    multiples of 8 with zeros (``_pad_weights``)."""
    wp = _pad_weights(w.detach().to(dtype).float(),
                      tuple(groups) or (w.shape[1],))
    cout, cin = wp.shape[:2]
    return wp.permute(2, 3, 1, 0).reshape(9, cin, cout).contiguous()


def piece_channels(c: int) -> int:
    """The channels of one piece of a c-channel input group in the
    tensor-core kernel: the narrowest swizzle row (32, 64 or 128 bytes of
    bf16) that holds the group, 64 channels at most."""
    return 16 if c <= 16 else 32 if c <= 32 else 64


def pack_conv_weights_wgmma(w: torch.Tensor, groups: Sequence[int],
                            nc: Optional[int] = None) -> torch.Tensor:
    """(Cout, Cin, 3, 3) with Cin the concat of ``groups`` -> the
    tensor-core kernel's bf16 B operand, (9 * chunks, ...): Cout padded to
    a multiple of 8 with zero rows and cut into chunks of ``nc`` channels
    (default ``chunk_channels(Cout)``); for each chunk, each tap (dy, dx)
    and each piece of each group (``piece_channels`` wide, zeros past the
    group's width), an NC x CP K-major matrix, an output channel's CP
    inputs one row of 2 * CP bytes, its 16-byte chunks XORed with bits
    7-9 of their byte offset (the 32/64/128-byte swizzle the kernel's
    descriptors name), each matrix starting on a 1024-byte boundary
    (csrc/conv3x3_wgmma.cuh plan())."""
    cout = w.shape[0]
    nc = nc or chunk_channels(cout)
    wt = w.detach().to(torch.bfloat16)
    wt = F.pad(wt, (0, 0, 0, 0, 0, 0, 0, padded(cout) - cout))
    chunks = []
    for n0 in range(0, padded(cout), nc):
        mats = []
        start = 0
        for c in groups:
            cp = piece_channels(c)
            for c0 in range(0, c, cp):
                cw = min(cp, c - c0)
                m = F.pad(wt[n0:n0 + nc, start + c0:start + c0 + cw],
                          (0, 0, 0, 0, 0, cp - cw))
                m = m.permute(2, 3, 0, 1).reshape(9, nc * cp)
                # element e of the row-major (NC, CP) matrix lies at byte
                # 2e: its 16-byte chunk is XORed with bits 7.. of the byte
                # offset
                e = torch.arange(nc * cp, device=w.device)
                flat = torch.empty_like(m)
                flat[:, e ^ (((e >> 6) & (cp // 8 - 1)) << 3)] = m
                span = -(-nc * cp // 512) * 512  # 1024 bytes
                mats.append(F.pad(flat, (0, span - nc * cp)))
            start += c
        chunks.append(torch.cat(mats, 1))
    return torch.cat(chunks, 0).contiguous()


def _check_layer(xs: Sequence[torch.Tensor], w: torch.Tensor,
                 b: torch.Tensor, act: str, dilation: int) -> None:
    if not 1 <= len(xs) <= 2:
        raise ValueError(f"one or two input groups, got {len(xs)}")
    x0 = xs[0]
    if x0.ndim != 4 or 0 in x0.shape:
        raise ValueError(f"expected NHWC (B,H,W,C), got {tuple(x0.shape)}")
    for x in xs[1:]:
        if x.shape[:3] != x0.shape[:3] or x.dtype != x0.dtype \
                or x.device != x0.device:
            raise ValueError("the input groups differ in shape, dtype or "
                             "device")
    if x0.dtype not in _DTYPES:
        raise ValueError(f"activations are bf16 or f32, got {x0.dtype}")
    cin = sum(x.shape[-1] for x in xs)
    if w.ndim != 4 or w.shape[1:] != (cin, 3, 3) \
            or tuple(b.shape) != (w.shape[0],):
        raise ValueError(f"expected w (Cout,{cin},3,3) and b (Cout,), got "
                         f"{tuple(w.shape)} {tuple(b.shape)}")
    if w.device != x0.device or b.device != x0.device:
        raise ValueError("activations and parameters lie on different "
                         "devices")
    if act not in ACTS:
        raise ValueError(f"act must be one of {tuple(ACTS)}: {act!r}")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1: {dilation}")


def _check_kernel_shapes(lib, cins: Sequence[int], cout: int,
                         dilation: int, bf16: bool) -> int:
    """The chunk width the kernel runs the layer at (for bf16 the library's
    ``llie_conv_plan``, for f32 ``chunk_channels``). The bf16 form takes
    every width: past what one chunk's weights beside a ring of halo rows
    leave room for (Cin > 1024, or 14 pieces of 64 channels at dilation 64
    and more) it streams the weights of one piece group at a time. It
    raises only where not even one 64-channel piece's halo rows and weights
    fit 227 KB of shared memory, which no 3x3 layer reaches."""
    if not bf16:
        return chunk_channels(cout)
    ca, cb = (padded(c) for c in (tuple(cins) + (0,))[:2])
    nc = lib.llie_conv_plan(ca, cb, cout, dilation)
    if nc == 0:
        raise ValueError(
            f"the bf16 conv kernel found no plan in 227 KB of shared memory "
            f"for groups {tuple(cins)} -> {cout} at dilation {dilation}")
    return nc


def _check_aligned(t: torch.Tensor) -> None:
    _check_cuda_tensor(t)
    if t.data_ptr() % 16:
        raise ValueError("the conv kernel reads 16-byte aligned tensors")


def _conv3x3(xs, w, b, act, dilation, counter):
    """The layer on the input's device; a launch counts on ``counter``, the
    wrapper that was called."""
    if xs[0].device.type == "cpu":
        return conv3x3_plain(xs, w, b, act, dilation)
    lib = _build.load_library()
    x0 = xs[0]
    dt = x0.dtype
    bf16 = dt == torch.bfloat16
    groups = tuple(x.shape[-1] for x in xs)
    cout = w.shape[0]
    # a group of a width off the step of 8: one zero-padded copy
    xs = tuple(x if padded(x.shape[-1]) == x.shape[-1]
               else F.pad(x, (0, padded(x.shape[-1]) - x.shape[-1]))
               for x in xs)
    for x in xs:
        _check_aligned(x)
    nc = _check_kernel_shapes(lib, groups, cout, dilation, bf16)
    bsz, h, wd, ca = xs[0].shape
    xb, cb = (xs[1], xs[1].shape[-1]) if len(xs) > 1 else (None, 0)
    wk, bk = packed_params(
        (w, b), dt,
        lambda: (pack_conv_weights_wgmma(w, groups, nc) if bf16
                 else pack_conv_weights(w, dt, groups),
                 F.pad(b.detach().float(), (0, padded(cout) - cout))),
        form=f"wgmma {groups} {nc}" if bf16 else f"direct {groups}")
    out = torch.empty((bsz, h, wd, cout), dtype=dt, device=x0.device)
    with torch.cuda.device(x0.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.llie_conv3x3(
            xs[0].data_ptr(), ca, None if xb is None else xb.data_ptr(), cb,
            wk.data_ptr(), bk.data_ptr(), out.data_ptr(), cout, nc, bsz, h,
            wd, dilation, _ACT_CODE[act],
            int(bf16), stream)
    _raise_on(rc, lib, "conv3x3")
    counter.launches += 1
    return out


def conv2d_patch_mxu(xs: Sequence[torch.Tensor], w: torch.Tensor,
                     b: torch.Tensor, *, act: str = "none") -> torch.Tensor:
    """K6a: one dilation-1 3x3 SAME conv layer on NHWC groups ``xs`` (one
    tensor, or two read as their channel concat) -> (B, H, W, Cout) in
    their dtype. ``w`` (Cout, Cin, 3, 3) and ``b`` (Cout,) are the net's
    parameters; their packed form is cached per parameter set."""
    xs = tuple(xs)
    _check_layer(xs, w, b, act, 1)
    return _conv3x3(xs, w, b, act, 1, conv2d_patch_mxu)


conv2d_patch_mxu.launches = 0


def conv2d_dense9_mxu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                      act: str = "none", dilation: int = 1) -> torch.Tensor:
    """K6b: one 3x3 SAME conv layer at ``dilation`` (1 or even, as the fcn
    stack has them) on NHWC ``x`` -> (B, H, W, Cout) in its dtype."""
    if dilation != 1 and dilation % 2:
        raise ValueError(f"dilation must be 1 or even, got {dilation}")
    _check_layer((x,), w, b, act, dilation)
    return _conv3x3((x,), w, b, act, dilation, conv2d_dense9_mxu)


conv2d_dense9_mxu.launches = 0
