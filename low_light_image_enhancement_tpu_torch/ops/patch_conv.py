"""Space-to-depth conv forms of the nets' 3x3 convs: the ``conv_impl``
arms ``gemm``, ``packed`` and ``packed12`` (the JAX package's
``ops/patch_conv.py``, function for function).

The JAX package built these to fill the TPU's 128-lane matrix unit at the
nets' widths of 24-32 channels. On the card they are plain PyTorch, as
they are plain jnp there (no Pallas kernel computes them): GEMMs of patch
slabs (``torch.matmul``) and one ``F.conv2d`` a layer on packed lanes.

Layouts are the JAX package's: activations NHWC ``(B, H, W, C)``, packed
``(B, H/bh, W/bw, bh*bw*C)`` with feature index ``p*C + c`` (phase-major,
``p = py*bw + px``; ``F.pixel_unshuffle`` is channel-major, ``c*4 + p``,
and not the same). The conv weights come in the port's layout, ``(Cout,
Cin, 3, 3)``; the GEMM slabs the packers return are the JAX package's
exactly, and the block conv's weights are ``(P*Cout, P*Cin, 3, 3)``, the
JAX package's ``(3, 3, P*Cin, P*Cout)`` in ``F.conv2d``'s order.

Arithmetic, as there:

- ``conv2d_patch_gemm`` and ``conv2d_im2col_gemm`` multiply the operands
  rounded to the compute dtype with a float32 result (each bf16 product is
  exact in f32), sum the GEMMs in f32, add the f32 bias, then cast once;
- ``conv2d_block_xla`` is one conv in the compute dtype, then the bias
  added in the compute dtype.

The packers build the structural zeros as exact zeros. ``cached_pack``
keeps a packed weight set per parameter tensor, dtype and form, as
``kernels.mxu_conv.packed_params`` does for K6, since the nets call the
packers on every call (the JAX package packs inside ``jit``).
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from low_light_image_enhancement_tpu_torch.kernels.mxu_conv import (
    packed_params,
)

__all__ = ["space_to_depth", "depth_to_space", "pack_patch_weights",
           "pack_bias", "patch_slab", "conv2d_patch_gemm",
           "pack_im2col_weights", "conv2d_im2col_gemm",
           "pack_block_conv_weights", "conv2d_block_xla", "even_image",
           "cached_pack"]

# Patch row/col offsets, in order, relative to the output block origin.
_OFFS = (-1, 0, 1, 2)


def _as_dtype(compute_dtype) -> torch.dtype:
    """The config's ``"bfloat16"``/``"float32"``, or a torch dtype (the
    nets import this module, so it takes nothing from ``models``)."""
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


def space_to_depth(x: torch.Tensor,
                   block: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/bh, W/bw, bh*bw*C), feature index
    (py*bw+px)*C + c. ``block=(1, 2)`` packs the columns alone."""
    bh, bw = block
    b, h, w, c = x.shape
    if h % bh or w % bw:
        raise ValueError(f"space_to_depth{block} needs H%{bh}==W%{bw}==0; "
                         f"got {h}x{w}")
    x = x.reshape(b, h // bh, bh, w // bw, bw, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h // bh, w // bw,
                                               bh * bw * c)


def depth_to_space(x: torch.Tensor,
                   block: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """Inverse of :func:`space_to_depth`."""
    bh, bw = block
    b, h2, w2, cp = x.shape
    c = cp // (bh * bw)
    x = x.reshape(b, h2, w2, bh, bw, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, bh * h2, bw * w2, c)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the JAX package's (3, 3, Cin, Cout) view."""
    return w.permute(2, 3, 1, 0)


def pack_patch_weights(w: torch.Tensor,
                       groups: Sequence[int] = ()) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (4, 4*Cin, 4*Cout) patch-GEMM slabs.

    Slab ``i`` multiplies the patch row at offset ``_OFFS[i]``; its rows
    run (ox, group, cin-within-group) with ox over ``_OFFS``, as
    :func:`patch_slab` lays the patch out, and its columns (qy*2+qx)*Cout
    + cout, the packed output. ``groups``: the channel widths of an input
    that is a concat of packed tensors (the curve CNN's skips). Taps
    outside the 3x3 window are zeros."""
    w = _hwio(w)
    _, _, cin, cout = w.shape
    groups = tuple(groups) or (cin,)
    if sum(groups) != cin:
        raise ValueError(f"groups {groups} do not sum to Cin {cin}")
    zeros = w.new_zeros((cin, cout))
    rows_per_oy = []
    for oy in _OFFS:
        blocks = []   # one (cin, 4*cout) block per ox; cin runs the groups
        for ox in _OFFS:  # in order, as the slab's (group, cin) does
            cols = []
            for qy in range(2):
                for qx in range(2):
                    dy, dx = oy - qy, ox - qx
                    cols.append(w[dy + 1, dx + 1]
                                if dy in (-1, 0, 1) and dx in (-1, 0, 1)
                                else zeros)
            blocks.append(torch.cat(cols, dim=1))
        rows_per_oy.append(torch.cat(blocks, dim=0))
    return torch.stack(rows_per_oy)


def pack_bias(b: torch.Tensor, phases: int = 4) -> torch.Tensor:
    """(Cout,) -> (phases*Cout,): the bias repeated for each output
    phase."""
    return b.repeat(phases)


def _shifted(xpad: torch.Tensor, by: int, bx: int, h: int,
             w: int) -> torch.Tensor:
    """x[:, Y+by, X+bx] with zeros outside (SAME), read from x (B, h, w,
    C) zero-padded by as many rows and columns on each side as ``xpad``'s
    shape says."""
    py = (xpad.shape[1] - h) // 2
    px = (xpad.shape[2] - w) // 2
    return xpad[:, py + by:py + by + h, px + bx:px + bx + w]


def patch_slab(xp: torch.Tensor, oy: int,
               groups: Sequence[int]) -> torch.Tensor:
    """The patch row at offset ``oy`` gathered from packed input(s).

    ``xp``: packed (B, H2, W2, 4*Cin), Cin = sum(groups), the features
    [group blocks, each phase-major] (a concat of packed tensors).
    Returns (B, H2, W2, 4*Cin) laid out (ox, group, cin)."""
    by, py = divmod(oy, 2)
    h2, w2 = xp.shape[1], xp.shape[2]
    cum = np.cumsum((0,) + tuple(groups))
    xpad = F.pad(xp, (0, 0, 1, 1, 1, 1))
    slabs = []
    for ox in _OFFS:
        bx, px = divmod(ox, 2)
        p = py * 2 + px
        for g, c in enumerate(groups):
            base = 4 * int(cum[g])
            plane = xpad[..., base + p * c:base + (p + 1) * c]
            slabs.append(_shifted(plane, by, bx, h2, w2))
    return torch.cat(slabs, dim=-1)


def _gemm_f32(slab: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., K) @ (K, N) of operands already rounded to their dtype, with
    a float32 result: each product exact in f32, the sum in f32 (the JAX
    package's ``preferred_element_type=float32``)."""
    return torch.matmul(slab.float(), w.float())


def conv2d_patch_gemm(xp: torch.Tensor, wp: torch.Tensor, bp: torch.Tensor,
                      compute_dtype,
                      groups: Sequence[int] = ()) -> torch.Tensor:
    """Packed 3x3 SAME conv as four accumulated GEMMs.

    xp: (B, H2, W2, 4*Cin) packed input (phase-major per group).
    wp: (4, 4*Cin, 4*Cout) from :func:`pack_patch_weights`.
    bp: (4*Cout,) from :func:`pack_bias`.
    Returns packed (B, H2, W2, 4*Cout) in ``compute_dtype``."""
    cd = _as_dtype(compute_dtype)
    groups = tuple(groups) or (xp.shape[-1] // 4,)
    acc = None
    for i, oy in enumerate(_OFFS):
        term = _gemm_f32(patch_slab(xp, oy, groups).to(cd), wp[i].to(cd))
        acc = term if acc is None else acc + term
    return (acc + bp.float()).to(cd)


def pack_im2col_weights(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (9*Cin, Cout), rows (dy, dx, cin)."""
    return _hwio(w).reshape(-1, w.shape[0])


def conv2d_im2col_gemm(x: torch.Tensor, w9: torch.Tensor, b: torch.Tensor,
                       compute_dtype, dilation: int = 1) -> torch.Tensor:
    """Unpacked 3x3 SAME conv (any dilation) as three accumulated GEMMs,
    one a patch row: x (B, H, W, Cin), w9 (9*Cin, Cout) from
    :func:`pack_im2col_weights`."""
    cd = _as_dtype(compute_dtype)
    cin = x.shape[-1]
    h, w = x.shape[1], x.shape[2]
    d = dilation
    xpad = F.pad(x, (0, 0, d, d, d, d))
    acc = None
    for r, dy in enumerate((-d, 0, d)):
        slab = torch.cat([_shifted(xpad, dy, dx, h, w) for dx in (-d, 0, d)],
                         dim=-1).to(cd)
        term = _gemm_f32(slab, w9[3 * r * cin:3 * (r + 1) * cin].to(cd))
        acc = term if acc is None else acc + term
    return (acc + b.float()).to(cd)


def _axis_tap(t: int, p: int, q: int, block: int, dilation: int):
    """The original weight's tap along one axis for packed tap ``t`` and
    (in, out) phases ``p, q`` under ``block``-packing with ``dilation``,
    or None where that combination is a structural zero.

    block 1: the axis is unpacked; the packed conv dilates by ``dilation``
    and tap t maps straight through. block > 1, dilation 1: cross-phase
    routing, the original offset block*t + p - q must fall in the 3x3
    window. block > 1, dilation % block == 0: taps keep the phase and the
    packed conv dilates by ``dilation // block``."""
    if block == 1:
        return t
    if dilation == 1:
        d = block * t + p - q
        return d if d in (-1, 0, 1) else None
    if dilation % block == 0:
        return t if p == q else None
    raise ValueError(
        f"dilation {dilation} incompatible with block {block}: need 1, "
        f"block==1, or dilation % block == 0")


def pack_block_conv_weights(w: torch.Tensor, groups: Sequence[int] = (),
                            dilation: int = 1,
                            block: Tuple[int, int] = (2, 2)) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> (P*Cout, P*Cin, 3, 3) weights of a 3x3 conv
    over packed activations, P = bh*bw phases: tap (by, bx) is a block
    shift and its (P*Cin, P*Cout) matrix routes input phases to output
    phases (:func:`_axis_tap`). Input channels run [group][phase][ci], as
    a concat of packed tensors; output channels output-phase-major, as
    :func:`depth_to_space` reads them."""
    wh = _hwio(w)
    _, _, cin, cout = wh.shape
    bh, bw = block
    n_p = bh * bw
    groups = tuple(groups) or (cin,)
    if sum(groups) != cin:
        raise ValueError(f"groups {groups} do not sum to Cin {cin}")
    cum = np.cumsum((0,) + groups)
    taps = []
    for by in (-1, 0, 1):
        row = []
        for bx in (-1, 0, 1):
            rblocks = []
            for g, cg in enumerate(groups):
                sl = slice(int(cum[g]), int(cum[g]) + cg)
                for p in range(n_p):
                    py, px = divmod(p, bw)
                    cols = []
                    for q in range(n_p):
                        qy, qx = divmod(q, bw)
                        dy = _axis_tap(by, py, qy, bh, dilation)
                        dx = _axis_tap(bx, px, qx, bw, dilation)
                        cols.append(wh[dy + 1, dx + 1, sl]
                                    if dy is not None and dx is not None
                                    else wh.new_zeros((cg, cout)))
                    rblocks.append(torch.cat(cols, dim=1))
            row.append(torch.cat(rblocks, dim=0))
        taps.append(torch.stack(row))
    return torch.stack(taps).permute(3, 2, 0, 1).contiguous()


def conv2d_block_xla(xp: torch.Tensor, wk: torch.Tensor, b: torch.Tensor,
                     compute_dtype, step=1) -> torch.Tensor:
    """Packed 3x3 SAME conv as one ``F.conv2d`` on space-to-depth lanes.

    xp: (B, Hb, Wb, P*Cin) packed; wk: (P*Cout, P*Cin, 3, 3) from
    :func:`pack_block_conv_weights`; step: the packed conv's dilation, 1
    for dilation 1, d//block on each axis for an even dilation d (an int or
    (step_y, step_x)). Zero padding on blocks is the original conv's SAME
    padding (out-of-window pixels meet structural zeros). Returns packed
    (B, Hb, Wb, P*Cout) in ``compute_dtype``, the bias added in it."""
    cd = _as_dtype(compute_dtype)
    steps = (step, step) if isinstance(step, int) else tuple(step)
    phases = wk.shape[0] // b.shape[0]
    y = F.conv2d(xp.permute(0, 3, 1, 2).to(cd), wk.to(cd), padding=steps,
                 dilation=steps)
    return y.permute(0, 2, 3, 1) + pack_bias(b, phases).to(cd)


def even_image(h: int, w: int) -> Tuple[int, int]:
    """(h, w) rounded up to even: the packed layout's only shape demand."""
    return h + (h % 2), w + (w % 2)


def cached_pack(sources: Sequence[torch.Tensor], dtype, form: str,
                pack: Callable[[], torch.Tensor]) -> torch.Tensor:
    """``pack()`` cast to ``dtype``, built once per parameter set, dtype
    and ``form`` (``kernels.mxu_conv.packed_params``: keyed on the source
    tensors, so on their device, and rebuilt when one is changed in place).
    Where a gradient may flow to a source, it is packed on every call, so
    autograd sees the packing."""
    cd = _as_dtype(dtype)
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return pack().to(cd)
    return packed_params(sources, cd, lambda: (pack().to(cd),),
                         form=form)[0]
