"""Plain reference of the Zero-DCE configuration (Guo et al., CVPR 2020,
arXiv:2001.06826, section 3.2): the DCE-Net, seven 3x3 convs with ReLU and
symmetric skip concatenations (c5 takes c3 and c4, c6 takes c2 and c5, c7
takes c1 and c6) and a tanh head of 3 * n_iter curve maps, then n_iter
LE-curve steps x + a x (1 - x), then the luma-guided separable bilateral
and quantization to u8.

Geometry, as the JAX package's pure path lays the image out: a block with
``halo`` edge-replicated rows above and below and ``m`` columns before the
image, its width rounded up to 128; the net reads the block zeroed outside
the image extended by ``m``, with zero padding at the block's edges; the
curves and the bilateral run on the window of the image's rows extended by
``m`` (wrap-around shifts), then the image is cropped out.

The reference computes the net in float32 (TF32 off, which the caller
sets) and the rest in float32. The control computes the net's convs on
float8 e4m3 operands (scaled per tensor by its largest magnitude, sums and
outputs in bfloat16) and the rest in bfloat16: one step below the
configuration's bfloat16 net and float32 tail."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.common import (
    bilateral,
    normalize,
    pad_edge,
    quantize,
)

F8_MAX = 448.0


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 after scaling its largest magnitude to
    the format's largest value, scaled back, in bfloat16."""
    scale = F8_MAX / torch.clamp(t.abs().amax().float(), min=1e-12)
    q = (t.float() * scale).to(torch.float8_e4m3fn).float()
    return (q / scale).to(torch.bfloat16)


def curve_maps(x: torch.Tensor, params: dict, n_iter: int,
               control: bool) -> torch.Tensor:
    """(B, 3, H, W) f32 -> f32 maps (B, n_iter, 3, H, W)."""
    cd = torch.bfloat16 if control else torch.float32

    def cv(name, h):
        w, b = params[name]["w"], params[name]["b"]
        if control:
            h, w = _fp8(h), _fp8(w)
        y = F.conv2d(h.to(cd), w.to(cd), None, padding=1)
        return y + b.to(cd)[:, None, None]

    x1 = torch.relu(cv("c1", x))
    x2 = torch.relu(cv("c2", x1))
    x3 = torch.relu(cv("c3", x2))
    x4 = torch.relu(cv("c4", x3))
    x5 = torch.relu(cv("c5", torch.cat([x3, x4], dim=1)))
    x6 = torch.relu(cv("c6", torch.cat([x2, x5], dim=1)))
    a = torch.tanh(cv("c7", torch.cat([x1, x6], dim=1))).float()
    b, _, hh, ww = a.shape
    return a.reshape(b, n_iter, 3, hh, ww)


def enhance(x_u8: torch.Tensor, p: dict, params: dict,
            control: bool = False) -> torch.Tensor:
    """(B, H, W, 3) u8 -> (B, H, W, 3) u8."""
    if p.get("curve_downsample", 1) != 1:
        raise NotImplementedError("the reference runs the net at full "
                                  "resolution")
    tail = torch.bfloat16 if control else torch.float32
    _, h, w, _ = x_u8.shape
    m, halo = 4, 8
    h_core, wp = _round_up(h, 8), _round_up(w + 2 * m, 128)
    xb = pad_edge(x_u8.permute(0, 3, 1, 2), halo, halo + h_core - h, m,
                  wp - w - m)
    hb = xb.shape[-2]
    g = torch.arange(hb, device=xb.device) - halo
    keep = (((g >= -m) & (g < h + m))[:, None]
            & (torch.arange(wp, device=xb.device) < w + 2 * m)[None, :])
    net_in = torch.where(keep, normalize(xb, torch.float32),
                         torch.zeros((), device=xb.device))
    maps = curve_maps(net_in, params, p["curve_iters"], control)
    win = slice(halo - m, halo + h_core + m)
    y = normalize(xb[..., win, :], tail)
    for a in maps[..., win, :].to(tail).unbind(1):
        y = y + a * y * (1.0 - y)
    y = bilateral(torch.clamp(y, 0.0, 1.0), p)
    return quantize(y[..., m:m + h, m:m + w]).permute(0, 2, 3, 1) \
        .contiguous()
