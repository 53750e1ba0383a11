"""Inputs and weights made from the run's seed, on the run's device, in a
few large calls: the same seed on the same device gives the same tensors.
Both the program and the reference are handed these."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def low_light(gen: torch.Generator, n: int, h: int, w: int,
              device) -> torch.Tensor:
    """(n, h, w, 3) u8 dark photos: a smooth random scene (a field at
    1/16 resolution, upsampled) with texture, at an exposure of 4-25% of
    full scale, plus sensor noise."""
    lo = torch.rand((n, 3, h // 16 + 2, w // 16 + 2), generator=gen,
                    device=device)
    scene = F.interpolate(lo, size=(h, w), mode="bilinear",
                          align_corners=False)
    texture = torch.rand((n, 1, h, w), generator=gen, device=device)
    exposure = 0.04 + 0.21 * torch.rand((n, 1, 1, 1), generator=gen,
                                        device=device)
    noise = 0.01 * torch.randn((n, 3, h, w), generator=gen, device=device)
    img = scene * (0.75 + 0.25 * texture) * exposure + noise
    u8 = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(torch.uint8)
    return u8.permute(0, 2, 3, 1).contiguous()


def net_params(gen: torch.Generator, net: dict, device) -> dict:
    """A net of 3x3 convs, ``net["layers"]`` as (name, cin, cout), in the
    program's layout ({name: {"w": (cout, cin, 3, 3), "b": (cout,)}},
    float32): He-normal weights and N(0, ``bias_std``) biases, drawn in one
    call."""
    layers = net["layers"]
    sizes = [(9 * cin * cout, cout) for _, cin, cout in layers]
    flat = torch.randn(sum(a + b for a, b in sizes), generator=gen,
                       device=device)
    out, at = {}, 0
    for (name, cin, cout), (nw, nb) in zip(layers, sizes):
        w = flat[at:at + nw].view(cout, cin, 3, 3) * math.sqrt(2.0 / (9 * cin))
        b = flat[at + nw:at + nw + nb] * net["bias_std"]
        out[name] = {"w": w.contiguous(), "b": b.contiguous()}
        at += nw + nb
    return out
