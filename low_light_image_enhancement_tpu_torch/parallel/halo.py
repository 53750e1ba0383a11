"""Halo exchange for spatially sharded windowed filtering.

Each shard owns a contiguous block of image rows. Before it runs the
windowed graph it needs ``margin`` rows of each neighbour; at the image's
top and bottom it needs its own edge row replicated instead. That rebuilds
exactly the rows of the single-device padded canvas, so the sharded output
equals the single-device output.

The exchange is a copy of a neighbour's boundary rows onto the shard's
device (``Tensor.to``): a peer copy between two cards, a plain copy on one.
``Tensor.to`` orders the copy after the work queued on the source device's
current stream and before the work queued after it on the destination's,
so no synchronisation is needed around it.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

__all__ = ["halo_pad"]


def _replicate(row: torch.Tensor, margin: int) -> torch.Tensor:
    return row.expand(*row.shape[:-2], margin, row.shape[-1])


def halo_pad(shards: Sequence[torch.Tensor],
             margin: int) -> List[torch.Tensor]:
    """Row blocks ``(..., Hl, W)`` in image order, each on its shard's
    device -> each as a contiguous ``(..., Hl + 2*margin, W)`` on the same
    device: the
    neighbours' rows inside the image, the shard's own edge row replicated
    at the image's top and bottom (``F.pad(mode="replicate")``). A single
    shard only replicates. Raises when a shard of several holds fewer rows
    than ``margin``."""
    n = len(shards)
    if n == 0:
        raise ValueError("halo_pad needs at least one shard")
    if margin < 0:
        raise ValueError(f"margin must be >= 0, got {margin}")
    if n > 1:
        short = [tuple(s.shape) for s in shards if s.shape[-2] < margin]
        if short:
            raise ValueError(
                f"shards of {short} rows hold fewer rows than the "
                f"{margin}-row halo; use fewer shards or larger frames")
    if margin == 0:
        return [s.contiguous() for s in shards]
    out = []
    for i, x in enumerate(shards):
        hl = x.shape[-2]
        if i == 0:
            top = _replicate(x[..., :1, :], margin)
        else:
            prev = shards[i - 1]
            top = prev[..., prev.shape[-2] - margin:, :].to(
                x.device, non_blocking=True)
        if i == n - 1:
            bottom = _replicate(x[..., hl - 1:, :], margin)
        else:
            bottom = shards[i + 1][..., :margin, :].to(x.device,
                                                       non_blocking=True)
        out.append(torch.cat([top, x, bottom], dim=-2).contiguous())
    return out
