"""Halo exchange for spatially sharded windowed filtering.

Each shard owns a contiguous block of image rows. Before it runs the
windowed graph it needs ``margin`` rows of each neighbour; at the image's
top and bottom it needs its own edge row replicated instead. That rebuilds
exactly the rows of the single-device padded canvas, so the sharded output
equals the single-device output.

Inside a process the exchange is a copy of a neighbour's boundary rows
onto the shard's device (``Tensor.to``): a peer copy between two cards, a
plain copy on one. ``Tensor.to`` orders the copy after the work queued on
the source device's current stream and before the work queued after it on
the destination's, so no synchronisation is needed around it. Between
processes (a mesh whose spatial axis spans a process group) the rows at
each seam cross the group (``exchange_seams``): on NCCL as device tensors,
on gloo through host copies, since gloo sends host tensors only.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

__all__ = ["halo_pad", "exchange_seams"]


def _replicate(row: torch.Tensor, margin: int) -> torch.Tensor:
    return row.expand(*row.shape[:-2], margin, row.shape[-1])


def halo_pad(shards: Sequence[torch.Tensor], margin: int,
             above: Optional[torch.Tensor] = None,
             below: Optional[torch.Tensor] = None) -> List[torch.Tensor]:
    """Row blocks ``(..., Hl, W)`` in image order, each on its shard's
    device -> each as a contiguous ``(..., Hl + 2*margin, W)`` on the same
    device: the
    neighbours' rows inside the image, the shard's own edge row replicated
    at the image's top and bottom (``F.pad(mode="replicate")``). A single
    shard only replicates. ``above``/``below``: the ``margin`` rows that
    lie above the first shard and below the last, where those are another
    process's (``exchange_seams``). Raises when a shard of several holds
    fewer rows than ``margin``."""
    n = len(shards)
    if n == 0:
        raise ValueError("halo_pad needs at least one shard")
    if margin < 0:
        raise ValueError(f"margin must be >= 0, got {margin}")
    if n > 1 or above is not None or below is not None:
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
            top = _replicate(x[..., :1, :], margin) if above is None \
                else above.to(x.device, non_blocking=True)
        else:
            prev = shards[i - 1]
            top = prev[..., prev.shape[-2] - margin:, :].to(
                x.device, non_blocking=True)
        if i == n - 1:
            bottom = _replicate(x[..., hl - 1:, :], margin) if below is None \
                else below.to(x.device, non_blocking=True)
        else:
            bottom = shards[i + 1][..., :margin, :].to(x.device,
                                                       non_blocking=True)
        out.append(torch.cat([top, x, bottom], dim=-2).contiguous())
    return out


def exchange_seams(rows: torch.Tensor, margin: int, process: int,
                   processes: int, comm_device
                   ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """This process's rows ``(..., R, W)`` of a mesh that spans
    ``processes`` processes -> (the ``margin`` rows above them, the
    ``margin`` rows below them) on ``rows``' device: the previous process's
    last rows and the next one's first, or None at the image's top and
    bottom. Each process sends its first rows back and its last rows on in
    one ``dist.batch_isend_irecv``; the tensors cross the group on
    ``comm_device`` (the card on NCCL, the host on gloo)."""
    import torch.distributed as dist

    if rows.shape[-2] < margin:
        raise ValueError(f"{rows.shape[-2]} rows hold fewer rows than the "
                         f"{margin}-row halo")
    shape = rows.shape[:-2] + (margin, rows.shape[-1])
    ops, above, below = [], None, None
    if process > 0:
        above = torch.empty(shape, dtype=rows.dtype, device=comm_device)
        ops += [dist.P2POp(dist.isend, rows[..., :margin, :].to(
                    comm_device).contiguous(), process - 1),
                dist.P2POp(dist.irecv, above, process - 1)]
    if process < processes - 1:
        below = torch.empty(shape, dtype=rows.dtype, device=comm_device)
        ops += [dist.P2POp(dist.isend, rows[..., rows.shape[-2] - margin:, :]
                           .to(comm_device).contiguous(), process + 1),
                dist.P2POp(dist.irecv, below, process + 1)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return tuple(None if t is None else t.to(rows.device)
                 for t in (above, below))
