"""Canvas geometry of the padded planar image.

The JAX package cuts the canvas into halo'd row stripes sized to the TPU's
VMEM; on Hopper the kernels tile in 2-D with their own halos, so only the
geometry the API exposes carries over: ``margin`` replicate rows/cols before
the image origin, rows rounded up to a multiple of 8 and the width to a
multiple of 128. The canvas size never changes a consumed pixel (the wrap
shifts' corruption stays inside the margin).
"""

from __future__ import annotations

from typing import NamedTuple


class CanvasPlan(NamedTuple):
    padded_h: int     # Hp = round_up(h, 8) + 2 * margin
    padded_w: int     # Wp = round_up(w + 2 * margin, 128)
    margin: int


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def plan_canvas(h: int, w: int, margin: int) -> CanvasPlan:
    """The canvas of an ``h`` x ``w`` image: the JAX package's one-stripe
    ``plan_stripes`` geometry."""
    return CanvasPlan(_round_up(h, 8) + 2 * margin,
                      _round_up(w + 2 * margin, 128), margin)
