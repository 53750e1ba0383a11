"""The numerics and the plan of the tile engine (``csrc/retinex_tile.cuh``:
K1, K4 and K3) on the CPU.

The engine's bilateral computes each neighbour pair's range weight once and
uses it at both ends, and the centre's weight once: a model of that in
plain torch, in the kernel's order of operations, is held bit for bit
(``torch.equal``) to ``ops/denoise.py``'s four cores (separable or full,
joint or per channel) under both range kernels. The tile plan
(``llie_retinex_tile_plan``: tile shape, threads, shared memory, plane
pitch, ring column, K3's curve strips, per blur radius and kernel) has its
mirror here,
``tile_plan``; the tests check it for every output size from 1x1 to 1080p,
and ``chip_smoke.py`` holds it equal to the library on the card.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch.ops import denoise
from low_light_image_enhancement_tpu_torch.ops.filters import roll2d

# ------------------------------------------------- the pair-weight model #

INV2S2 = 1.0 / (2.0 * 0.2 * 0.2)   # the default denoise_sigma
STRENGTH = 0.8


def _rw(d2, kind):
    return denoise._range_weight(d2, INV2S2, kind)


def _centre(sp, kind):
    """The centre tap's weight: a zero difference."""
    return sp * _rw(torch.zeros(()) * torch.zeros(()), kind)


def _pair(x, di, dj, sp, kind):
    """The weight of the pair (p, p - (di, dj)) at p; the tap (-di, -dj)
    at p reads the same float at p - (di, dj)."""
    d = roll2d(x, di, dj) - x
    return sp * _rw(d * d, kind)


def _other_end(w, di, dj):
    """w of the pair seen from its other end: w[p + (di, dj)] at p."""
    return roll2d(w, -di, -dj)


def _sep_weights(g, dy, dx, kind):
    """Taps t = -1, 0, 1 of one separable pass on the guide g."""
    w_m1 = _pair(g, -dy, -dx, 0.25, kind)
    return (w_m1, _centre(0.5, kind), _other_end(w_m1, -dy, -dx))


def _full_weights(g, kind):
    """The 9 taps (di, dj), di outer, on the guide g: the first four
    computed, the centre once, the last four the first four's other ends."""
    sp = denoise._SPATIAL_1D
    first = [((di, dj), _pair(g, di, dj, sp[di + 1] * sp[dj + 1], kind))
             for di, dj in ((-1, -1), (-1, 0), (-1, 1), (0, -1))]
    last = [((-di, -dj), _other_end(w, di, dj)) for (di, dj), w in first]
    return first + [((0, 0), _centre(0.25, kind))] + last[::-1]


def model_sep(x, kind):
    """bilateral_sep_core with one range weight a pair."""
    f = x
    for dy, dx in ((1, 0), (0, 1)):
        ws = _sep_weights(f, dy, dx, kind)
        acc = wacc = 0.0
        for t, w in zip((-1, 0, 1), ws):
            acc = acc + w * roll2d(f, t * dy, t * dx)
            wacc = wacc + w
        f = acc / wacc
    return x + STRENGTH * (f - x)


def model_sep_joint(planes, kind):
    """bilateral_sep_joint_core with one range weight a pair."""
    outs = list(planes)
    for dy, dx in ((1, 0), (0, 1)):
        luma = (outs[0] + outs[1] + outs[2]) * (1.0 / 3.0)
        ws = _sep_weights(luma, dy, dx, kind)
        accs, wacc = [0.0] * 3, 0.0
        for t, w in zip((-1, 0, 1), ws):
            wacc = wacc + w
            accs = [a + w * roll2d(p, t * dy, t * dx)
                    for a, p in zip(accs, outs)]
        winv = 1.0 / wacc
        outs = [a * winv for a in accs]
    return [p + STRENGTH * (o - p) for p, o in zip(planes, outs)]


def model_full(x, kind):
    """bilateral_core with one range weight a pair."""
    acc = wacc = 0.0
    for (di, dj), w in _full_weights(x, kind):
        acc = acc + w * roll2d(x, di, dj)
        wacc = wacc + w
    return x + STRENGTH * (acc / wacc - x)


def model_full_joint(planes, kind):
    """bilateral_joint_core with one range weight a pair."""
    luma = (planes[0] + planes[1] + planes[2]) * (1.0 / 3.0)
    accs, wacc = [0.0] * 3, 0.0
    for (di, dj), w in _full_weights(luma, kind):
        wacc = wacc + w
        accs = [a + w * roll2d(p, di, dj) for a, p in zip(accs, planes)]
    winv = 1.0 / wacc
    return [p + STRENGTH * (a * winv - p) for p, a in zip(planes, accs)]


def _image() -> torch.Tensor:
    """(2, 3, 33, 47) in [0, 1]: noise, runs of equal neighbours in rows
    and columns, and clipped 0s and 1s."""
    rng = np.random.default_rng(8)
    x = rng.random((2, 3, 33, 47), dtype=np.float32)
    x[:, :, 5:9, :] = x[:, :, 5:6, :]
    x[:, :, :, 20:24] = x[:, :, :, 20:21]
    x[:, :, 12:15, 30:40] = 0.0
    x[:, :, 25:, :6] = 1.0
    x[0, 1] = np.clip(x[0, 1] * 1.7 - 0.3, 0.0, 1.0)
    return torch.from_numpy(x)


CORES = {
    "sep": (denoise.bilateral_sep_core, model_sep, False),
    "sep_joint": (denoise.bilateral_sep_joint_core, model_sep_joint, True),
    "full": (denoise.bilateral_core, model_full, False),
    "full_joint": (denoise.bilateral_joint_core, model_full_joint, True),
}


@pytest.mark.parametrize("kind", denoise.RANGE_KERNELS)
@pytest.mark.parametrize("core", sorted(CORES))
def test_pair_weights_bit_equal_to_the_cores(core, kind):
    ref_core, model, joint = CORES[core]
    x = _image()
    if joint:
        planes = [x[:, c] for c in range(3)]
        want = torch.stack(ref_core(planes, INV2S2, STRENGTH, roll2d, kind),
                           dim=1)
        got = torch.stack(model(planes, kind), dim=1)
    else:
        want = ref_core(x, INV2S2, STRENGTH, roll2d, kind)
        got = model(x, kind)
    assert torch.equal(got, want)


# ---------------------------------------------------------- the plan ---- #
# Mirror of retinex_tile.cuh's plan (llie_retinex_tile_plan).

TH, TW, NT = 32, 64, 256
YH, YW = TH + 2, TW + 2
OP = 3 * TW // 4 + 1
MAX_BLUR_RADIUS = 8
SMEM_PER_BLOCK = 227 * 1024      # H100: a block's opt-in maximum
SMEM_PER_SM = 228 * 1024         # and an SM's, 1 KB of it kept a block


def grid_off(r: int) -> int:
    return (1 + r + 3) // 4 * 4 - 1 - r


def groups(r: int) -> int:
    return (grid_off(r) + YW + 2 * r + 3) // 4


def pitch(r: int) -> int:
    return 4 * groups(r) + 1


def raw_chunks(r: int) -> int:
    """16-byte chunks of one of K1's raw rows (u8 HWC)."""
    return (12 * groups(r) + 30) // 16


def smem_floats(family: int, r: int, raw: bool = False) -> int:
    p = pitch(r)
    lrows = YH + 2 * r + 2 if r else 0
    blur = (lrows + (3 if family == 1 else 1) * YH) * p
    tail = 3 * TH * p + TH * OP
    planes = 3 * (YH + 1) * p + max(blur, tail)
    if not raw:
        return planes
    return (planes + 3) // 4 * 4 + (YH + 2 * r) * raw_chunks(r) * 4


VS = 12      # rows of K3's curve strips (and of the vertical blur's)


def walk_rows(ds: int, s: int) -> int:
    """Low-res rows a curve strip blends at 1/ds whose first block row r
    has phase s = (r - ds/2) mod ds; at ds 1 the strip's rows."""
    return VS if ds == 1 else (s + VS - 1) // ds + 2


def tile_plan(family: int, radius: int, what: int) -> int:
    """llie_retinex_tile_plan: K1 (family 0), K4 (1) or K3 (2) at a blur
    radius on the tile (0: none): 0 rows, 1 columns, 2 threads, 3 shared
    memory bytes on u8 (K1's with its raw-row buffer), 4 plane pitch, 5 the
    ring's first grid column, 6 shared memory bytes on f32, 7 K1's raw
    chunks a row, 8 K3's curve strip rows, 9 and 10 the low-res rows a K3
    strip blends at most at 1/2 and 1/4."""
    if family not in (0, 1, 2) or not 0 <= radius <= MAX_BLUR_RADIUS:
        return -1
    curve = family == 2
    return {0: TH, 1: TW, 2: NT,
            3: 4 * smem_floats(family, radius, family == 0),
            4: pitch(radius), 5: grid_off(radius) + radius,
            6: 4 * smem_floats(family, radius),
            7: raw_chunks(radius) if family == 0 else 0,
            8: VS if curve else 0,
            9: walk_rows(2, 1) if curve else 0,
            10: walk_rows(4, 3) if curve else 0}.get(what, -1)


@pytest.mark.parametrize("family", (0, 1, 2))
def test_tile_plan_fits_two_blocks_an_sm(family):
    for r in range(MAX_BLUR_RADIUS + 1):
        for what in (3, 6):
            smem = tile_plan(family, r, what)
            assert smem <= SMEM_PER_BLOCK
            assert 2 * (smem + 1024) <= SMEM_PER_SM
        assert tile_plan(family, r, 4) % 2 == 1          # odd pitch
        # the staged columns [off, off + 2R + YW) fit the groups
        assert grid_off(r) + YW + 2 * r <= 4 * groups(r) < tile_plan(
            family, r, 4)
        assert tile_plan(family, r, 5) == grid_off(r) + r
        # K1's raw buffers end the block on a 16-byte boundary
        assert family == 1 or tile_plan(0, r, 3) % 16 == 0
        # K1 and K3 are built for 3 blocks an SM: they fit up to radius 3
        if family != 1 and r <= 3:
            for what in (3, 6):
                assert 3 * (tile_plan(family, r, what) + 1024) <= SMEM_PER_SM
    assert tile_plan(3, 0, 0) == tile_plan(0, 9, 0) == -1


def test_tile_reads_stay_in_the_row_for_every_width():
    """For every width 1..1920 and radius: the tiles cover each column
    once and staging's groups cover the staged columns. K1 on u8 HWC: the
    words decode_raw reads for a group inside the image (x >= 0, x + 3 <
    W) lie in the chunks issue_raw copies (from chunk_of(row) while a
    chunk starts before the row's byte 3 c1, at most raw_chunks of them),
    at every alignment of the row. K4 and K3 (its planes and the gain or
    illumination plane): the groups of a tile they read as words
    (``inside``) lie in the row, on word (u8) and 16-byte (f32) boundaries
    when WB % 4 == 0."""
    w = np.arange(1, 1921)[:, None, None]
    x0 = TW * np.arange(0, 1920 // TW + 1)[None, :, None]
    tile = x0 < w                                       # the grid's tiles
    assert np.array_equal(tile[:, :, 0].sum(1), -(-w[:, 0, 0] // TW))
    for r in range(MAX_BLUR_RADIUS + 1):
        ng, nch = groups(r), tile_plan(0, r, 7)
        xa = x0 - 1 - r - grid_off(r)
        assert np.all(xa % 4 == 0)
        assert np.all(xa <= x0 - 1 - r)
        assert np.all(xa + 4 * ng >= x0 + TW + 1 + r)
        x = xa + 4 * np.arange(ng)[None, None, :]        # each group
        # K1: decode_raw's words, bytes relative to a row at address a
        interior = tile & (x >= 0) & (x + 3 < w)
        c1 = np.minimum(xa + 4 * ng, w)
        for a in range(16):
            c0 = (a + 3 * np.maximum(xa, 0)) // 16 * 16  # chunk_of
            o = a + 3 * x - c0
            end = o // 4 * 4 + np.where(o % 4 == 0, 12, 16)
            copied = np.minimum(-(-(a + 3 * c1 - c0) // 16), nch)
            assert np.all(~interior | ((o >= 0) & (end <= 16 * copied)))
        # K4: `inside` tiles read every group as one word or float4
        inside = tile & (xa >= 0) & (xa + 4 * ng <= w)
        assert np.all(~inside | ((x >= 0) & (x + 4 <= w)))
        assert np.all(~(inside & (w % 4 == 0)) | (x % 4 == 0))
        # at 600 and 1920 wide only the edge tiles clamp
        for width in (600, 1920):
            n = -(-width // TW)
            assert interior[width - 1, 1:n - 1].all()
            assert inside[width - 1, 1:n - 1].all()
