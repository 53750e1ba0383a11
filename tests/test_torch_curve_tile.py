"""K3's curve pass on the tile engine (``csrc/curve_tile.cu``) on the CPU.

The kernel runs the curves a column strip of ``VS`` ring rows at a time.
With maps at 1/2 or 1/4 a strip whose first block row is r blends the maps'
columns once at each of ``walk_rows(ds, s)`` low-res rows from
floor((r - ds/2) / ds) (s = (r - ds/2) mod ds, each row clamped into the
maps), and each output row blends the two it lies between, at indices that
the strip's phase s fixes at compile time. A torch model of that walk, in
the kernel's order of operations, is held bit for bit (``torch.equal``) to
the plain version, ``upsample_maps`` + ``apply_curves``, on blocks whose
low-res sizes are odd, at every phase of the tiles' first rows. The walk's
rows are also held to ``map_tap``'s (the per-output taps of the other
kernels) for every output a tile stores, at the block's edges too, and its
phase to be one per launch, as the kernel's dispatch assumes, and the
staged columns a thread reads (its ring column's unclamped floor((c -
ds/2) / ds) and the next, in a footprint clamped into the maps) to hold
``map_tap``'s two columns at every tile and width.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from test_torch_retinex_tile import (
    TH,
    TW,
    VS,
    YH,
    YW,
    pitch,
    smem_floats,
    tile_plan,
    walk_rows,
)

from low_light_image_enhancement_tpu_torch.ops.curves import apply_curves
from low_light_image_enhancement_tpu_torch.ops.filters import (
    _phase_consts,
    upsample_maps,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

VSEG = -(-YH // VS)   # strips a ring column


def _strips(r0b: int, ds: int):
    """The curve strips of a tile whose ring row 0 is block row r0b: (ring
    row of the first output, its block row rb, the phase s, the first
    low-res row floor((rb - ds/2) / ds)), as curve_pass computes them."""
    h = ds // 2
    for q in range(VSEG):
        rb = r0b + q * VS
        yield q * VS, rb, (rb + ds - h) % ds, (rb + ds - h) // ds - 1


def walk_model(y, maps, ds, halo, rows):
    """{block row: its curved values (B, 3, WB)} for every ring row of
    every tile of a launch that lies in the block, by the kernel's walk:
    per step the column blend at the strip's low-res rows, then the row
    blend, then v + a v (1 - v)."""
    hb, wb = y.shape[-2:]
    hl, wl = hb // ds, wb // ds
    h = ds // 2
    phase = torch.tensor(_phase_consts(ds), dtype=torch.float32)
    bc = torch.arange(wb)
    # map_tap's columns: bc >= 0, so the floor is the kernel's truncation
    c0 = torch.clamp((bc - h) // ds, 0, wl - 1)
    c1 = torch.clamp((bc + h) // ds, 0, wl - 1)
    fc = phase[bc % ds]
    gc = 1.0 - fc
    out = {}
    for y0 in range(0, rows, TH):
        for r0, rb, s, lrb in _strips(halo + y0 - 1, ds):
            k = walk_rows(ds, s)
            lr = torch.clamp(lrb + torch.arange(k), 0, hl - 1)
            q = maps[..., lr, :]
            a = q[..., c0] * gc + q[..., c1] * fc      # (B, n, 3, k, WB)
            for o in range(VS):
                br = rb + o
                if r0 + o >= YH or br >= hb:
                    continue
                k0 = (s + o) // ds
                fr = phase[(s + o + h) % ds]
                mv = a[..., k0, :] * (1.0 - fr) + a[..., k0 + 1, :] * fr
                v = y[..., br, :]
                for it in range(maps.shape[1]):
                    v = v + mv[:, it] * v * (1.0 - v)
                out.setdefault(br, []).append(torch.clamp(v, 0.0, 1.0))
    return out


@pytest.mark.parametrize("ds", (2, 4))
def test_map_walk_equals_the_upsample_and_curves(ds):
    """Every phase of the tiles' first rows (halo 1 .. ds + 1), blocks of
    odd low-res height and width, rows past one tile."""
    rng = np.random.default_rng(ds)
    hl, wl, n_iter = (37, 27, 4) if ds == 2 else (19, 13, 3)
    hb, wb = hl * ds, wl * ds
    maps = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (2, n_iter, 3, hl, wl)).astype(np.float32))
    y = torch.from_numpy(rng.random((2, 3, hb, wb), dtype=np.float32))
    want = torch.clamp(apply_curves(y, upsample_maps(maps, ds)), 0.0, 1.0)
    for halo in range(1, ds + 2):
        rows = hb - 2 * halo
        got = walk_model(y, maps, ds, halo, rows)
        # every row a stored output's tail reads, and the ring rows around
        assert set(range(halo - 1, halo + rows + 1)) <= set(got)
        for br, vals in got.items():
            for v in vals:
                assert torch.equal(v, want[..., br, :]), (halo, br)


def test_curve_strips_reach_every_map_tap_row():
    """For every launch phase, block height and tile: the low-res rows a
    strip blends hold map_tap's two rows of every in-block output (rows
    clamped into the maps as map_tap clamps them) within the plan's
    count of rows a strip reads; the strips reach every in-block ring row;
    the phase is one per launch."""
    for ds, what in ((2, 9), (4, 10)):
        h = ds // 2
        for halo in range(1, 2 * ds + 2):
            for hb in range(ds, 12 * ds + 1, ds):
                hl = hb // ds
                phases = set()
                covered = set()
                for y0 in range(0, max(hb - 2 * halo, 1), TH):
                    covered |= {halo + y0 - 1 + i for i in range(YH)}
                    for r0, rb, s, lrb in _strips(halo + y0 - 1, ds):
                        phases.add(s)
                        k = walk_rows(ds, s)
                        for o in range(VS):
                            br = rb + o
                            if r0 + o >= YH or br >= hb:
                                continue
                            k0 = (s + o) // ds
                            assert k0 + 1 < k <= tile_plan(2, 0, what)
                            # map_tap: truncating division of br -/+ h
                            t0 = min(max(int((br - h) / ds), 0), hl - 1)
                            t1 = min(max((br + h) // ds, 0), hl - 1)
                            assert min(max(lrb + k0, 0), hl - 1) == t0
                            assert min(max(lrb + k0 + 1, 0), hl - 1) == t1
                            assert (s + o + h) % ds == br % ds
                            covered.discard(br)
                assert len(phases) == 1, (ds, halo, hb, phases)
                # every in-block ring row is some strip's output
                assert not {r for r in covered if r < hb}


def test_staged_columns_are_map_tap_columns():
    """At ds 2 and 4, every block width and tile: the footprint column of
    a ring column's left tap and the next one, clamped into the maps as the
    copy clamps them, are map_tap's columns of its (clamped) block column,
    inside the staged footprint of TW / ds + 2 columns."""
    for ds in (2, 4):
        h = ds // 2
        fw = TW // ds + 2
        for wb in range(ds, 300 + 1, ds):
            wl = wb // ds
            for x0 in range(0, wb, TW):
                lc0 = (x0 - 1 + ds - h) // ds - 1
                for c in range(YW):
                    j0 = (x0 - 1 + c + ds - h) // ds - 1 - lc0
                    assert 0 <= j0 and j0 + 1 < fw
                    bc = min(max(x0 - 1 + c, 0), wb - 1)
                    t0 = min(max(int((bc - h) / ds), 0), wl - 1)
                    t1 = min(max((bc + h) // ds, 0), wl - 1)
                    assert min(max(lc0 + j0, 0), wl - 1) == t0
                    assert min(max(lc0 + j0 + 1, 0), wl - 1) == t1


def test_staged_maps_fit_the_tail_region():
    """At ds 2 and 4 and every radius on the tile, the region after the
    three ring planes (16-byte aligned) holds NBUF = 3 buffers of at least
    one plane of the footprint the strips read: FH low-res rows (the last
    strip's first row plus its walk) by TW / ds + 2 columns."""
    for ds in (2, 4):
        fh = (VSEG - 1) * VS // ds + max(walk_rows(ds, s) for s in range(ds))
        f = fh * (TW // ds + 2)
        for r in range(9):
            ring = 3 * (YH + 1) * pitch(r)
            start = ring + (-ring & 3)
            assert (smem_floats(2, r) - start) // (3 * f) >= 1, (ds, r)
