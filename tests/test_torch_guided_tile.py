"""The guided tail kernel's geometry, walks and plan (csrc/guided.cuh,
csrc/fused_guided.cuh), modelled on the CPU against the plain versions and
the JAX package's ops/guided.py cores.

- ``guided_plan`` mirrors ``llie_fused_guided_plan`` (what 2, 4, 5, 6: the
  shared memory of a launch, the blocks an SM the kernels are built for,
  guided_tile's planes and where the staging's scratch starts);
  chip_smoke.py holds the library to it on the card.
- A model of ``guided_tile`` as the kernel runs it now (the caller stages
  the joint guide; each channel's blend is written over its own input
  plane's centre, the last pass's items in reverse order) is bit-equal to
  the JAX cores on the tile's staged planes.
- The staging's row-major walk and its groups of 4 columns visit every
  position once; K3's curve strips at 1/2 and 1/4 (the column blend once a
  low-res row, each output row picking its two) give ``upsample_maps``'
  values bit for bit; hybrid's in-place copies of the margin columns read
  no column they write.

chip_smoke.py imports ``guided_plan`` from here on the card, where there is
no JAX: the one test that runs the JAX cores imports them itself.
"""

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch.ops.filters import (
    _phase_consts,
    upsample_maps,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

GT, GP, NT = 32, 8, 256          # guided.cuh GT_H = GT_W, GP, GUIDED_THREADS
SM_BYTES, BLOCK_BYTES = 233472, 232448   # an SM's, a block's at most


def geom(r):
    g = dict(LH=GT + 4 * r, LW=GT + 4 * r, SH=GT + 2 * r, SW=GT + 2 * r)
    g["LS"], g["SS"] = g["LW"] + 1, g["SW"] + 1
    g["LN"], g["VN"] = g["LH"] * g["LS"], g["SH"] * g["LS"]
    g["SN"], g["QN"] = g["SH"] * g["SS"], GT * g["SS"]
    return g


def floats(r, joint):
    g = geom(r)
    return ((4 if joint else 3) * g["LN"] + 2 * g["VN"]
            + (4 if joint else 2) * g["SN"] + 2 * g["QN"])


def scratch(r, joint):
    return (4 if joint else 3) * geom(r)["LN"]


def blocks(r, joint):
    return max(1, min(3, SM_BYTES // (4 * floats(r, joint) + 1024)))


def launch_floats(family, r, joint, rb):
    """fused_guided.cuh launch_floats of the kernel family (K1's gain form
    runs K3's)."""
    g = geom(r)
    ew, eh = g["LW"] + 2 * rb, g["LH"] + 2 * rb
    staging = (scratch(r, joint) + (g["LN"] if family == 3 else 0)
               + (g["LH"] * ew + eh * ew if rb > 0 else 0))
    return max(staging, floats(r, joint))


def guided_plan(family, radius, joint, what):
    """llie_fused_guided_plan's values that do not need the card (what 2,
    4, 5, 6); None for those that do (0, 1, 3); -1 out of range."""
    if not 0 <= family <= 3 or not 1 <= radius <= 8:
        return -1
    if what in (0, 1, 3):
        return None
    kfam = 2 if family == 1 else family
    return {2: 4 * launch_floats(kfam, radius, joint,
                                 0 if family == 1 else 2),
            4: blocks(radius, joint), 5: floats(radius, joint),
            6: scratch(radius, joint)}.get(what, -1)


def test_plan_fits_the_block_and_the_blocks_an_sm():
    """Every launch fits a block's shared memory, at every blur radius the
    tile runs; the default forms (blur r 2) need no more than guided_tile's
    planes, so they run at the blocks an SM the kernels are built for: 3
    with the joint guide up to r 2 and per channel up to r 5."""
    for r in range(1, 9):
        for joint in (True, False):
            for fam in (0, 2, 3):
                for rb in range(0, 9):
                    assert 4 * launch_floats(fam, r, joint, rb) \
                        <= BLOCK_BYTES
                assert launch_floats(fam, r, joint, 2) == floats(r, joint)
            assert scratch(r, joint) < floats(r, joint)
    assert [blocks(r, True) for r in range(1, 9)] == [3, 3, 2, 2, 2, 2, 1, 1]
    assert [blocks(r, False) for r in range(1, 9)] == [3, 3, 3, 3, 3, 2, 2, 2]
    assert guided_plan(0, 2, True, 2) == 68832
    assert guided_plan(0, 4, True, 2) == 90048
    assert guided_plan(0, 4, False, 2) == 67520
    assert guided_plan(4, 2, True, 2) == -1 and guided_plan(0, 9, 0, 2) == -1


@pytest.mark.parametrize("nr,nc", [(40, 44), (36, 40), (64, 80), (32, 32),
                                   (10, 40), (12, 64), (3, 97), (1, 1)])
def test_region_walk_visits_every_position_once(nr, nc):
    """for_region: thread t starts at (t / nc, t % nc) and steps NT
    positions row-major, without dividing in the loop."""
    seen = np.zeros((nr, nc), np.int32)
    for t in range(NT):
        i, j = divmod(t, nc)
        di, dj = divmod(NT, nc)
        while i < nr:
            seen[i, j] += 1
            i, j = i + di, j + dj
            if j >= nc:
                j, i = j - nc, i + 1
    assert (seen == 1).all()


def test_groups_cover_the_staged_columns_once():
    """load_group / for_planar_groups: the blur's ring of EW staged columns
    from image column gx0 (negative at the image's left edge) in groups of
    4 from the multiple of 4 at or below gx0 (gx0 & 3 in two's complement):
    every group starts 4-aligned, every staged column is worked once, as
    pixel u of the group that holds its image column."""
    for gx0 in range(-12, 9):
        for ew in (36, 40, 44, 52, 80):
            seen = np.zeros(ew, np.int32)
            off = gx0 & 3
            for q in range((ew + off + 3) >> 2):
                x = gx0 - off + 4 * q
                assert x % 4 == 0
                for u in range(4):
                    j = 4 * q - off + u
                    if 0 <= j < ew:
                        seen[j] += 1
                        assert gx0 + j == x + u
            assert (seen == 1).all()


# ------------------------------------------- guided_tile, modelled --- #

def _box_run(w, r, k):
    """GP outputs from the GP + 2r rows of w (axis 0), as box_run sums:
    the centre, then -t and +t, t ascending, times k."""
    out = []
    for i in range(GP):
        acc = w[i + r]
        for t in range(1, r + 1):
            acc = (acc + w[i + r - t]) + w[i + r + t]
        out.append(acc * k)
    return np.stack(out)


def _runs(n):
    return [min(run * GP, n - GP) for run in range(-(-n // GP))]


def _vertical(src, nrow, ncol, r, k):
    """vertical_items: a run of GP rows of every column at once, the runs
    in reverse order (the last one overlaps the one before it)."""
    out = np.full((nrow, ncol), np.nan, np.float32)
    for r0 in reversed(_runs(nrow)):
        out[r0:r0 + GP] = _box_run(src[r0:r0 + GP + 2 * r, :ncol], r, k)
    return out


def _horizontal(src, nrow, ncol, r, k):
    return _vertical(src[:nrow].T.copy(), ncol, nrow, r, k).T


def _guided_tile(planes, r, eps, s, joint):
    """guided_tile on the staged planes (3, LH, LW): the guide staged by
    the caller, the blend over each channel's own plane centre."""
    k = np.float32(1.0 / (2 * r + 1))
    eps, s = np.float32(eps), np.float32(s)
    g = geom(r)
    sh, sw = g["SH"], g["SW"]
    p = planes.copy()
    if joint:
        gd = (p[0] + p[1] + p[2]) * np.float32(1.0 / 3.0)
        mg = _horizontal(_vertical(gd, sh, g["LW"], r, k), sh, sw, r, k)
        sgg = _horizontal(_vertical(gd * gd, sh, g["LW"], r, k), sh, sw, r,
                          k)
        inv = np.float32(1.0) / ((sgg - mg * mg) + eps)
    for ch in range(3):
        x = p[ch]
        m = _horizontal(_vertical(x, sh, g["LW"], r, k), sh, sw, r, k)
        prod = gd * x if joint else x * x
        s2 = _horizontal(_vertical(prod, sh, g["LW"], r, k), sh, sw, r, k)
        if joint:
            a = (s2 - mg * m) * inv
            b = m - a * mg
        else:
            var = s2 - m * m
            a = var / (var + eps)
            b = m - a * m
        qa = _horizontal(_vertical(a, GT, sw, r, k), GT, GT, r, k)
        qb = _horizontal(_vertical(b, GT, sw, r, k), GT, GT, r, k)
        c = slice(2 * r, 2 * r + GT)
        # the last pass: each item reads x at its own outputs, then writes
        # them; items (rows x runs of columns) in reverse order
        for c0 in reversed(_runs(GT)):
            cols = slice(2 * r + c0, 2 * r + c0 + GP)
            xv = x[c, cols].copy()
            guide = gd[c, cols] if joint else xv
            q = qa[:, c0:c0 + GP] * guide + qb[:, c0:c0 + GP]
            x[c, cols] = xv + s * (q - xv)
    return p[:, 2 * r:2 * r + GT, 2 * r:2 * r + GT]


@pytest.mark.parametrize("radius,joint", [(1, True), (2, True), (2, False),
                                          (4, True), (4, False), (8, False)])
def test_guided_tile_bit_equal_to_jax_cores(radius, joint):
    """On the staged planes of one tile, the kernel's walk equals the JAX
    package's shift cores (wrap shifts on the same planes) on the tile's
    centre, which lies 2r inside them, bit for bit."""
    import jax.numpy as jnp

    from low_light_image_enhancement_tpu.ops import filters as jf
    from low_light_image_enhancement_tpu.ops import guided as jg

    g = geom(radius)
    planes = np.random.default_rng(40 + radius).random(
        (3, g["LH"], g["LW"]), dtype=np.float32)
    got = _guided_tile(planes, radius, 1e-2, 0.8, joint)
    jx = [jnp.asarray(planes[c]) for c in range(3)]
    if joint:
        want = jg.guided_joint_core_shift(jx, 1e-2, 0.8, jf.roll2d, radius)
    else:
        want = [jg.guided_core_shift(p, 1e-2, 0.8, jf.roll2d, radius)
                for p in jx]
    c = slice(2 * radius, 2 * radius + GT)
    for ch in range(3):
        np.testing.assert_array_equal(got[ch], np.asarray(want[ch])[c, c])


# ----------------------------------------------- K3's curve strips --- #

def _map_tap(br, bc, ds, hl, wl):
    """map_tap's rows, columns and weights (f, 1 - f) of block (br, bc)."""
    f = np.float32(_phase_consts(ds))
    h = ds // 2
    rc = [min(max((v + d) // ds, 0), n - 1) for v, n in ((br, hl), (bc, wl))
          for d in (-h, h)]
    fr, fc = f[br % ds], f[bc % ds]
    return rc, (fr, np.float32(1.0) - fr, fc, np.float32(1.0) - fc)


def _strip_values(q, brs, bc, ds, hl, wl):
    """A strip's map values as curve_strips forms them at 1/2 and 1/4: the
    column blend once at each of the K low-res rows from the first row's,
    each output row picking its two rows' blends by its offsets."""
    s = len(brs)
    k_rows = (s - 1 + ds) // ds + 2
    (_, _, c0, c1), (_, _, fc, gc) = _map_tap(0, bc, ds, hl, wl)
    kb = _map_tap(brs[0], bc, ds, hl, wl)[0][0]
    cb = [q[min(kb + k, hl - 1), c0] * gc + q[min(kb + k, hl - 1), c1] * fc
          for k in range(k_rows)]
    out = []
    for br in brs:
        (r0, r1, _, _), (fr, gr, _, _) = _map_tap(br, bc, ds, hl, wl)
        assert 0 <= r0 - kb < k_rows and 0 <= r1 - kb < k_rows
        out.append(cb[r0 - kb] * gr + cb[r1 - kb] * fr)
    return out


@pytest.mark.parametrize("ds,r", [(2, 2), (4, 2), (4, 4)])
def test_curve_strips_equal_upsample_maps(ds, r):
    """Every staged position of tiles at the block's corners and inside it
    (rows and columns clamped into the block), walked in strips of 4 rows,
    takes upsample_maps' value."""
    hl, wl = 10, 14
    maps = np.random.default_rng(50 + ds).random((1, 1, 1, hl, wl),
                                                 dtype=np.float32)
    want = upsample_maps(torch.from_numpy(maps), ds).numpy()[0, 0, 0]
    hb, wb = hl * ds, wl * ds
    g = geom(r)
    for r0, c0 in ((-2 * r, -2 * r), (hb - 20, wb - 30), (3, 5), (1, 2)):
        for j in range(g["LW"]):
            bc = min(max(c0 + j, 0), wb - 1)
            for i0 in range(0, g["LH"], 4):
                brs = [min(max(r0 + i0 + o, 0), hb - 1) for o in range(4)]
                got = _strip_values(maps[0, 0, 0], brs, bc, ds, hl, wl)
                for br, v in zip(brs, got):
                    assert v == want[br, bc], (ds, r, r0, c0, i0, j)


@pytest.mark.parametrize("m,img_w", [(6, 20), (10, 100), (18, 40)])
def test_margin_copies_read_no_column_they_write(m, img_w):
    """Hybrid's boosted columns outside [m, m + img_w) take their nearest
    image column's values in place: whatever the order of the copies, the
    result is the copy from the untouched row, for tiles left of, across
    and right of the image."""
    lw = 48
    for c0 in range(-lw, m + img_w + lw, 7):
        src = np.arange(lw, dtype=np.float32) + 1000
        jr = [min(max(min(max(c0 + j, m), m + img_w - 1) - c0, 0), lw - 1)
              for j in range(lw)]
        want = src[jr]
        for order in (range(lw), reversed(range(lw))):
            row = src.copy()
            for j in order:
                if jr[j] != j:
                    row[j] = row[jr[j]]
            np.testing.assert_array_equal(row, want)
