"""The layout of K6's tensor-core form (csrc/conv3x3_wgmma.cuh), on the CPU.

The kernel runs only on the card. What it reads is fixed on the host: the
bf16 weights of ``mxu_conv.pack_conv_weights_wgmma`` and the order in which
it walks K (tap, then the pieces of each input group, ``piece_channels``
wide with zero rows past the group's width, 16 channels a step), chunk by
chunk of output channels (Cout padded to a multiple of 8). Two models of
that walk are held here to ``conv3x3_plain``:

- an im2col GEMM over the packed matrix, K in the kernel's order;
- the kernel's shared-memory walk itself: its strips and ring of halo
  rows (a slot refilled only once every row group that reads it has
  arrived), the TMA box of each halo row and piece landing pixel-major in
  the piece's 32/64/128-byte swizzle with zeros outside the image (and
  past the group's channels), and each wgmma operand read through its
  K-major swizzled descriptor (rows of 2 * CP bytes, 8-row groups at SBO
  = 8 rows, 16-byte chunks XORed with bits 7-9 of their address), the A
  start moved by dx * d pixels and 32 bytes a k16 step, the grid's slices
  of output chunks each holding its own weights, the epilogue storing
  only the layer's channels, and the piece groups of the widest layers
  (a slot holding some of a row's pieces, the accumulators held across
  them), and the streamed weights of the widest (each piece group's
  weights copied into one of two buffers with its rows, the pieces
  worked out from the groups' widths as the device does), with the
  geometry of this file's mirror of the kernel's plan (``wgmma_plan``:
  llie_conv_plan's chunk width and plan()).

Bars: float32 within 1e-5, bf16 within one bf16 step of the value (see
tests/test_torch_mxu_conv.py ``assert_within``).
"""

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch.kernels import mxu_conv as tmx

F32_BAR = 1e-5

# (groups, Cout, act, dilation, (H, W)): fcn's 24->24 layers at d 1, 2 and
# 32, the curve CNN's and decom's 32->32 (also over several strips), the
# curve CNN's 32+32->32 and 32+32->24, and a dilation past the widest
# contiguous halo row (three boxes a row); the widths other configs reach:
# the head at curve_iters 4 (Cout 12, padded to 16) and 16 (48),
# curve_features 64 (64->64, the 64+64 concat in two 64-channel groups,
# whose weights the grid holds in two slices, and its head at 16 iters),
# and the widest (below)
_CASES = {
    "24-24-leaky-d1": ((24,), 24, "leaky", 1, (9, 70)),
    "24-24-leaky-d2": ((24,), 24, "leaky", 2, (11, 70)),
    "24-24-leaky-d32": ((24,), 24, "leaky", 32, (70, 72)),
    "32-32-relu": ((32,), 32, "relu", 1, (9, 70)),
    # three strips down a column, the ring wrapping within and across them
    "32-32-relu-tall": ((32,), 32, "relu", 1, (71, 40)),
    "64cat-32-relu": ((32, 32), 32, "relu", 1, (7, 45)),
    "64cat-24-tanh": ((32, 32), 24, "tanh", 1, (7, 45)),
    "24-24-leaky-d66": ((24,), 24, "leaky", 66, (70, 140)),
    "64cat-12-tanh": ((32, 32), 12, "tanh", 1, (7, 45)),
    "64cat-48-tanh": ((32, 32), 48, "tanh", 1, (7, 45)),
    "64-64-relu": ((64,), 64, "relu", 1, (7, 70)),
    "128cat-64-relu": ((64, 64), 64, "relu", 1, (7, 45)),
    "128cat-48-tanh": ((64, 64), 48, "tanh", 1, (5, 45)),
    # curve_features 160 and 512: more pieces than whole halo rows leave
    # room for, so a slot holds a group of pieces (c5 at 160, the head of
    # curve_iters 8 at 512, the widest the kernel takes)
    "320cat-160-relu": ((160, 160), 160, "relu", 1, (5, 45)),
    "1024cat-24-tanh": ((512, 512), 24, "tanh", 1, (3, 40)),
    # past 16 pieces (curve_features 640 and 1024) and at dilation 64 past
    # 14: the weights streamed by piece group, the pieces worked out on the
    # device
    "1280cat-24-tanh": ((640, 640), 24, "tanh", 1, (3, 40)),
    "2048cat-16-relu": ((1024, 1024), 16, "relu", 1, (2, 24)),
    "1024-8-leaky-d64": ((1024,), 8, "leaky", 64, (3, 40)),
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _layer(case, dtype):
    cins, cout, act, dil, (h, w) = _CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    xs = [torch.from_numpy(rng.random((2, h, w, c), dtype=np.float32))
          .to(dtype) for c in cins]
    cin = sum(cins)
    wt = torch.from_numpy((rng.standard_normal((cout, cin, 3, 3))
                           * np.sqrt(2.0 / (9 * cin))).astype(np.float32))
    b = torch.from_numpy((0.1 * rng.standard_normal(cout))
                         .astype(np.float32))
    return xs, wt, b, act, dil


def assert_within(got, want, dtype):
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= F32_BAR, float(d.max())
        return
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
    bar = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp_min(F32_BAR)
    assert bool((d <= bar).all()), (float(d.max()),
                                    float((d > bar).float().mean()))


def _pieces(groups):
    """(group start channel, piece start, its width, CP) in K order."""
    out, start = [], 0
    for c in groups:
        cp = tmx.piece_channels(c)
        out += [(start, c0, min(cp, c - c0), cp) for c0 in range(0, c, cp)]
        start += c
    return out


def _swizzled(nbytes, mask):
    """Byte offset -> its place under the swizzle: 16-byte chunk bits 4..6
    XORed with bits 7..9 (as many as ``mask`` has)."""
    o = np.arange(nbytes)
    return o ^ (((o >> 7) & mask) << 4)


def _packed_b(packed, groups, cout, nc=None):
    """The packed weights as the (9 * K, Cout) B matrix, rows in the order
    the kernel walks K (tap, piece, channel of the piece: CP of them), the
    columns of chunk after chunk of nc, Cout's padding dropped."""
    nc = nc or tmx.chunk_channels(cout)
    raw = packed.view(torch.int16).numpy()
    cols = []
    for j in range(tmx.padded(cout) // nc):
        taps, off = [[] for _ in range(9)], 0
        for _, _, _, cp in _pieces(groups):
            span = -(-nc * cp // 512) * 512
            el = _swizzled(2 * nc * cp, cp // 8 - 1)[::2] // 2
            for t in range(9):
                m = raw[9 * j + t, off:off + span][el].reshape(nc, cp)
                taps[t].append(m.T)
            off += span
        cols.append(np.concatenate([np.concatenate(m, 0) for m in taps], 0))
    b = np.concatenate(cols, 1)[:, :cout]
    return torch.from_numpy(np.ascontiguousarray(b)).view(torch.bfloat16)


def _reference(xs, wt, b, act, dil, dtype):
    """conv3x3_plain on the same function: f32 activations meet the weights
    rounded to bf16, as the kernel's packed matrix holds them."""
    if dtype == torch.float32:
        wt = wt.to(torch.bfloat16).float()
    return tmx.conv3x3_plain(xs, wt, b, act, dil)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("case", sorted(_CASES))
def test_im2col_gemm_over_packed_weights_matches_plain(case, dtype):
    xs, wt, b, act, dil = _layer(case, _DTYPES[dtype])
    groups = tuple(x.shape[-1] for x in xs)
    x = torch.cat(xs, -1).float()
    bsz, h, w, _ = x.shape
    xp = torch.nn.functional.pad(x, (0, 0, dil, dil, dil, dil))
    # A: (pixels, 9 * K), tap-major (dy, dx), then piece by piece, the
    # channels past a group's width 0
    cols = []
    for dy in range(3):
        for dx in range(3):
            win = xp[:, dy * dil:dy * dil + h, dx * dil:dx * dil + w]
            for start, c0, cw, cp in _pieces(groups):
                piece = win[..., start + c0:start + c0 + cw]
                cols.append(torch.nn.functional.pad(piece, (0, cp - cw)))
    a = torch.cat(cols, -1).reshape(bsz * h * w, -1)
    bm = _packed_b(tmx.pack_conv_weights_wgmma(wt, groups), groups,
                   wt.shape[0]).float()
    y = tmx.ACTS[act](a @ bm + b).reshape(bsz, h, w, -1)
    got = y.to(_DTYPES[dtype])
    assert_within(got, _reference(xs, wt, b, act, dil, _DTYPES[dtype]),
                  _DTYPES[dtype])


# ------------------------------------------- the kernel's walk, modelled #

# csrc/conv3x3_wgmma.cuh: the strip walk and the shared memory of a block
TILE_X, ROWS, STRIP_ROWS = 64, 2, 32
MAX_BOX_X, MAX_PIECES, MAX_SLOTS, MAX_N = 192, 16, 16, 64
ALIGN, SMEM_LIMIT = 1024, 232448


def _round(v, m):
    return -(-v // m) * m


def plan_layer(groups, cout, dil, nc, ppg=MAX_PIECES, table=True):
    """conv3x3_wgmma.cuh plan_layer() for input groups of ``groups``
    channels (multiples of 8) at chunk width nc: the pieces (group, first
    channel, CP, bytes a pixel, offset in its piece group's slot, bytes of
    a box region, weights' offset in a tap), ``ppg`` pieces a slot at most;
    with ``table`` None past MAX_PIECES pieces. Also what the streamed form
    reads: group a's pieces and the bytes a pixel of each group's pieces,
    the bytes a tap of the widest piece group's weights."""
    g = {"nc": nc, "nseg": 1 if TILE_X + 2 * dil <= MAX_BOX_X else 3,
         "dil": dil, "stream": False}
    g["box_x"] = _round(TILE_X + 2 * dil, 8) if g["nseg"] == 1 else TILE_X
    aoff = woff = row = gw = wpg = 0
    g["pieces"] = []
    for m, c in enumerate(groups):
        cp = tmx.piece_channels(c)
        for c0 in range(0, c, cp):
            if table and len(g["pieces"]) == MAX_PIECES:
                return None
            if len(g["pieces"]) % ppg == 0:
                aoff = gw = 0
            sp = 2 * cp
            areg = _round(g["box_x"] * sp, ALIGN)
            g["pieces"].append({"group": m, "c0": c0, "cp": cp, "sp": sp,
                                "aoff": aoff, "areg": areg, "woff": woff})
            aoff += g["nseg"] * areg
            woff += _round(nc * sp, ALIGN)
            gw += _round(nc * sp, ALIGN)
            row = max(row, aoff)
            wpg = max(wpg, gw)
    g["ppg"] = min(ppg, len(g["pieces"]))
    g["pgroups"] = -(-len(g["pieces"]) // g["ppg"])
    cpa = tmx.piece_channels(groups[0])
    g.update(row=row, wtap=woff, wchunk=9 * woff, wpg=wpg,
             nchunks=tmx.padded(cout) // nc, npa=-(-groups[0] // cpa),
             spa=2 * cpa,
             spb=2 * tmx.piece_channels(groups[1]) if len(groups) > 1
             else 2 * cpa)
    return g


def piece_at(g, p, p0):
    """conv3x3_wgmma.cuh piece_at(): piece p of the streamed form from the
    groups' widths alone, its slot region and weights from piece p0's."""
    a = p < g["npa"]
    sp = g["spa"] if a else g["spb"]
    areg_a, areg_b = (_round(g["box_x"] * v, ALIGN)
                      for v in (g["spa"], g["spb"]))
    wp_a, wp_b = (_round(g["nc"] * v, ALIGN) for v in (g["spa"], g["spb"]))
    na = max(0, min(p, g["npa"]) - p0)
    nb = p - p0 - na
    return {"group": 0 if a else 1,
            "c0": (p if a else p - g["npa"]) * (sp // 2), "cp": sp // 2,
            "sp": sp, "areg": areg_a if a else areg_b,
            "aoff": g["nseg"] * (na * areg_a + nb * areg_b),
            "woff": na * wp_a + nb * wp_b}


def plan_stream(groups, cout, dil, nc):
    """conv3x3_wgmma.cuh plan_stream(): the fewest piece groups whose two
    weight buffers (9 taps of a piece group each) and a ring of ROWS + 2
    slots fit, one chunk a block."""
    g = plan_layer(groups, cout, dil, nc, table=False)
    pieces = len(g["pieces"])
    for pgroups in range(1, pieces + 1):
        ppg = -(-pieces // pgroups)
        if -(-pieces // ppg) != pgroups:
            continue
        g = plan_layer(groups, cout, dil, nc, ppg, table=False)
        fixed = ALIGN + 2 * 9 * g["wpg"] + 4 * nc + 8 + 32
        fit = (SMEM_LIMIT - fixed) // (g["row"] + 16)
        if fit >= ROWS + 2:
            slots = min(fit, MAX_SLOTS)
            g.update(npass=1, nsplit=g["nchunks"], slots=slots, stream=True,
                     smem=fixed + (g["row"] + 16) * slots)
            return g
    return None


def plan_stage(groups, cout, dil, nc, stage):
    """conv3x3_wgmma.cuh plan_stage(): at stages 0 and 1 whole halo rows a
    slot and the most chunks a block holds beside a ring of 2 * ROWS + 4,
    then ROWS + 2 slots; at stages 2 and 3 the same rings with the fewest
    piece groups and one chunk a block; at stage 4 streamed weights; None
    where nothing fits."""
    if stage == 4:
        return plan_stream(groups, cout, dil, nc)
    want = ROWS + 2 if stage % 2 else 2 * ROWS + 4
    g = plan_layer(groups, cout, dil, nc)
    if g is None:
        return None
    pieces = len(g["pieces"])
    for pgroups in (range(2, pieces + 1) if stage >= 2 else (1,)):
        ppg = -(-pieces // pgroups)
        if -(-pieces // ppg) != pgroups:
            continue
        if stage >= 2:
            g = plan_layer(groups, cout, dil, nc, ppg)
        for npass in range(1 if stage >= 2 else g["nchunks"], 0, -1):
            if g["nchunks"] % npass:
                continue
            fixed = ALIGN + npass * g["wchunk"] + 4 * npass * nc
            fit = (SMEM_LIMIT - fixed) // (g["row"] + 16)
            if fit >= want:
                g.update(npass=npass, nsplit=g["nchunks"] // npass,
                         slots=min(fit, MAX_SLOTS),
                         smem=fixed + (g["row"] + 16) * min(fit, MAX_SLOTS))
                return g
    return None


def wgmma_plan(groups, cout, dil):
    """conv3x3_wgmma.cuh chunk_width() and plan() at that width: at the
    first stage where any fits, the widest nc dividing Cout's padding; None
    where none fits (llie_conv_plan's 0)."""
    c8 = tmx.padded(cout) // 8
    for stage in range(5):
        for d in range(MAX_N // 8, 0, -1):
            if c8 % d == 0:
                g = plan_stage(groups, cout, dil, 8 * d, stage)
                if g is not None:
                    return g
    return None


def _plan(bsz, h, w, dil, groups, cout):
    """conv3x3_wgmma.cuh plan(), in bytes: wgmma_plan's pieces, ring and
    slices, and the strips of the layer."""
    g = wgmma_plan(groups, cout, dil)
    assert g is not None and g["slots"] >= ROWS + 2
    assert g["smem"] <= SMEM_LIMIT
    g["phases"] = min(dil, h)
    g["chunks"] = -(-(-(-h // dil)) // STRIP_ROWS)
    g["xtiles"] = -(-w // TILE_X)
    g["nstrips"] = bsz * g["phases"] * g["chunks"] * g["xtiles"]
    return g


def _readers(j, groups):
    """conv3x3_wgmma.cuh readers(): the row groups of a strip that read
    its halo row j."""
    hi = min(groups - 1, j // ROWS)
    lo = 0 if j <= ROWS + 1 else (j - 2) // ROWS
    return hi - lo + 1


def _operand(buf, start, sp, nrows):
    """The (nrows, 16) operand a K-major swizzled descriptor reads from
    ``buf`` (bf16 elements, 2 bytes each; offset 0 on a 1024-byte
    boundary): row r, column k at byte start + (r // 8) * 8 * sp +
    (r % 8) * sp + 2 * k, its 16-byte chunk XORed with bits 7.. of that
    address."""
    r = np.arange(nrows)[:, None]
    k = np.arange(16)[None, :]
    o = start + r * sp + 2 * k
    o = o ^ (((o >> 7) & (sp // 16 - 1)) << 4)
    assert start % 16 == 0
    return buf[o // 2]


def _kernel_walk(xs, w, bias, act, dil):
    """The kernel's strips, ring of halo rows and descriptors on numpy
    float32 arrays holding bf16 values, the row groups in order, one block
    for each slice of output chunks: a halo row is loaded when a group
    first needs it (with piece groups: each row group's rows once per piece
    group, the accumulators held across them), into the next slot of the
    ring, which must hold no row still to be read (its readers all
    arrived: else the kernel's producer would wait forever); NaN where no
    TMA box writes. The weights are packed at the plan's chunk width, the
    bias padded as the wrapper does."""
    groups = [x.float().numpy() for x in xs]
    bsz, h, wd, _ = groups[0].shape
    cout = bias.shape[0]
    g = _plan(bsz, h, wd, dil, [x.shape[-1] for x in groups], cout)
    nc, slots = g["nc"], g["slots"]
    packed = tmx.pack_conv_weights_wgmma(w, [x.shape[-1] for x in groups],
                                         nc)
    assert packed.numel() * 2 == g["nchunks"] * g["wchunk"]
    wall = packed.float().numpy().reshape(-1)
    bpad = np.pad(bias, (0, tmx.padded(cout) - cout))
    out = np.full((bsz, h, wd, cout), np.nan, np.float32)
    npieces = len(g["pieces"])
    firsts = range(0, npieces, g["ppg"])
    if g["stream"]:
        # the device's pieces, from the groups' widths
        piece_groups = [[piece_at(g, p, p0)
                         for p in range(p0, min(p0 + g["ppg"], npieces))]
                        for p0 in firsts]
    else:
        piece_groups = [g["pieces"][p:p + g["ppg"]] for p in firsts]
    assert len(piece_groups) == g["pgroups"]
    for split in range(g["nsplit"]):
        wbytes = g["npass"] * g["wchunk"]
        wsm = wall[split * wbytes // 2:(split + 1) * wbytes // 2]
        wbuf = [np.full(9 * g["wpg"] // 2, np.nan, np.float32)
                for _ in range(2)]
        wc = 0  # piece groups of weights copied, the producer's count

        def load_weights(p0, p1):
            # the weights of pieces p0 .. p1 - 1, each tap's together, into
            # buffer wc % 2 at g["wpg"] bytes a tap
            nonlocal wc
            buf = wbuf[wc % 2]
            buf[:] = np.nan
            first = piece_at(g, p0, 0)["woff"]
            nbytes = piece_at(g, p1, p0)["woff"]
            assert nbytes <= g["wpg"]
            for tap in range(9):
                src = (tap * g["wtap"] + first) // 2
                buf[tap * g["wpg"] // 2:(tap * g["wpg"] + nbytes) // 2] = \
                    wsm[src:src + nbytes // 2]
            wc += 1
            return buf
        ring = np.full(slots * g["row"] // 2, np.nan, np.float32)
        owed = [0] * slots  # arrivals a slot still waits for
        rc = 0  # rows issued, the producer's count

        def load(b, x0, y, pieces):
            # the TMA boxes of one halo row: (CP channels, box_x pixels, 1
            # row, 1 image) land pixel-major, swizzled; zeros outside
            nonlocal rc
            s = rc % slots
            assert owed[s] == 0, "a slot refilled before it was read"
            owed[s] = 2
            rc += 1
            for pc in pieces:
                assert pc["aoff"] + g["nseg"] * pc["areg"] <= g["row"]
                xg = groups[pc["group"]]
                for k in range(g["nseg"]):
                    x = x0 - dil if g["nseg"] == 1 else x0 + (k - 1) * dil
                    box = np.zeros((g["box_x"], pc["cp"]), np.float32)
                    xx = np.arange(x, x + g["box_x"])
                    ok = (xx >= 0) & (xx < wd)
                    cw = min(pc["cp"], xg.shape[-1] - pc["c0"])
                    if 0 <= y < h:
                        box[ok, :cw] = xg[b, y, xx[ok],
                                          pc["c0"]:pc["c0"] + cw]
                    dst = s * g["row"] + pc["aoff"] + k * pc["areg"]
                    el = _swizzled(2 * box.size, pc["sp"] // 16 - 1)[::2]
                    ring[(dst + el) // 2] = box.reshape(-1)
            return s

        def mma(acc, slot, k, pieces, ch0, buf=None):
            # output row k of a group: 9 taps x the pieces x k16 steps; the
            # streamed form reads its weight buffer, a tap every wpg bytes
            for tap in range(9):
                dy, dx = tap // 3, tap % 3
                for pc in pieces:
                    sp = pc["sp"]
                    a0 = slot[k + dy] * g["row"] + pc["aoff"] + (
                        dx * dil * sp if g["nseg"] == 1
                        else dx * pc["areg"])
                    if buf is None:
                        wsrc = wsm
                        b0 = ch0 * g["wchunk"] + tap * g["wtap"] + pc["woff"]
                    else:
                        wsrc, b0 = buf, tap * g["wpg"] + pc["woff"]
                    for kk in range(pc["cp"] // 16):
                        am = _operand(ring, a0 + 32 * kk, sp, TILE_X)
                        bm = _operand(wsrc, b0 + 32 * kk, sp, nc)
                        acc += am @ bm.T

        def store(acc, b, x0, y, cb):
            if y < h:
                n_x = min(TILE_X, wd - x0)
                n_c = min(nc, cout - cb)
                if n_c > 0:
                    out[b, y, x0:x0 + n_x, cb:cb + n_c] = (
                        acc[:n_x, :n_c] + bpad[cb:cb + n_c])

        for t in range(g["nstrips"]):
            xt, t2 = t % g["xtiles"], t // g["xtiles"]
            c, t2 = t2 % g["chunks"], t2 // g["chunks"]
            p, b = t2 % g["phases"], t2 // g["phases"]
            n = -(-(h - p) // dil) - c * STRIP_ROWS
            if n <= 0:
                continue
            ngroups = -(-min(n, STRIP_ROWS) // ROWS)
            x0, y0 = xt * TILE_X, p + c * STRIP_ROWS * dil
            if g["pgroups"] > 1 or g["stream"]:
                for q in range(ngroups):
                    acc = [np.zeros((TILE_X, nc), np.float32)
                           for _ in range(ROWS)]
                    for p0, pieces in zip(firsts, piece_groups):
                        buf = (load_weights(p0, p0 + len(pieces))
                               if g["stream"] else None)
                        slot = [load(b, x0, y0 + (q * ROWS + j - 1) * dil,
                                     pieces) for j in range(ROWS + 2)]
                        for k in range(ROWS):
                            mma(acc[k], slot, k, pieces, 0, buf)
                        # the reader's arrival and the other consumer's
                        for s in slot:
                            owed[s] -= 2
                    for k in range(ROWS):
                        store(acc[k], b, x0, y0 + (q * ROWS + k) * dil,
                              split * nc)
                continue
            first = rc
            for q in range(ngroups):
                while rc - first < q * ROWS + ROWS + 2:
                    load(b, x0, y0 + (rc - first - 1) * dil, g["pieces"])
                slot = [(first + q * ROWS + j) % slots
                        for j in range(ROWS + 2)]
                for ch0 in range(g["npass"]):
                    cb = (split * g["npass"] + ch0) * nc
                    for k in range(ROWS):
                        acc = np.zeros((TILE_X, nc), np.float32)
                        mma(acc, slot, k, g["pieces"], ch0)
                        store(acc, b, x0, y0 + (q * ROWS + k) * dil, cb)
                for j in range(ROWS + 2):
                    owed[slot[j]] -= 3 - _readers(q * ROWS + j, ngroups)
                    assert owed[slot[j]] >= 0
            assert rc - first == ROWS * ngroups + 2
        assert not any(owed), "rows left unreleased"
    return tmx.ACTS[act](torch.from_numpy(out))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_kernel_walk_over_packed_weights_matches_plain(case):
    """bf16, the kernel's dtype; every output written once and finite."""
    xs, wt, b, act, dil = _layer(case, torch.bfloat16)
    got = _kernel_walk(xs, wt, b.numpy(), act, dil)
    assert bool(torch.isfinite(got).all())
    assert_within(got.to(torch.bfloat16),
                  _reference(xs, wt, b, act, dil, torch.bfloat16),
                  torch.bfloat16)


@pytest.mark.parametrize("groups,dil,ppg", [((24,), 1, 16), ((64, 64), 1, 1),
                                            ((160, 160), 1, 3),
                                            ((512, 24), 66, 4),
                                            ((40, 8), 2, 16)])
def test_device_pieces_equal_the_plan_table(groups, dil, ppg):
    """piece_at's pieces, worked out from the groups' widths, are the
    plan's table (group, channels, slot region and weights within their
    piece group), so the streamed form reads what the table names."""
    g = plan_layer(groups, 24, dil, 24, ppg)
    for p, want in enumerate(g["pieces"]):
        p0 = p - p % g["ppg"]
        got = piece_at(g, p, p0)
        first = g["pieces"][p0]["woff"]
        assert got["woff"] == want["woff"] - first
        for key in ("group", "c0", "cp", "sp", "aoff", "areg"):
            assert got[key] == want[key], (p, key)


@pytest.mark.parametrize("groups,cout,dil", [((1024, 1024), 24, 1),
                                             ((640, 640), 160, 1),
                                             ((1024,), 8, 64),
                                             ((1024,), 24, 128),
                                             ((2048,), 64, 1)])
def test_wide_layers_plan_streamed_weights(groups, cout, dil):
    """Past 16 pieces, and past 14 at dilation 64 and more, the plan
    streams the weights: two buffers of a piece group's 9 taps and a ring
    of at least ROWS + 2 slots within shared memory, one chunk a block."""
    g = wgmma_plan(groups, cout, dil)
    assert g is not None and g["stream"]
    assert g["slots"] >= ROWS + 2 and g["smem"] <= SMEM_LIMIT
    assert g["npass"] == 1 and g["nsplit"] * g["nc"] == tmx.padded(cout)
    assert g["pgroups"] * g["ppg"] >= len(g["pieces"])


@pytest.mark.parametrize("groups,cout", [((24,), 24), ((32, 32), 32),
                                         ((8, 40), 8), ((16,), 16),
                                         ((96,), 24), ((32, 32), 12),
                                         ((64, 64), 64), ((64, 64), 48)])
def test_packed_weights_pad_with_zero_rows(groups, cout):
    wt = torch.randn(cout, sum(groups), 3, 3)
    packed = tmx.pack_conv_weights_wgmma(wt, groups)
    nc = tmx.chunk_channels(cout)
    assert packed.dtype == torch.bfloat16
    assert packed.shape[0] == 9 * tmx.padded(cout) // nc
    # the output channels past Cout are zero columns
    full = _packed_b(packed, groups, tmx.padded(cout), nc)
    assert bool((full[:, cout:] == 0).all())
    bm = _packed_b(packed, groups, cout).reshape(9, -1, cout)
    want = wt.to(torch.bfloat16).permute(2, 3, 1, 0).reshape(
        9, sum(groups), cout)
    k = 0
    for start, c0, cw, cp in _pieces(groups):
        assert torch.equal(bm[:, k:k + cw], want[:, start + c0:start + c0
                                                 + cw])
        assert bool((bm[:, k + cw:k + cp] == 0).all())
        k += cp
    assert k == bm.shape[1]
    # built where the weights lie (the kernel reads it from the card)
    assert tmx.pack_conv_weights_wgmma(wt.to("meta"), groups).device.type \
        == "meta"
    # any chunk width that divides the padded Cout lays out the same B
    nc8 = 8
    assert torch.equal(_packed_b(tmx.pack_conv_weights_wgmma(wt, groups,
                                                             nc8),
                                 groups, cout, nc8).reshape(9, -1, cout),
                       bm)


def test_packed_params_keeps_the_forms_apart():
    w, b = torch.randn(24, 24, 3, 3), torch.randn(24)
    direct = tmx.packed_params(
        (w, b), torch.bfloat16,
        lambda: (tmx.pack_conv_weights(w, torch.bfloat16),))
    wgmma = tmx.packed_params(
        (w, b), torch.bfloat16,
        lambda: (tmx.pack_conv_weights_wgmma(w, (24,)),), form="wgmma (24,)")
    assert wgmma is not direct
    assert direct[0].dtype == torch.float32 and direct[0].shape == (9, 24, 24)
    # one 32-channel piece: 24 rows of 64 bytes in 2048 a tap
    assert wgmma[0].dtype == torch.bfloat16 and wgmma[0].shape == (9, 1024)
    assert tmx.packed_params((w, b), torch.bfloat16, lambda: None,
                             form="wgmma (24,)") is wgmma
    assert tmx.packed_params((w, b), torch.bfloat16, lambda: None) is direct
