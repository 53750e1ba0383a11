"""The layout of K6's tensor-core form (csrc/conv3x3_wgmma.cuh), on the CPU.

The kernel runs only on the card. What it reads is fixed on the host: the
bf16 weights of ``mxu_conv.pack_conv_weights_wgmma`` and the order in which
it walks K (tap, then the pieces of each input group, ``piece_channels``
wide with zero rows past the group's width, 16 channels a step). Two
models of that walk are held here to ``conv3x3_plain``:

- an im2col GEMM over the packed matrix, K in the kernel's order;
- the kernel's shared-memory walk itself: its strips and ring of halo
  rows (a slot refilled only once every row group that reads it has
  arrived), the TMA box of each halo row and piece landing pixel-major in
  the piece's 32/64/128-byte swizzle with zeros outside the image (and
  past the group's channels), and each wgmma operand read through its
  K-major swizzled descriptor (rows of 2 * CP bytes, 8-row groups at SBO
  = 8 rows, 16-byte chunks XORed with bits 7-9 of their address), the A
  start moved by dx * d pixels and 32 bytes a k16 step, with the geometry
  of ``plan()``.

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
# contiguous halo row (three boxes a row)
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


def _packed_b(packed, groups, cout):
    """The packed weights as the (9 * K, Cout) B matrix, rows in the order
    the kernel walks K: tap, piece, channel of the piece (CP of them)."""
    raw = packed.view(torch.int16).numpy().reshape(9, -1)
    taps, off = [[] for _ in range(9)], 0
    for _, _, _, cp in _pieces(groups):
        span = -(-cout * cp // 512) * 512
        el = _swizzled(2 * cout * cp, cp // 8 - 1)[::2] // 2
        for t in range(9):
            m = raw[t, off:off + span][el].reshape(cout, cp)
            taps[t].append(m.T)
        off += span
    b = np.concatenate([np.concatenate(m, 0) for m in taps], 0)
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

TILE_X, ROWS, STRIP_ROWS, MAX_BOX_X, ALIGN = 64, 2, 32, 192, 1024
MAX_SLOTS, SMEM_LIMIT = 16, 232448


def _round(v, m):
    return -(-v // m) * m


def _plan(bsz, h, w, dil, groups, cout):
    """conv3x3_wgmma.cuh plan(), in bytes."""
    g = {"nseg": 1 if TILE_X + 2 * dil <= MAX_BOX_X else 3}
    g["box_x"] = _round(TILE_X + 2 * dil, 8) if g["nseg"] == 1 else TILE_X
    aoff = woff = 0
    g["pieces"] = []
    for start, c0, _, cp in _pieces(groups):
        sp = 2 * cp
        areg = _round(g["box_x"] * sp, ALIGN)
        g["pieces"].append({"group": 0 if start == 0 else 1, "c0": c0,
                            "cp": cp, "sp": sp, "aoff": aoff, "areg": areg,
                            "woff": woff})
        aoff += g["nseg"] * areg
        woff += _round(cout * sp, ALIGN)
    g.update(row=aoff, wtap=woff)
    fit = (SMEM_LIMIT - ALIGN - 9 * woff) // (aoff + 16)
    assert fit >= ROWS + 2
    g["slots"] = min(fit, MAX_SLOTS)
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


def _kernel_walk(xs, packed, bias, act, dil):
    """The kernel's strips, ring of halo rows and descriptors on numpy
    float32 arrays holding bf16 values, the row groups in order: a halo
    row is loaded when a group first needs it, into the next slot of the
    ring, which must hold no row still to be read (its readers all
    arrived: else the kernel's producer would wait forever); NaN where no
    TMA box writes."""
    groups = [x.float().numpy() for x in xs]
    bsz, h, w, _ = groups[0].shape
    cout = bias.shape[0]
    g = _plan(bsz, h, w, dil, [x.shape[-1] for x in groups], cout)
    wsm = packed.float().numpy().reshape(-1)
    ring = np.full(g["slots"] * g["row"] // 2, np.nan, np.float32)
    owed = [0] * g["slots"]  # arrivals a slot still waits for
    out = np.full((bsz, h, w, cout), np.nan, np.float32)
    rc = 0
    for t in range(g["nstrips"]):
        xt, t2 = t % g["xtiles"], t // g["xtiles"]
        c, t2 = t2 % g["chunks"], t2 // g["chunks"]
        p, b = t2 % g["phases"], t2 // g["phases"]
        n = -(-(h - p) // dil) - c * STRIP_ROWS
        if n <= 0:
            continue
        ngroups = -(-min(n, STRIP_ROWS) // ROWS)
        x0, y0 = xt * TILE_X, p + c * STRIP_ROWS * dil
        loaded = 0

        def load(j):
            # the TMA boxes of halo row j: (CP channels, box_x pixels, 1
            # row, 1 image) land pixel-major, swizzled; zeros outside
            s = (rc + j) % g["slots"]
            assert owed[s] == 0, "a slot refilled before it was read"
            owed[s] = 2
            y = y0 + (j - 1) * dil
            for pc in g["pieces"]:
                xg = groups[pc["group"]]
                for k in range(g["nseg"]):
                    x = x0 - dil if g["nseg"] == 1 else x0 + (k - 1) * dil
                    box = np.zeros((g["box_x"], pc["cp"]), np.float32)
                    xx = np.arange(x, x + g["box_x"])
                    ok = (xx >= 0) & (xx < w)
                    cw = min(pc["cp"], xg.shape[-1] - pc["c0"])
                    if 0 <= y < h:
                        box[ok, :cw] = xg[b, y, xx[ok],
                                          pc["c0"]:pc["c0"] + cw]
                    dst = s * g["row"] + pc["aoff"] + k * pc["areg"]
                    el = _swizzled(2 * box.size, pc["sp"] // 16 - 1)[::2]
                    ring[(dst + el) // 2] = box.reshape(-1)

        for q in range(ngroups):
            while loaded < q * ROWS + ROWS + 2:
                load(loaded)
                loaded += 1
            slot = [(rc + q * ROWS + j) % g["slots"]
                    for j in range(ROWS + 2)]
            for k in range(ROWS):
                acc = np.zeros((TILE_X, cout), np.float32)
                for tap in range(9):
                    dy, dx = tap // 3, tap % 3
                    for pc in g["pieces"]:
                        sp = pc["sp"]
                        a0 = slot[k + dy] * g["row"] + pc["aoff"] + (
                            dx * dil * sp if g["nseg"] == 1
                            else dx * pc["areg"])
                        b0 = tap * g["wtap"] + pc["woff"]
                        for kk in range(pc["cp"] // 16):
                            am = _operand(ring, a0 + 32 * kk, sp, TILE_X)
                            bm = _operand(wsm, b0 + 32 * kk, sp, cout)
                            acc += am @ bm.T
                y = y0 + (q * ROWS + k) * dil
                if y < h:
                    n_x = min(TILE_X, w - x0)
                    out[b, y, x0:x0 + n_x] = acc[:n_x] + bias
            for j in range(ROWS + 2):
                owed[slot[j]] -= 3 - _readers(q * ROWS + j, ngroups)
                assert owed[slot[j]] >= 0
        assert loaded == ROWS * ngroups + 2
        rc += loaded
    assert not any(owed), "rows left unreleased"
    return tmx.ACTS[act](torch.from_numpy(out))


@pytest.mark.parametrize("case", sorted(_CASES))
def test_kernel_walk_over_packed_weights_matches_plain(case):
    """bf16, the kernel's dtype; every output written once and finite."""
    xs, wt, b, act, dil = _layer(case, torch.bfloat16)
    groups = tuple(x.shape[-1] for x in xs)
    got = _kernel_walk(xs, tmx.pack_conv_weights_wgmma(wt, groups),
                       b.numpy(), act, dil)
    assert bool(torch.isfinite(got).all())
    assert_within(got.to(torch.bfloat16),
                  _reference(xs, wt, b, act, dil, torch.bfloat16),
                  torch.bfloat16)


@pytest.mark.parametrize("groups,cout", [((24,), 24), ((32, 32), 32),
                                         ((8, 40), 8), ((16,), 16),
                                         ((96,), 24)])
def test_packed_weights_pad_with_zero_rows(groups, cout):
    wt = torch.randn(cout, sum(groups), 3, 3)
    packed = tmx.pack_conv_weights_wgmma(wt, groups)
    assert packed.dtype == torch.bfloat16 and packed.shape[0] == 9
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
