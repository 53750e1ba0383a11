"""The blur plane past the tiles (``blur_illumination``,
``csrc/fused_enhance.cu``) on the CPU: a model of its walk and the mirror
of its plan.

The kernel stages max RGB of a 32 x 128 tile of the plane's rows and
image columns plus R on each side, clamped into the image, then runs the
vertical pass in column strips of 4 rows and the horizontal one in row
segments of 16, each in tap blocks (of 16, then one each of 8, 4, 2 and
1 for the rest) from a window in registers; where a tile would pass its shared-memory cap the plan cuts the
staged rows and the vertical sums' columns into chunks, walked bottom-up
and right to left, each tap block in the chunk that holds its window's
last row (column). ``model_blur`` repeats that walk in plain torch (the
staged region, the chunks, the strips and the blocks in their order, each
sum from -0) over every tile at once. It is held bit for bit
(``torch.equal`` and the zeros' signs) to ``blur_illumination_plain`` for
R 9, 16 and 32, e 0 and 8, sizes that end mid-tile, HWC and planar, u8 and
f32, under the kernel's plan and under plans cut to small caps so that the
rows and the columns are chunked. The plain version is held to the JAX
package's ``separable_blur`` on the edge-padded canvas. ``blur_plan``
mirrors ``llie_blur_plan``; ``chip_smoke.py`` holds the two equal on the
card, and the kernel itself to the plain version there (so this module
imports no JAX at module level, for the card's host).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.core import pad_edge
from low_light_image_enhancement_tpu_torch.kernels import fused_enhance as fe
from low_light_image_enhancement_tpu_torch.ops.filters import (
    gaussian_kernel_1d,
)

# ---------------------------------------------------------- the plan ---- #
# Mirror of fused_enhance.cu's blur::Plan (llie_blur_plan).

TH, TW, NT = 32, 128, 256      # plane rows and columns a tile, threads
VS, HS, KB = 4, 16, 16         # strip rows, segment columns, taps a block
OVR, OVC = VS + KB - 2, HS + KB - 2
CAP_BYTES, CHUNK_COLS = 112 * 1024, 192
SMEM_PER_BLOCK = 227 * 1024    # H100: a block's opt-in maximum
SMEM_PER_SM = 228 * 1024       # and an SM's, 1 KB of it kept a block


def make_plan(r: int, cap_bytes: int = CAP_BYTES,
              chunk_cols: int = CHUNK_COLS) -> dict:
    """The tile's plan at radius r (the kernel's at the default cap and
    chunk width, which is also the staged rows' pitch; sV's is one more;
    the output tile takes the staged rows' place at the end)."""
    rows, cols = TH + 2 * r, TW + 2 * r
    vcols = min(cols, chunk_cols)
    cw = cols if vcols == cols else vcols - OVC
    # sV, and with column chunks the horizontal sums kept between them
    fixed = TH * (chunk_cols + 1) + (TH * (TW + 4) if cw < cols else 0)
    rcap = (cap_bytes // 4 - fixed) // chunk_cols
    srows = min(rows, rcap)
    cr = rows if srows == rows else srows - OVR
    return dict(R=r, nb=(2 * r + KB) // KB, srows=srows, cr=cr,
                nrc=-(-rows // cr), vcols=vcols, cw=cw, ncc=-(-cols // cw),
                pm=chunk_cols, pv=chunk_cols + 1,
                smem=4 * (srows * chunk_cols + fixed))


def blur_plan(radius: int, form: int, what: int) -> int:
    """llie_blur_plan's values 0-12: 0 shared memory bytes, 1 staged rows a
    row chunk holds, 2 rows it owns, 3 row chunks, 4 columns a column chunk
    computes, 5 columns it owns, 6 column chunks, 7 and 8 the two pitches,
    9 the taps' floats, 10-12 the tile's rows, columns and threads."""
    if radius < 1 or not 0 <= form <= 3:
        return -1
    p = make_plan(radius)
    return {0: p["smem"], 1: p["srows"], 2: p["cr"], 3: p["nrc"],
            4: p["vcols"], 5: p["cw"], 6: p["ncc"], 7: p["pm"], 8: p["pv"],
            9: p["nb"] * KB, 10: TH, 11: TW, 12: NT}.get(what, -1)


def test_blur_plan_fits_the_opt_in_and_covers_the_tile():
    """Every radius to 300 and a few far past it: two blocks an SM, the
    chunks cover the tile's staged rows and columns, the pitches suit the
    float4 staging and the lanes-as-rows pass, and the wrapper's taps fill
    whole blocks; the radii the smoke and the timings run are one chunk
    (r 16, 32) or chunked in rows and columns (r 64, 128)."""
    for r in list(range(1, 301)) + [500, 1000, 2000]:
        p = make_plan(r)
        assert p["smem"] <= CAP_BYTES <= SMEM_PER_BLOCK
        assert 2 * (p["smem"] + 1024) <= SMEM_PER_SM
        assert p["nrc"] * p["cr"] >= TH + 2 * r > (p["nrc"] - 1) * p["cr"]
        assert p["ncc"] * p["cw"] >= TW + 2 * r > (p["ncc"] - 1) * p["cw"]
        assert p["cr"] + (OVR if p["nrc"] > 1 else 0) <= p["srows"]
        assert p["cw"] + (OVC if p["ncc"] > 1 else 0) <= p["vcols"]
        assert p["pm"] % 4 == 0 and p["pv"] % 2 == 1
        assert blur_plan(r, 1, 9) == len(fe._device_taps(
            PipelineConfig(blur_radius=r, blur_sigma=r / 3), "cpu"))
    assert (make_plan(16)["nrc"], make_plan(16)["ncc"]) == (1, 1)
    assert (make_plan(32)["nrc"], make_plan(32)["ncc"]) == (1, 1)
    assert (make_plan(64)["nrc"], make_plan(64)["ncc"]) == (3, 2)
    assert (make_plan(128)["nrc"], make_plan(128)["ncc"]) == (4, 3)
    assert blur_plan(0, 1, 0) == blur_plan(16, 4, 0) == -1
    assert blur_plan(16, 1, 13) == -1     # device values: the card's only


# ---------------------------------------------------------- the walk ---- #

def _blocks(base: int, lo: int, hi: int, r: int):
    """(first tap, taps) of the tap blocks whose anchor base - first lies in
    [lo, hi), in tap order: the 2r + 1 taps as blocks of KB, then the rest
    as one block each of 8, 4, 2 and 1 where the rest has that bit."""
    nfull = (2 * r + 1) // KB
    n0 = 0 if base < hi else (base - hi) // KB + 1
    n1 = -1 if base < lo else min((base - lo) // KB, nfull - 1)
    out = [(n * KB, KB) for n in range(n0, n1 + 1)]
    k, rest = nfull * KB, 2 * r + 1 - nfull * KB
    for size in (8, 4, 2, 1):
        if rest & size:
            if lo <= base - k < hi:
                out.append((k, size))
            k += size
    return out


def model_blur(x: torch.Tensor, cfg: PipelineConfig, e: int, hwc: bool,
               plan: dict) -> torch.Tensor:
    """The kernel's walk over every tile of the (B, H + 2e, W + 2e) plane
    at once: each chunk's staged max RGB (rows and columns clamped into the
    image), the vertical strips' tap blocks whose anchors the row chunk
    owns, then the horizontal segments' blocks whose anchors the column
    chunk owns, each term taps[k] * v added in k order."""
    xf = fe._to_float(x.permute(0, 3, 1, 2) if hwc else x)
    mx = torch.amax(xf, dim=-3)                       # (B, H, W)
    b, h, w = mx.shape
    r = plan["R"]
    nr, nc = TH + 2 * r, TW + 2 * r
    taps = [torch.tensor(t, dtype=torch.float32)
            for t in gaussian_kernel_1d(r, cfg.blur_sigma)]
    he, we = h + 2 * e, w + 2 * e
    nty, ntx = -(-he // TH), -(-we // TW)
    y0 = torch.arange(nty)[:, None] * TH - e - r      # image row of staged 0
    x0 = torch.arange(ntx)[:, None] * TW - e - r      # image col of column 0
    acc_h = torch.full((b, nty, ntx, TH, TW), -0.0)
    for cc in range(plan["ncc"]):
        chi = nc - cc * plan["cw"]
        clo = max(chi - plan["cw"], 0)
        c0 = max(clo - OVC, 0)
        cols = torch.clamp(x0 + torch.arange(c0, chi)[None, :], 0, w - 1)
        v = None
        for rc in range(plan["nrc"]):
            rhi = nr - rc * plan["cr"]
            rlo = max(rhi - plan["cr"], 0)
            s0 = max(rlo - OVR, 0)
            rows = torch.clamp(y0 + torch.arange(s0, rhi)[None, :], 0, h - 1)
            # (B, nty, staged rows, ntx, columns) -> tiles first
            st = mx[:, rows][..., cols].permute(0, 1, 3, 2, 4)
            strips = []
            for q in range(TH // VS):
                t0 = q * VS
                acc = (torch.full(st.shape[:3] + (VS, chi - c0), -0.0)
                       if rc == 0 else v[..., t0:t0 + VS, :].clone())
                base = t0 + VS - 1 + 2 * r
                for k0, size in _blocks(base, rlo, rhi, r):
                    # the block's window, rows anchor - (VS + size - 2) ..
                    # anchor, lies in the chunk's staged rows
                    assert s0 <= base - k0 - (VS + size - 2)
                    assert base - k0 < rhi
                    for u in range(size):
                        for o in range(VS):
                            row = base - k0 - (VS - 1) + o - u
                            acc[..., o, :] = (acc[..., o, :] + taps[k0 + u]
                                              * st[..., row - s0, :])
                strips.append(acc)
            v = torch.cat(strips, dim=-2)             # (B, nty, ntx, TH, nc)
        for seg in range(TW // HS):
            xs = seg * HS
            base = xs + HS - 1 + 2 * r
            for k0, size in _blocks(base, clo, chi, r):
                assert c0 <= base - k0 - (HS + size - 2)
                assert base - k0 < chi
                for u in range(size):
                    for o in range(HS):
                        col = base - k0 - (HS - 1) + o - u
                        acc_h[..., xs + o] = (acc_h[..., xs + o]
                                              + taps[k0 + u]
                                              * v[..., col - c0])
    out = acc_h.permute(0, 1, 3, 2, 4).reshape(b, nty * TH, ntx * TW)
    return out[:, :he, :we]


def _input(b, h, w, hwc, f32, seed):
    rng = np.random.default_rng(seed)
    shape = (b, h, w, 3) if hwc else (b, 3, h, w)
    if f32:
        x = rng.standard_normal(shape).astype(np.float32)
        x[np.abs(x) < 0.3] = -0.0       # negative and signed-zero maxima
        return torch.from_numpy(x)
    return torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))


def _assert_bit_equal(got, want):
    assert got.shape == want.shape
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))


@pytest.mark.parametrize("r,e,size,hwc,f32,cap", [
    (9, 0, (2, 37, 70), True, False, None),
    (9, 8, (1, 33, 65), False, True, None),
    (16, 0, (1, 40, 70), False, False, None),
    (16, 8, (2, 33, 133), True, True, None),
    (32, 0, (1, 70, 67), True, False, None),
    (32, 8, (1, 20, 101), False, False, None),
    # plans cut to small caps: rows and columns in chunks
    (9, 1, (2, 37, 150), True, False, (7728 * 4, 56)),
    (16, 8, (1, 33, 135), False, True, (9296 * 4, 72)),
    (32, 0, (1, 40, 131), True, True, (11648 * 4, 96)),
])
def test_blur_walk_equals_the_plain_version(r, e, size, hwc, f32, cap):
    cfg = PipelineConfig(blur_radius=r, blur_sigma=r / 3)
    plan = make_plan(r) if cap is None else make_plan(r, *cap)
    if cap is not None:
        assert plan["nrc"] > 1 and plan["ncc"] > 1
    x = _input(*size, hwc, f32, seed=r + e)
    _assert_bit_equal(model_blur(x, cfg, e, hwc, plan),
                      fe.blur_illumination_plain(x, cfg, e, hwc))


def test_blur_plain_equals_jax_separable_blur():
    """The plain plane is the JAX package's separable_blur with its clamped
    shifts on max RGB edge-padded by e (the same taps, order and starts),
    run eagerly: under jit XLA fuses the sums and rounds them otherwise."""
    import jax.numpy as jnp

    from low_light_image_enhancement_tpu.ops import filters as jfilters

    r, e, hwc = 9, 8, True
    cfg = PipelineConfig(blur_radius=r, blur_sigma=r / 3)
    x = _input(2, 35, 70, hwc, False, seed=r)
    got = fe.blur_illumination_plain(x, cfg, e, hwc)
    xf = x.permute(0, 3, 1, 2) if hwc else x
    l0 = pad_edge(torch.amax(fe._to_float(xf), dim=-3), e, e, e, e)
    want = jfilters.separable_blur(jnp.asarray(l0.numpy()), r,
                                   cfg.blur_sigma, jfilters.shift2d)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
