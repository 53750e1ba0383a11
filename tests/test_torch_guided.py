"""The port's guided filter (ops/guided.py), its dispatch through
ops/denoise.py and core.denoise_tail, against the JAX package's, on the
same random planes (numpy, seeded); and a CPU model of K5's guided walk
(csrc/guided.cuh) against K5's plain version.

Bars: the integral-image public ops within 1e-6 (cumsum sums in another
order in the two frameworks); the shift cores bit-equal, since both run
the same eager ops in the same order (JAX eagerly, not under jit, which
fuses and rounds some sums differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.ops import denoise as jdn
from low_light_image_enhancement_tpu.ops import filters as jf
from low_light_image_enhancement_tpu.ops import guided as jg
from low_light_image_enhancement_tpu_torch import core as tcore
from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.kernels.tiled_denoise import (
    tiled_denoise_plain,
)
from low_light_image_enhancement_tpu_torch.ops import denoise as tdn
from low_light_image_enhancement_tpu_torch.ops import filters as tf
from low_light_image_enhancement_tpu_torch.ops import guided as tg


def _planes(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_box_mean_matches(radius):
    x = _planes((2, 3, 13, 21), seed=radius)
    np.testing.assert_allclose(
        tg.box_mean(torch.from_numpy(x), radius).numpy(),
        np.asarray(jg.box_mean(jnp.asarray(x), radius)), rtol=0, atol=1e-6)


def test_guided_filter_and_denoise_match():
    x = _planes((2, 3, 16, 24), seed=4)
    guide = _planes((2, 1, 16, 24), seed=5)
    np.testing.assert_allclose(
        tg.guided_filter(torch.from_numpy(x), torch.from_numpy(guide), 2,
                         1e-2).numpy(),
        np.asarray(jg.guided_filter(jnp.asarray(x), jnp.asarray(guide), 2,
                                    1e-2)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tg.guided_denoise(torch.from_numpy(x), 3, 1e-2, 0.7).numpy(),
        np.asarray(jg.guided_denoise(jnp.asarray(x), 3, 1e-2, 0.7)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_shift_cores_bit_equal(radius):
    x = _planes((3, 24, 40), seed=10 + radius)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        tg.box_mean_shift(tx, radius, tf.roll2d).numpy(),
        np.asarray(jg.box_mean_shift(jx, radius, jf.roll2d)))
    np.testing.assert_array_equal(
        tg.guided_core_shift(tx[0], 1e-2, 0.8, tf.roll2d, radius).numpy(),
        np.asarray(jg.guided_core_shift(jx[0], 1e-2, 0.8, jf.roll2d,
                                        radius)))
    got = tg.guided_joint_core_shift([tx[c] for c in range(3)], 1e-2, 1.0,
                                     tf.roll2d, radius)
    want = jg.guided_joint_core_shift([jx[c] for c in range(3)], 1e-2, 1.0,
                                      jf.roll2d, radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("guide", ["luma", "perchannel"])
def test_denoise_planar_guided_matches(guide):
    x = _planes((2, 3, 20, 36), seed=20)
    got = tdn.denoise_planar(torch.from_numpy(x), 12.5, 1.0, tf.roll2d,
                             "exp", guide, "guided", 3, 1e-2)
    want = jdn.denoise_planar(jnp.asarray(x), 12.5, 1.0, jf.roll2d, "exp",
                              guide, "guided", 3, 1e-2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_denoise_tail_passes_the_guided_radius_and_eps():
    """core.denoise_tail runs the config's guided_radius and guided_eps; the
    cores' own defaults (r=2, eps 3e-3) are not the config's (eps 1e-2)."""
    x = _planes((1, 3, 24, 40), seed=21)
    cfg = PipelineConfig(method="decom", denoise_taps="guided",
                         guided_radius=4)
    got = tcore.denoise_tail(torch.from_numpy(x), cfg).numpy()
    inv2s2 = 1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma)
    want = jdn.denoise_planar(jnp.asarray(x), inv2s2, cfg.denoise_strength,
                              jf.roll2d, cfg.denoise_kernel,
                              cfg.denoise_guide, "guided", 4, 1e-2)
    np.testing.assert_array_equal(got, np.asarray(want))
    defaults = jdn.denoise_planar(jnp.asarray(x), inv2s2,
                                  cfg.denoise_strength, jf.roll2d,
                                  cfg.denoise_kernel, cfg.denoise_guide,
                                  "guided")
    assert np.abs(got - np.asarray(defaults)).max() > 1e-3


# ------------------------------------------- K5's guided walk, modelled #
# csrc/guided.cuh on the CPU: 32 x 32 output tiles, each reading its input
# with a 2r ring clamped into the block's window; every box mean a vertical
# then a horizontal pass of items of 8 outputs (the last item of a pass
# moved back to end at the pass's edge), each output summed from its item's
# window as the kernel's registers hold it: the centre, then -t and +t, t
# ascending, times k.

GT, GP = 32, 8


def _run_starts(n):
    return [min(run * GP, n - GP) for run in range(-(-n // GP))]


def _pass(src, nout, r, k):
    """One pass along dim 0 of ``src`` (nout + 2r rows): item by item."""
    out = torch.full((nout,) + tuple(src.shape[1:]), float("nan"))
    for r0 in _run_starts(nout):
        w = src[r0:r0 + GP + 2 * r]
        for i in range(GP):
            acc = w[i + r]
            for t in range(1, r + 1):
                acc = (acc + w[i + r - t]) + w[i + r + t]
            out[r0 + i] = acc * k
    assert not bool(torch.isnan(out).any()), "an output no item wrote"
    return out


def _box(src, nh, nw, r, k):
    """Vertical pass to nh rows, then horizontal to nw columns."""
    return _pass(_pass(src, nh, r, k).t(), nw, r, k).t()


def _guided_walk(y, cfg, halo, rows):
    """The kernel's tiles over the f32 block ``y`` -> (B, 3, rows, WB)."""
    r, eps, s = cfg.guided_radius, cfg.guided_eps, cfg.denoise_strength
    k = 1.0 / (2 * r + 1)
    joint = cfg.denoise_guide == "luma"
    m = canvas_margin(cfg)
    b, _, _, wb = y.shape
    sh, sw = GT + 2 * r, GT + 2 * r
    out = torch.full((b, 3, rows, wb), float("nan"))
    lo, hi = halo - m, halo + rows + m - 1
    for bi in range(b):
        for y0 in range(0, rows, GT):
            for x0 in range(0, wb, GT):
                ri = torch.clamp(torch.arange(halo + y0 - 2 * r,
                                              halo + y0 + GT + 2 * r), lo, hi)
                ci = torch.clamp(torch.arange(x0 - 2 * r, x0 + GT + 2 * r),
                                 0, wb - 1)
                xs = y[bi][:, ri][:, :, ci]
                if joint:
                    g = (xs[0] + xs[1] + xs[2]) * (1.0 / 3.0)
                    mg = _box(g, sh, sw, r, k)
                    var = _box(g * g, sh, sw, r, k) - mg * mg
                    inv = 1.0 / (var + eps)
                for c in range(3):
                    p = xs[c]
                    mp = _box(p, sh, sw, r, k)
                    if joint:
                        cov = _box(g * p, sh, sw, r, k) - mg * mp
                        a = cov * inv
                        bb = mp - a * mg
                    else:
                        var = _box(p * p, sh, sw, r, k) - mp * mp
                        a = var / (var + eps)
                        bb = mp - a * mp
                    x = p[2 * r:2 * r + GT, 2 * r:2 * r + GT]
                    guide = g[2 * r:2 * r + GT, 2 * r:2 * r + GT] if joint \
                        else x
                    q = _box(a, GT, GT, r, k) * guide + _box(bb, GT, GT, r, k)
                    o = torch.clamp(x + s * (q - x), 0.0, 1.0)
                    nr, nc = min(GT, rows - y0), min(GT, wb - x0)
                    out[bi, c, y0:y0 + nr, x0:x0 + nc] = o[:nr, :nc]
    return out


@pytest.mark.parametrize("guide", ["luma", "perchannel"])
@pytest.mark.parametrize("radius", [1, 2, 4, 8])
def test_guided_walk_bit_equal_to_tiled_denoise_plain(radius, guide):
    """The kernel's order of sums is the plain version's, so its walk
    equals ``tiled_denoise_plain`` bit for bit on every column whose
    window lies inside the block (where the kernel clamps and the plain
    version wraps, 2r from the sides: the caller crops those)."""
    cfg = PipelineConfig(method="decom", denoise_taps="guided",
                         guided_radius=radius, denoise_guide=guide)
    m = canvas_margin(cfg)
    y = torch.from_numpy(_planes((2, 3, 40, 72), seed=30 + radius))
    rows = 40 - 2 * m
    got = _guided_walk(y, cfg, m, rows)
    want = tiled_denoise_plain(y, cfg, m, rows)
    keep = slice(2 * radius, 72 - 2 * radius)
    assert torch.equal(got[..., keep], want[..., keep])
