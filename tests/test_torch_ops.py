"""The port's plain ops against the JAX package's, on the same random
inputs (numpy, seeded). Bar: atol 1e-6, as the JAX kernel tests hold their
kernels to the jnp path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import core as jcore
from low_light_image_enhancement_tpu import blocks as jblocks
from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.ops import colorspace as jcs
from low_light_image_enhancement_tpu.ops import curves as jcurves
from low_light_image_enhancement_tpu.ops import denoise as jdn
from low_light_image_enhancement_tpu.ops import filters as jf
from low_light_image_enhancement_tpu_torch import blocks as tblocks
from low_light_image_enhancement_tpu_torch import core as tcore
from low_light_image_enhancement_tpu_torch import pipeline as tpipe
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.kernels.striping import (
    plan_canvas,
)
from low_light_image_enhancement_tpu_torch.ops import colorspace as tcs
from low_light_image_enhancement_tpu_torch.ops import curves as tcurves
from low_light_image_enhancement_tpu_torch.ops import denoise as tdn
from low_light_image_enhancement_tpu_torch.ops import filters as tf
from low_light_image_enhancement_tpu_torch.ops import guided as tguided

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

ATOL = 1e-6


def _planes(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_normalize_u8_matches():
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16)
    got = tcs.normalize_u8(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jcs.normalize_u8(jnp.asarray(x))))


def test_quantize_u8_matches_and_rounds_ties_to_even():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.random(4096, dtype=np.float32),
                        np.float32([-0.1, 0.0, 1.0, 1.2])])
    np.testing.assert_array_equal(
        tcs.quantize_u8(torch.from_numpy(x)).numpy(),
        np.asarray(jcs.quantize_u8(jnp.asarray(x))))
    # float32 inputs whose product with 255 is exactly k + 0.5
    ties = []
    for k in range(255):
        v = np.float32((k + 0.5) / 255.0)
        for c in (np.nextafter(v, np.float32(0)), v,
                  np.nextafter(v, np.float32(1))):
            if np.float32(c) * np.float32(255.0) == np.float32(k + 0.5):
                ties.append((np.float32(c), k))
    assert len(ties) > 50
    vals = np.array([c for c, _ in ties], np.float32)
    even = np.array([k + (k % 2) for _, k in ties], np.uint8)
    np.testing.assert_array_equal(
        tcs.quantize_u8(torch.from_numpy(vals)).numpy(), even)
    np.testing.assert_array_equal(
        np.asarray(jcs.quantize_u8(jnp.asarray(vals))), even)


@pytest.mark.parametrize("dy,dx", [(1, 0), (0, -2), (-1, 3), (2, 2)])
def test_roll2d_and_shift2d_match(dy, dx):
    x = _planes((2, 9, 13))
    np.testing.assert_array_equal(
        tf.roll2d(torch.from_numpy(x), dy, dx).numpy(),
        np.asarray(jf.roll2d(jnp.asarray(x), dy, dx)))
    np.testing.assert_array_equal(
        tf.shift2d(torch.from_numpy(x), dy, dx).numpy(),
        np.asarray(jf.shift2d(jnp.asarray(x), dy, dx)))


@pytest.mark.parametrize("radius,sigma", [(2, 1.0), (3, 1.7)])
def test_gaussian_taps_and_separable_blur_match(radius, sigma):
    assert tf.gaussian_kernel_1d(radius, sigma) == \
        jf.gaussian_kernel_1d(radius, sigma)
    x = _planes((2, 24, 40), seed=2)
    for tshift, jshift in ((tf.roll2d, jf.roll2d), (tf.shift2d, jf.shift2d)):
        _close(tf.separable_blur(torch.from_numpy(x), radius, sigma, tshift),
               jf.separable_blur(jnp.asarray(x), radius, sigma, jshift))


@pytest.mark.parametrize("kind", ["exp", "epan"])
@pytest.mark.parametrize("guide,taps", [
    ("perchannel", "full"), ("luma", "full"),
    ("perchannel", "sep"), ("luma", "sep"),
])
def test_bilateral_cores_match(guide, taps, kind):
    x = _planes((2, 3, 20, 36), seed=3)
    inv2s2 = 1.0 / (2.0 * 0.2 * 0.2)
    for strength in (1.0, 0.6):
        for tshift, jshift in ((tf.roll2d, jf.roll2d),
                               (tf.shift2d, jf.shift2d)):
            _close(
                tdn.denoise_planar(torch.from_numpy(x), inv2s2, strength,
                                   tshift, kind, guide, taps),
                jdn.denoise_planar(jnp.asarray(x), inv2s2, strength, jshift,
                                   kind, guide, taps))


def test_guided_taps_raise_not_ported():
    """The guided cores run (tests/test_torch_guided.py) and every method
    takes them since K1's, K3's and K4's guided tails were ported; the
    cores bind the radius and eps they are given, and an unknown tap
    form raises."""
    x = torch.from_numpy(np.random.default_rng(13).random(
        (3, 20, 24), dtype=np.float32))
    core1, corej = tdn.plane_cores("luma", "guided", 4, 1e-2)
    assert callable(core1) and callable(corej)
    torch.testing.assert_close(
        core1(x[0], 0.0, 0.7, tf.roll2d),
        tguided.guided_core_shift(x[0], 1e-2, 0.7, tf.roll2d, 4),
        rtol=0, atol=0)
    for method in ("retinex", "curve", "hybrid"):
        tpipe.EnhancePipeline(PipelineConfig(method=method,
                                             denoise_taps="guided"),
                              device="cpu")
    with pytest.raises(ValueError):
        tdn.plane_cores("luma", "box")


@pytest.mark.parametrize("ds", [2, 4, 8])
def test_upsample_int_matches_bit_for_bit(ds):
    x = np.random.default_rng(10).uniform(-1, 1, (2, 8, 3, 6, 10)) \
        .astype(np.float32)
    for axis in (-1, -2):
        for tshift, jshift in ((tf.shift2d, jf.shift2d),
                               (tf.roll2d, jf.roll2d)):
            np.testing.assert_array_equal(
                tf.upsample_int(torch.from_numpy(x), ds, axis,
                                tshift).numpy(),
                np.asarray(jf.upsample_int(jnp.asarray(x), ds, axis,
                                           jshift)))
        np.testing.assert_array_equal(
            tf.upsample_phase((12, 16), ds, axis + 2).numpy(),
            np.asarray(jf.upsample_phase((12, 16), ds, axis + 2,
                                         jnp.float32)))


def test_lowres_downsample_matches_jax_resize():
    """The curve CNN's input at 1/ds: F.interpolate(antialias=True) against
    jax.image.resize(method="bilinear"), which antialiases when it shrinks.
    The two sum the same weights in another order: within 2.4e-7 (found
    1.2e-7)."""
    x = _planes((2, 3, 32, 64), seed=11)
    for ds in (2, 4, 8):
        cfg = PipelineConfig(method="curve", curve_downsample=ds)
        got = tblocks.F.interpolate(
            torch.from_numpy(x), size=(32 // ds, 64 // ds), mode="bilinear",
            antialias=True, align_corners=False)
        want = jax.image.resize(jnp.asarray(x), (2, 3, 32 // ds, 64 // ds),
                                method="bilinear")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2.4e-7,
                                   rtol=0)
        params = {f"c{i}": {"w": torch.zeros(o, c, 3, 3),
                            "b": torch.zeros(o)}
                  for i, (c, o) in enumerate([(3, 4), (4, 4), (4, 4), (4, 4),
                                              (8, 4), (8, 4), (8, 24)], 1)}
        maps = tblocks._curve_maps_lowres(torch.from_numpy(x), cfg, params)
        assert maps.shape == (2, 8, 3, 32 // ds, 64 // ds)
        full = tblocks._curve_maps(torch.from_numpy(x), cfg, params)
        assert full.shape == (2, 8, 3, 32, 64)


@pytest.mark.parametrize("method", ["curve", "hybrid", "retinex", "fcn"])
def test_block_geometry_matches_jax_at_every_downsample(method):
    for ds in (1, 2, 4, 8):
        kw = dict(method=method, curve_downsample=ds)
        t, j = PipelineConfig(**kw), JConfig(**kw)
        assert tblocks.cnn_radius(t) == jblocks.cnn_radius(j)
        assert tblocks.learned_halo(t) == jblocks.learned_halo(j)
        assert tblocks.single_block_halo(t) == jblocks.single_block_halo(j)
        for h, w in ((40, 72), (33, 47), (1080, 1920)):
            assert tblocks.block_geometry(t, h, w) == \
                jblocks.block_geometry(j, h, w)


def test_apply_curves_matches():
    x = _planes((2, 3, 12, 20), seed=4)
    a = np.random.default_rng(5).uniform(-1, 1, (2, 8, 3, 12, 20)) \
        .astype(np.float32)
    _close(tcurves.apply_curves(torch.from_numpy(x), torch.from_numpy(a)),
           jcurves.apply_curves(jnp.asarray(x), jnp.asarray(a)))


@pytest.mark.parametrize("kw", [
    dict(), dict(gamma=0.6, illum_eps=3e-3, blur_radius=3, blur_sigma=1.5),
])
def test_illumination_boost_matches(kw):
    x = _planes((2, 3, 24, 40), seed=6)
    _close(tcore.illumination_boost(torch.from_numpy(x), PipelineConfig(**kw)),
           jcore.illumination_boost(jnp.asarray(x), JConfig(**kw)))


@pytest.mark.parametrize("kw", [
    dict(), dict(denoise_guide="perchannel", denoise_taps="full"),
    dict(method="hybrid", denoise_kernel="epan"),
    dict(method="curve", denoise_strength=0.0),
])
def test_enhance_core_padded_matches(kw):
    x = _planes((2, 3, 24, 40), seed=7)
    maps = None
    if kw.get("method") in ("curve", "hybrid"):
        maps = np.random.default_rng(8).uniform(-1, 1, (2, 8, 3, 24, 40)) \
            .astype(np.float32)
    got = tcore.enhance_core_padded(
        torch.from_numpy(x), PipelineConfig(**kw),
        None if maps is None else torch.from_numpy(maps))
    want = jcore.enhance_core_padded(
        jnp.asarray(x), JConfig(**kw),
        None if maps is None else jnp.asarray(maps))
    _close(got, want)


@pytest.mark.parametrize("h,w,margin", [(30, 27, 4), (8, 125, 16)])
def test_pipeline_pad_planar_matches_jax(h, w, margin):
    """pipeline.pad_planar (core's) against the JAX package's on the
    plan's canvas, u8 and f32, Δ 0."""
    plan = plan_canvas(h, w, margin)
    x = _planes((2, 3, h, w), seed=h)
    for arr in (x, np.round(x * 255).astype(np.uint8)):
        got = tpipe.pad_planar(torch.from_numpy(arr), plan, h, w)
        want = jpipe.pad_planar(jnp.asarray(arr), plan, h, w)
        assert got.shape == (2, 3, plan.padded_h, plan.padded_w)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pad_edge_is_replicate_padding():
    x = np.arange(2 * 3 * 5 * 7, dtype=np.uint8).reshape(2, 3, 5, 7)
    got = tcore.pad_edge(torch.from_numpy(x), 2, 3, 4, 1).numpy()
    want = np.pad(x, ((0, 0), (0, 0), (2, 3), (4, 1)), mode="edge")
    np.testing.assert_array_equal(got, want)


def test_replicate_margin_cols_and_mask_extent_match():
    """Also under the JAX names: blocks.replicate_margin_cols, Δ 0."""
    x = _planes((2, 3, 30, 40), seed=9)
    want = np.asarray(jblocks.replicate_margin_cols(jnp.asarray(x), 27, 4))
    for fn in (tcore.replicate_margin_cols, tblocks.replicate_margin_cols):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(x), 27, 4).numpy(), want)
    np.testing.assert_array_equal(
        tblocks._mask_extent(torch.from_numpy(x), -8, 14, 27, 4).numpy(),
        np.asarray(jblocks._mask_extent(jnp.asarray(x), -8, 14, 27, 4)))
