"""The port's toolkit ops (colour spaces, gaussian_blur, bilateral_denoise,
the retinex and gamma ops, the Fourier ops, autocontrast, equalize_hist
and CLAHE) against the JAX package's, on the same seeded numpy inputs. The
JAX references run under ``jax.jit``, as they run in the JAX package."""

import jax
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import ops as jops
from low_light_image_enhancement_tpu_torch import ops as tops

SHAPE = (2, 3, 24, 36)


def _rgb(shape=SHAPE, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _check(name, jfn, tfn, args, atol, eager=False, **kw):
    """``tfn`` on torch tensors within ``atol`` of jitted ``jfn`` (0:
    bit-equal; ``eager``: op by op, where XLA's fusion would contract a
    multiply and an add); the largest difference is printed."""
    ref = (lambda *a: jfn(*a, **kw))
    want = np.asarray((ref if eager else jax.jit(ref))(*args))
    got = tfn(*(torch.from_numpy(np.array(a)) for a in args), **kw).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float(np.abs(got.astype(np.float64) - want).max())
    print(f"{name}: max |d| {err:.3g}")
    if atol == 0:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _with_greys(x):
    """Random RGB with grey pixels (c == 0), black ones (v == 0) and ties
    of the max between channels, the branches of the HSV hue."""
    x = x.copy()
    x[..., 0, :4] = x[..., 1, :4] = x[..., 2, :4]
    x[..., :, 4:6, :] = 0.0
    x[..., 0, 6:8, :] = x[..., 1, 6:8, :]
    return x


@pytest.mark.parametrize("pair,atol", [
    (("rgb_to_hsv", "hsv_to_rgb"), 1e-6),
    (("rgb_to_ycbcr", "ycbcr_to_rgb"), 1e-6),
    (("rgb_to_hvi", "hvi_to_rgb"), 1e-5),
])
def test_colorspace_pairs(pair, atol):
    x = _with_greys(_rgb())
    fwd, inv = pair
    _check(fwd, getattr(jops, fwd), getattr(tops, fwd), (x,), atol)
    # the inverse on the reference's forward output, so both start equal
    y = np.asarray(jax.jit(getattr(jops, fwd))(x))
    _check(inv, getattr(jops, inv), getattr(tops, inv), (y,), atol)


def test_hsv_every_sector():
    """hsv_to_rgb on hues across all six sectors and at their edges."""
    h = np.linspace(0.0, 1.0, 24 * 36, dtype=np.float32).reshape(24, 36)
    s = _rgb((24, 36), seed=1)
    v = _rgb((24, 36), seed=2)
    hsv = np.stack([h, s, v])[None]
    _check("hsv_to_rgb sectors", jops.hsv_to_rgb, tops.hsv_to_rgb, (hsv,),
           1e-6)


@pytest.mark.parametrize("mode", ["clamp", "wrap"])
def test_gaussian_blur_bit_equal(mode):
    x = _rgb()
    for radius, sigma in ((2, 1.0), (5, 2.5)):
        _check(f"gaussian_blur {mode} r{radius}", jops.gaussian_blur,
               tops.gaussian_blur, (x,), 0, eager=True, radius=radius,
               sigma=sigma, mode=mode)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(mode="wrap", kind="epan", guide="luma", taps="sep"),
    dict(guide="luma", taps="full", strength=0.8),
    dict(taps="guided"),
])
def test_bilateral_denoise(kw):
    _check(f"bilateral_denoise {kw}", jops.bilateral_denoise,
           tops.bilateral_denoise, (_rgb(),), 1e-6, **kw)


def test_bilateral_denoise_strength_zero_is_identity():
    x = torch.from_numpy(_rgb())
    assert tops.bilateral_denoise(x, strength=0.0) is x


def test_retinex_ops_and_gamma():
    x = _rgb() * 0.3
    _check("illumination_map", jops.illumination_map, tops.illumination_map,
           (x,), 1e-6)
    _check("illumination_map wrap r3", jops.illumination_map,
           tops.illumination_map, (x,), 1e-6, radius=3, sigma=1.5,
           mode="wrap")
    illum = np.asarray(jax.jit(jops.illumination_map)(x))
    _check("reflectance", jops.reflectance, tops.reflectance, (x, illum),
           1e-6)
    _check("retinex_enhance", jops.retinex_enhance, tops.retinex_enhance,
           (x,), 1e-6)
    _check("retinex_enhance g0.6", jops.retinex_enhance,
           tops.retinex_enhance, (x,), 1e-6, gamma=0.6, eps=1e-2)
    for g in (0.45, 2.2):
        _check(f"gamma_correct {g}", jops.gamma_correct, tops.gamma_correct,
               (_rgb() * 1.2 - 0.1,), 1e-6, gamma=g)


@pytest.mark.parametrize("preserve_dc", [False, True])
def test_fourier_amplitude_boost(preserve_dc):
    x = _rgb() * 0.4
    _check(f"fourier_amplitude_boost dc={preserve_dc}",
           jops.fourier_amplitude_boost, tops.fourier_amplitude_boost, (x,),
           1e-5, factor=1.5, preserve_dc=preserve_dc)


def test_amplitude_phase_swap():
    _check("amplitude_phase_swap", jops.amplitude_phase_swap,
           tops.amplitude_phase_swap, (_rgb(seed=1) * 0.3, _rgb(seed=2)),
           1e-5)


@pytest.mark.parametrize("per_channel", [False, True])
def test_autocontrast(per_channel):
    x = _rgb() * 0.3
    _check(f"autocontrast per_channel={per_channel}", jops.autocontrast,
           tops.autocontrast, (x,), 1e-6, per_channel=per_channel)
    _check("autocontrast 5/90", jops.autocontrast, tops.autocontrast, (x,),
           1e-6, low_pct=5.0, high_pct=90.0, per_channel=per_channel)


def test_equalize_hist_bit_equal():
    x = _rgb() * 0.5
    _check("equalize_hist", jops.equalize_hist, tops.equalize_hist, (x,), 0)
    _check("equalize_hist 64 bins", jops.equalize_hist, tops.equalize_hist,
           (x[0, 0],), 0, bins=64)


@pytest.mark.parametrize("shape,kw", [
    (SHAPE, dict()),
    ((3, 29, 41), dict(tiles=4, clip_limit=3.0)),       # odd sizes
    ((1, 3, 24, 36), dict(tiles=1)),
    ((2, 5, 7), dict(tiles=4)),    # tiny: tiles that are all padding
    ((1, 2, 6, 5), dict(tiles=8, bins=64)),
])
def test_clahe(shape, kw):
    _check(f"clahe {shape} {kw}", jops.clahe, tops.clahe,
           (_rgb(shape) * 0.5,), 1e-5, **kw)


def test_clahe_rejects_no_tiles():
    with pytest.raises(ValueError, match="tiles"):
        tops.clahe(torch.zeros(4, 4), tiles=0)


def test_ops_all_matches_the_jax_package():
    assert tops.__all__ == jops.__all__
    for name in tops.__all__:
        assert callable(getattr(tops, name)), name
