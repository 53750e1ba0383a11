"""The forms of K1, K3 and K4 beyond the default ones: the guided tail (r 2
and 4, the luma and the per-channel guide), f32 I/O, blur radii past the
kernels' tiles (``MAX_BLUR_RADIUS``), and K1's ``stages``; each plain
version against the JAX package's Pallas kernel in interpret mode on the
same seeded inputs, as ``tests/kernels/test_guided_tail.py`` runs them.
Then ``enhance_learned_block`` on f32 blocks against the JAX function.

Bars: u8 max |du8| <= 1 with a changed share < 1e-3; f32 within 1e-5. The
CUDA kernels are held to these plain versions on the card by
chip_smoke.py; the plane that stands in for the kernels' own blur past
MAX_BLUR_RADIUS (``blur_illumination``) is held here to the canvas blur.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import blocks as jblocks
from low_light_image_enhancement_tpu import video as jvideo
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.config import canvas_margin
from low_light_image_enhancement_tpu_torch import blocks as tblocks
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.core import pad_edge
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.kernels import fused_enhance as fe
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)
from low_light_image_enhancement_tpu_torch.ops.filters import (
    roll2d,
    separable_blur,
)
from test_torch_fused_enhance import (
    _assert_io_close,
    _curve_block,
    _gain,
    _jax_k1,
)


def _f32(x):
    return x.astype(np.float32) / 255.0


def _cropped(got, want, m, w):
    _assert_io_close(np.asarray(got)[..., m:m + w],
                     np.asarray(want)[..., m:m + w])


# --------------------------------------------------------------------- K1 #

@pytest.mark.parametrize("kw,size,f32", [
    (dict(guided_radius=2), (40, 72), False),
    (dict(guided_radius=4), (33, 47), False),
    (dict(guided_radius=4, denoise_guide="perchannel"), (40, 72), False),
    (dict(guided_radius=4, guided_eps=3e-3), (33, 47), True),
    # the guided kernel's 32 x 32 tile: heights and widths one past it and
    # one short of two, at r 2 and 4 in both guides
    (dict(guided_radius=2), (33, 63), False),
    (dict(guided_radius=2, denoise_guide="perchannel"), (63, 33), False),
    (dict(guided_radius=4), (63, 33), False),
    (dict(guided_radius=4, denoise_guide="perchannel"), (33, 63), False),
])
def test_k1_guided_matches_jax_kernel(kw, size, f32):
    lows, _ = synth_batch(2, *size, seed=20)
    x = _f32(lows) if f32 else lows
    kw = dict(denoise_taps="guided", **kw)
    got = fe.fused_retinex(torch.from_numpy(x), PipelineConfig(**kw))
    assert got.shape == x.shape
    _assert_io_close(got.numpy(), _jax_k1(x, kw))


@pytest.mark.parametrize("stages", [(), ("blur", "boost"),
                                    ("boost", "denoise"), ("denoise",)])
def test_k1_stages_match_jax_kernel(stages):
    """The truncated forms JAX's scripts/profile_stages.py differences, and
    two that keep the tail without the blur or the boost."""
    lows, _ = synth_batch(1, 33, 47, seed=21)
    got = fe.fused_retinex(torch.from_numpy(lows), PipelineConfig(),
                           stages=stages)
    _assert_io_close(got.numpy(), _jax_k1(lows, {}, stages))


@pytest.mark.parametrize("kw", [
    dict(blur_radius=9),
    dict(blur_radius=16, blur_sigma=6.0, denoise_taps="guided"),
])
def test_k1_wide_blur_matches_jax_kernel(kw):
    lows, _ = synth_batch(1, 40, 72, seed=22)
    got = fe.fused_retinex(torch.from_numpy(lows), PipelineConfig(**kw))
    _assert_io_close(got.numpy(), _jax_k1(lows, kw))


def test_stages_are_checked():
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="subset"):
        fe.fused_retinex(x, PipelineConfig(), stages=("blur", "gamma"))


@pytest.mark.parametrize("e,radius", [(1, 9), (8, 16)])
def test_blur_plane_equals_the_canvas_blur(e, radius):
    """blur_illumination's plane (clamped reads, e rings past the image)
    equals the blur the kernels' plain versions run on the replicate-padded
    canvas with wrap shifts, at every position the margin keeps away from
    the wrap: the plane the LPLANE forms read in place of their own blur."""
    cfg = PipelineConfig(blur_radius=radius, blur_sigma=radius / 3)
    lows, _ = synth_batch(2, 24, 40, seed=23)
    x = torch.from_numpy(lows)
    got = fe.blur_illumination(x, cfg, e, hwc=True)
    assert got.shape == (2, 24 + 2 * e, 40 + 2 * e)
    pad = e + radius
    l0 = torch.amax(x.permute(0, 3, 1, 2).float() * (1.0 / 255.0), dim=-3)
    canvas = separable_blur(pad_edge(l0, pad, pad, pad, pad), radius,
                            cfg.blur_sigma, roll2d)
    want = canvas[..., radius:radius + 24 + 2 * e,
                  radius:radius + 40 + 2 * e]
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the block form (e 0) of the same image, planar
    blk = fe.blur_illumination(x.permute(0, 3, 1, 2).contiguous(), cfg, 0,
                               hwc=False)
    torch.testing.assert_close(blk, got[..., e:e + 24, e:e + 40], rtol=0,
                               atol=0)


# ----------------------------------------------------------------- K3, K4 #

@pytest.mark.parametrize("method,ds,with_gain,kw,f32", [
    ("curve", 2, False, dict(denoise_guide="perchannel"), False),
    ("hybrid", 4, True, dict(guided_radius=4), False),
    ("hybrid", 1, False, dict(guided_radius=4, denoise_guide="perchannel"),
     True),
    ("hybrid", 2, False, dict(blur_radius=9), False),
])
def test_k3_guided_matches_jax_kernel(method, ds, with_gain, kw, f32):
    kw = dict(denoise_taps="guided", **kw)
    xb, maps, halo, rows, m = _curve_block(method, 40, 72, seed=24, ds=ds,
                                           **kw)
    gain = _gain(xb, 25) if with_gain else None
    x = _f32(xb) if f32 else xb
    cfg = dict(method=method, curve_downsample=ds, **kw)
    want = jblocks._fused_curve_tail(
        jnp.asarray(x), jnp.asarray(maps), JConfig(**cfg), halo, rows,
        interpret=True, ds=ds, img_w=72,
        gain=None if gain is None else jnp.asarray(gain))
    got = fe.fused_curve_enhance(
        torch.from_numpy(x), torch.from_numpy(maps), PipelineConfig(**cfg),
        halo, rows, 72, ds=ds,
        gain=None if gain is None else torch.from_numpy(gain))
    assert got.shape == (2, 3, rows, xb.shape[-1]) and got.dtype == (
        torch.float32 if f32 else torch.uint8)
    _cropped(got, want, m, 72)


@pytest.mark.parametrize("kw,f32", [
    (dict(denoise_taps="guided", guided_radius=4,
          denoise_guide="perchannel"), False),
    (dict(), True),
    (dict(blur_radius=16, blur_sigma=5.0), False),
])
def test_k4_forms_match_jax_kernel(kw, f32):
    """K4 guided, on f32 blocks and at a blur past the tile, carries half
    set: the output on the consumed columns, the new carry within 1e-6."""
    xb, _, halo, rows, m = _curve_block("retinex", 33, 47, seed=26,
                                        halo_fn=jblocks.learned_halo, **kw)
    rng = np.random.default_rng(27)
    carry = rng.uniform(0.05, 0.55, (2,) + xb.shape[-2:]).astype(np.float32)
    carry[0][rng.random(carry[0].shape) < 0.5] = -1.0
    x = _f32(xb) if f32 else xb
    want, want_carry = jvideo._fused_ema_tail(
        jnp.asarray(x), jnp.asarray(carry), JConfig(**kw), halo, rows, 47,
        0.3, interpret=True)
    got, got_carry = fe.fused_retinex_ema(
        torch.from_numpy(x), torch.from_numpy(carry), PipelineConfig(**kw),
        halo, rows, 47, 0.3)
    _cropped(got, want, m, 47)
    np.testing.assert_allclose(
        got_carry.numpy()[:, halo:halo + rows, m:m + 47],
        np.asarray(want_carry)[:, halo:halo + rows, m:m + 47], atol=1e-6,
        rtol=0)


@pytest.mark.parametrize("kw,f32", [(dict(denoise_taps="guided"), False),
                                    (dict(), True)])
def test_k1_gain_form_matches_jax_kernel(kw, f32):
    xb, _, halo, rows, m = _curve_block("retinex", 40, 72, seed=28,
                                        halo_fn=jblocks.learned_halo, **kw)
    gain = _gain(xb, 29)
    x = _f32(xb) if f32 else xb
    want = jvideo._fused_gain_tail(jnp.asarray(x), jnp.asarray(gain),
                                   JConfig(**kw), halo, rows, interpret=True)
    got = fe.fused_retinex_gain(torch.from_numpy(x), torch.from_numpy(gain),
                                PipelineConfig(**kw), halo, rows)
    _cropped(got, want, m, 72)


# ------------------------------------------------- f32 learned blocks #

@pytest.mark.parametrize("kw", [
    dict(method="hybrid", curve_features=8),
    dict(method="curve", curve_downsample=2, curve_features=8),
    dict(method="fcn"),
])
def test_enhance_learned_block_f32_matches_jax(kw):
    """f32 blocks through the whole block graph (net, K3 or K5) against the
    JAX ``enhance_learned_block`` on the same f32 block and weights: f32
    out, within 1e-5 on the consumed columns (float32 convs)."""
    jcfg = JConfig(compute_dtype="float32", **kw)
    cfg = PipelineConfig(compute_dtype="float32", **kw)
    h, w = 24, 40
    m = canvas_margin(jcfg)
    halo = jblocks.single_block_halo(jcfg)
    h_core, wp = jblocks.block_geometry(jcfg, h, w)
    lows, _ = synth_batch(1, h, w, seed=30)
    xb = _f32(np.pad(lows.transpose(0, 3, 1, 2),
                     ((0, 0), (0, 0), (halo, halo + h_core - h),
                      (m, wp - w - m)), mode="edge"))
    from low_light_image_enhancement_tpu.pipeline import EnhancePipeline

    jparams = EnhancePipeline(jcfg, force_jnp=True).model_params
    want = jblocks.enhance_learned_block(
        jnp.asarray(xb), jcfg, jparams, -halo, h, w, use_pallas=True,
        interpret=True, halo=halo)
    params = params_from_numpy({k: {n: np.asarray(t) for n, t in v.items()}
                                for k, v in jparams.items()})
    got = tblocks.enhance_learned_block(torch.from_numpy(xb), cfg, params,
                                        -halo, h, w, halo=halo)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[..., :h, m:m + w],
                               np.asarray(want)[..., :h, m:m + w],
                               atol=1e-5, rtol=0)
