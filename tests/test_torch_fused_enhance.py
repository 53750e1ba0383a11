"""K1's, K3's and K4's plain versions against the JAX package's Pallas
kernels in interpret mode, on the same inputs; and the wrappers' contracts.

Bar: max |du8| <= 1 with a changed share < 1e-3, the JAX package's own bar
between its kernels and its jnp path (tests/kernels/test_fused_curve.py):
the exp/log of the two frameworks differ in the last ulp, which can flip an
isolated u8 rounding tie. The CUDA kernels themselves are held to these
plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import blocks as jblocks
from low_light_image_enhancement_tpu import video as jvideo
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.config import canvas_margin
from low_light_image_enhancement_tpu.kernels import fused_enhance as jfe
from low_light_image_enhancement_tpu.kernels.fused_enhance import (
    retinex_plan_bytes_per_px,
)
from low_light_image_enhancement_tpu.kernels.striping import plan_stripes
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.kernels import fused_enhance as fe

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)


def _assert_u8_close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _jax_k1(imgs, kw, stages=("blur", "boost", "denoise")):
    """The JAX kernel in interpret mode on the replicate-padded planar
    canvas of (B, H, W, 3) u8 or f32 images, cropped back to HWC."""
    cfg = JConfig(**kw)
    _, h, w, _ = imgs.shape
    m = canvas_margin(cfg)
    plan = plan_stripes(h, w, m, cfg.stripe_rows,
                        bytes_per_px=retinex_plan_bytes_per_px(cfg))
    xp = np.pad(imgs.transpose(0, 3, 1, 2),
                ((0, 0), (0, 0), (m, plan.padded_h - h - m),
                 (m, plan.padded_w - w - m)), mode="edge")
    out = jfe.fused_retinex(jnp.asarray(xp), cfg, plan, interpret=True,
                            stages=stages)
    return np.asarray(out)[..., :h, m:m + w].transpose(0, 2, 3, 1)


def _assert_io_close(got, want):
    """u8: the bar above; f32: within 1e-5."""
    got = np.asarray(got)
    if got.dtype == np.uint8:
        _assert_u8_close(got, want)
    else:
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("size", [(40, 72), (33, 47)])
@pytest.mark.parametrize("kw", [
    dict(), dict(denoise_guide="perchannel", denoise_taps="full"),
])
def test_k1_plain_matches_jax_kernel(kw, size):
    lows, _ = synth_batch(2, *size)
    got = fe.fused_retinex(torch.from_numpy(lows), PipelineConfig(**kw))
    assert got.shape == lows.shape and got.dtype == torch.uint8
    _assert_u8_close(got.numpy(), _jax_k1(lows, kw))


@pytest.mark.parametrize("kw", [
    dict(denoise_guide="perchannel"),
    dict(denoise_taps="full", denoise_kernel="epan"),
    dict(denoise_strength=0.5, gamma=0.6),
    dict(denoise_strength=0.0),
])
def test_k1_plain_variants_match_jax_kernel(kw):
    lows, _ = synth_batch(1, 40, 72, seed=1)
    got = fe.fused_retinex(torch.from_numpy(lows), PipelineConfig(**kw))
    _assert_u8_close(got.numpy(), _jax_k1(lows, kw))


def _curve_block(method, h, w, seed, ds=1, halo_fn=jblocks.single_block_halo,
                 **kw):
    """A u8 block as the pipeline (or, with ``learned_halo``, the video
    step) pads it for ``JConfig(method, curve_downsample=ds, **kw)``, and
    random maps on it at 1/ds."""
    cfg = JConfig(method=method, curve_downsample=ds, **kw)
    m = canvas_margin(cfg)
    halo = halo_fn(cfg)
    h_core, wp = jblocks.block_geometry(cfg, h, w)
    lows, _ = synth_batch(2, h, w, seed=seed)
    xb = np.pad(lows.transpose(0, 3, 1, 2),
                ((0, 0), (0, 0), (halo, halo + h_core - h), (m, wp - w - m)),
                mode="edge")
    hb, wb = xb.shape[-2:]
    maps = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (2, 8, 3, hb // ds, wb // ds)).astype(np.float32)
    return xb, maps, halo, h_core, m


@pytest.mark.parametrize("method", ["curve", "hybrid"])
@pytest.mark.parametrize("size", [(40, 72), (33, 47)])
def test_k3_plain_matches_jax_kernel(method, size):
    h, w = size
    xb, maps, halo, rows, m = _curve_block(method, h, w, seed=2)
    want = np.asarray(jblocks._fused_curve_tail(
        jnp.asarray(xb), jnp.asarray(maps), JConfig(method=method), halo,
        rows, interpret=True, img_w=w))
    got = fe.fused_curve_enhance(torch.from_numpy(xb), torch.from_numpy(maps),
                                 PipelineConfig(method=method), halo, rows, w)
    assert got.shape == (2, 3, rows, xb.shape[-1])
    # the consumed columns; the others are cropped by every caller
    _assert_u8_close(got.numpy()[..., m:m + w], want[..., m:m + w])


def test_k3_plain_perchannel_full_matches_jax_kernel():
    xb, maps, halo, rows, m = _curve_block("hybrid", 40, 72, seed=3)
    kw = dict(method="hybrid", denoise_guide="perchannel",
              denoise_taps="full")
    want = np.asarray(jblocks._fused_curve_tail(
        jnp.asarray(xb), jnp.asarray(maps), JConfig(**kw), halo, rows,
        interpret=True, img_w=72))
    got = fe.fused_curve_enhance(torch.from_numpy(xb), torch.from_numpy(maps),
                                 PipelineConfig(**kw), halo, rows, 72)
    _assert_u8_close(got.numpy()[..., m:m + 72], want[..., m:m + 72])


def _gain(xb, seed):
    """A positive f32 gain plane (B, HB, WB) for a block."""
    b, _, hb, wb = xb.shape
    return np.random.default_rng(seed).uniform(
        0.5, 3.0, (b, hb, wb)).astype(np.float32)


@pytest.mark.parametrize("method,ds,with_gain", [
    ("curve", 2, False), ("hybrid", 4, True), ("hybrid", 1, True),
])
def test_k3_lowres_maps_and_gain_match_jax_kernel(method, ds, with_gain):
    """Maps at 1/ds, upsampled in the kernel (the plain version upsamples
    them first), and the external gain plane of the hybrid video step."""
    xb, maps, halo, rows, m = _curve_block(method, 40, 72, seed=6, ds=ds)
    gain = _gain(xb, 7) if with_gain else None
    cfg = dict(method=method, curve_downsample=ds)
    want = np.asarray(jblocks._fused_curve_tail(
        jnp.asarray(xb), jnp.asarray(maps), JConfig(**cfg), halo, rows,
        interpret=True, ds=ds, img_w=72,
        gain=None if gain is None else jnp.asarray(gain)))
    got = fe.fused_curve_enhance(
        torch.from_numpy(xb), torch.from_numpy(maps), PipelineConfig(**cfg),
        halo, rows, 72, ds=ds,
        gain=None if gain is None else torch.from_numpy(gain))
    assert got.shape == (2, 3, rows, xb.shape[-1])
    _assert_u8_close(got.numpy()[..., m:m + 72], want[..., m:m + 72])


def test_k1_gain_form_plain_matches_jax_kernel():
    xb, _, halo, rows, m = _curve_block("curve", 40, 72, seed=8,
                                        halo_fn=jblocks.learned_halo)
    gain = _gain(xb, 9)
    want = np.asarray(jvideo._fused_gain_tail(
        jnp.asarray(xb), jnp.asarray(gain), JConfig(), halo, rows,
        interpret=True))
    got = fe.fused_retinex_gain(torch.from_numpy(xb), torch.from_numpy(gain),
                                PipelineConfig(), halo, rows)
    assert got.shape == (2, 3, rows, xb.shape[-1])
    _assert_u8_close(got.numpy()[..., m:m + 72], want[..., m:m + 72])


@pytest.mark.parametrize("carry_mode", ["init", "sentinel", "half"])
def test_k4_plain_matches_jax_kernel(carry_mode):
    """K4 against the JAX video step's fused tail (the kernel in interpret
    mode, then the band's edge rows): outputs on the consumed columns, the
    new carry on the image's columns within 1e-6 (found: equal)."""
    cfg = JConfig()
    xb, _, halo, rows, m = _curve_block("curve", 40, 72, seed=10,
                                        halo_fn=jblocks.learned_halo)
    rng = np.random.default_rng(11)
    carry = rng.uniform(0.05, 0.55, (2,) + xb.shape[-2:]).astype(np.float32)
    if carry_mode == "sentinel":
        carry[:] = -1.0
    elif carry_mode == "half":
        carry[0][rng.random(carry[0].shape) < 0.5] = -1.0
    want, want_carry = jvideo._fused_ema_tail(
        jnp.asarray(xb), jnp.asarray(carry), cfg, halo, rows, 72, 0.3,
        interpret=True)
    got, got_carry = fe.fused_retinex_ema(
        torch.from_numpy(xb), torch.from_numpy(carry), PipelineConfig(),
        halo, rows, 72, 0.3)
    assert got.shape == (2, 3, rows, xb.shape[-1])
    assert got_carry.shape == carry.shape
    _assert_u8_close(got.numpy()[..., m:m + 72],
                     np.asarray(want)[..., m:m + 72])
    np.testing.assert_allclose(got_carry.numpy()[..., m:m + 72],
                               np.asarray(want_carry)[..., m:m + 72],
                               atol=1e-6, rtol=0)


def test_cpu_calls_launch_nothing():
    wrappers = (fe.fused_retinex, fe.fused_curve_enhance,
                fe.fused_retinex_ema)
    before = [wr.launches for wr in wrappers]
    lows, _ = synth_batch(1, 16, 24)
    fe.fused_retinex(torch.from_numpy(lows), PipelineConfig())
    xb, maps, halo, rows, _ = _curve_block("curve", 16, 24, seed=4)
    xb, maps = torch.from_numpy(xb), torch.from_numpy(maps)
    fe.fused_curve_enhance(xb, maps, PipelineConfig(method="curve"), halo,
                           rows, 24)
    plane = torch.ones_like(maps[:, 0, 0])
    fe.fused_retinex_gain(xb, plane, PipelineConfig(), halo, rows)
    fe.fused_retinex_ema(xb, -plane, PipelineConfig(), halo, rows, 24, 0.3)
    assert [wr.launches for wr in wrappers] == before


@pytest.mark.parametrize("kw,stages,f32", [
    (dict(denoise_taps="guided"), None, False),
    (dict(denoise_taps="guided", denoise_guide="perchannel"), None, False),
    (dict(), ("blur",), False),
    (dict(), None, True),
])
def test_unported_k1_options_raise(kw, stages, f32):
    """The K1 forms that raised before they were ported (the guided tail in
    both guides, stage truncation, f32 I/O) now run: each plain version
    against the JAX kernel in interpret mode on the same input."""
    lows, _ = synth_batch(1, 33, 47, seed=12)
    x = lows.astype(np.float32) / 255.0 if f32 else lows
    got = fe.fused_retinex(torch.from_numpy(x), PipelineConfig(**kw),
                           stages=stages)
    assert got.dtype == (torch.float32 if f32 else torch.uint8)
    _assert_io_close(got.numpy(),
                     _jax_k1(x, kw, stages or ("blur", "boost", "denoise")))


def test_unported_k3_options_and_bad_inputs_raise():
    """K3's and K4's forms that raised before they were ported (the guided
    tail, f32 blocks) against the JAX kernels in interpret mode; then the
    inputs every form still refuses."""
    gkw = dict(denoise_taps="guided")
    xg, mg, hg, rg, mm = _curve_block("hybrid", 16, 24, seed=5, **gkw)
    want = jblocks._fused_curve_tail(
        jnp.asarray(xg), jnp.asarray(mg), JConfig(method="hybrid", **gkw),
        hg, rg, interpret=True, img_w=24)
    got = fe.fused_curve_enhance(
        torch.from_numpy(xg), torch.from_numpy(mg),
        PipelineConfig(method="hybrid", **gkw), hg, rg, 24)
    _assert_u8_close(got.numpy()[..., mm:mm + 24],
                     np.asarray(want)[..., mm:mm + 24])
    xg, _, hg, rg, mm = _curve_block("retinex", 16, 24, seed=5,
                                     halo_fn=jblocks.learned_halo, **gkw)
    carry = np.full((2,) + xg.shape[-2:], -1.0, np.float32)
    want, _ = jvideo._fused_ema_tail(jnp.asarray(xg), jnp.asarray(carry),
                                     JConfig(**gkw), hg, rg, 24, 0.3,
                                     interpret=True)
    got, _ = fe.fused_retinex_ema(torch.from_numpy(xg),
                                  torch.from_numpy(carry),
                                  PipelineConfig(**gkw), hg, rg, 24, 0.3)
    _assert_u8_close(got.numpy()[..., mm:mm + 24],
                     np.asarray(want)[..., mm:mm + 24])
    xb, maps, halo, rows, m = _curve_block("hybrid", 16, 24, seed=5)
    xf = xb.astype(np.float32) / 255.0
    want = jblocks._fused_curve_tail(
        jnp.asarray(xf), jnp.asarray(maps), JConfig(method="hybrid"), halo,
        rows, interpret=True, img_w=24)
    got = fe.fused_curve_enhance(torch.from_numpy(xf), torch.from_numpy(maps),
                                 PipelineConfig(method="hybrid"), halo, rows,
                                 24)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy()[..., m:m + 24],
                               np.asarray(want)[..., m:m + 24], atol=1e-5,
                               rtol=0)
    xb, maps = torch.from_numpy(xb), torch.from_numpy(maps)
    cfg = PipelineConfig(method="hybrid")
    plane = torch.ones_like(maps[:, 0, 0])
    # an I/O type the kernels do not take
    with pytest.raises(TypeError):
        fe.fused_curve_enhance(xb.double(), maps, cfg, halo, rows, 24)
    # maps at a resolution the ds does not name, ds 8, a gain of the wrong
    # shape, a traced (tensor) alpha
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps, cfg, halo, rows, 24, ds=2)
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps[..., ::8, ::8], cfg, halo, rows, 24,
                               ds=8)
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps, cfg, halo, rows, 24, gain=maps)
    with pytest.raises(ValueError):
        fe.fused_retinex_gain(xb, plane[:, 1:], PipelineConfig(), halo, rows)
    with pytest.raises(TypeError):
        fe.fused_retinex_ema(xb, plane, PipelineConfig(), halo, rows, 24,
                             torch.tensor(0.3))
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps[:, :, :, 1:], cfg, halo, rows, 24)
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps, cfg, 2, rows, 24)
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps, PipelineConfig(), halo, rows, 24)
    with pytest.raises(ValueError):
        fe.fused_retinex(torch.zeros((8, 8, 3), dtype=torch.uint8),
                         PipelineConfig())

