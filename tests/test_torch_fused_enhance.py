"""K1 and K3's plain versions against the JAX package's Pallas kernels in
interpret mode, on the same inputs; and the wrappers' contracts.

Bar: max |du8| <= 1 with a changed share < 1e-3, the JAX package's own bar
between its kernels and its jnp path (tests/kernels/test_fused_curve.py):
the exp/log of the two frameworks differ in the last ulp, which can flip an
isolated u8 rounding tie. The CUDA kernels themselves are held to these
plain versions on the card by chip_smoke.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import blocks as jblocks
from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.config import canvas_margin
from low_light_image_enhancement_tpu.kernels.fused_enhance import (
    retinex_plan_bytes_per_px,
)
from low_light_image_enhancement_tpu.kernels.striping import plan_stripes
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.kernels import fused_enhance as fe


def _assert_u8_close(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())


def _jax_retinex(lows, kw):
    cfg = JConfig(**kw)
    _, h, w, _ = lows.shape
    plan = plan_stripes(h, w, canvas_margin(cfg), cfg.stripe_rows,
                        bytes_per_px=retinex_plan_bytes_per_px(cfg))
    fn = jax.jit(functools.partial(
        jpipe._enhance_u8_batch, cfg=cfg, plan=plan, use_pallas=True,
        pallas_interpret=True))
    return np.asarray(fn(jnp.asarray(lows), None))


@pytest.mark.parametrize("size", [(40, 72), (33, 47)])
@pytest.mark.parametrize("kw", [
    dict(), dict(denoise_guide="perchannel", denoise_taps="full"),
])
def test_k1_plain_matches_jax_kernel(kw, size):
    lows, _ = synth_batch(2, *size)
    got = fe.fused_retinex(torch.from_numpy(lows), PipelineConfig(**kw))
    assert got.shape == lows.shape and got.dtype == torch.uint8
    _assert_u8_close(got.numpy(), _jax_retinex(lows, kw))


@pytest.mark.parametrize("kw", [
    dict(denoise_guide="perchannel"),
    dict(denoise_taps="full", denoise_kernel="epan"),
    dict(denoise_strength=0.5, gamma=0.6),
    dict(denoise_strength=0.0),
])
def test_k1_plain_variants_match_jax_kernel(kw):
    lows, _ = synth_batch(1, 40, 72, seed=1)
    got = fe.fused_retinex(torch.from_numpy(lows), PipelineConfig(**kw))
    _assert_u8_close(got.numpy(), _jax_retinex(lows, kw))


def _curve_block(method, h, w, seed):
    """A u8 block as the pipeline pads it, and random maps on it."""
    cfg = JConfig(method=method)
    m = canvas_margin(cfg)
    halo = jblocks.single_block_halo(cfg)
    h_core, wp = jblocks.block_geometry(cfg, h, w)
    lows, _ = synth_batch(2, h, w, seed=seed)
    xb = np.pad(lows.transpose(0, 3, 1, 2),
                ((0, 0), (0, 0), (halo, halo + h_core - h), (m, wp - w - m)),
                mode="edge")
    maps = np.random.default_rng(seed).uniform(
        -1.0, 1.0, (2, 8, 3) + xb.shape[-2:]).astype(np.float32)
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


def test_cpu_calls_launch_nothing():
    before = (fe.fused_retinex.launches, fe.fused_curve_enhance.launches)
    lows, _ = synth_batch(1, 16, 24)
    fe.fused_retinex(torch.from_numpy(lows), PipelineConfig())
    xb, maps, halo, rows, _ = _curve_block("curve", 16, 24, seed=4)
    fe.fused_curve_enhance(torch.from_numpy(xb), torch.from_numpy(maps),
                           PipelineConfig(method="curve"), halo, rows, 24)
    assert (fe.fused_retinex.launches,
            fe.fused_curve_enhance.launches) == before


@pytest.mark.parametrize("call", [
    lambda x: fe.fused_retinex(x, PipelineConfig(denoise_taps="guided")),
    lambda x: fe.fused_retinex(x, PipelineConfig(), gain=x),
    lambda x: fe.fused_retinex(x, PipelineConfig(), stages=("blur",)),
    lambda x: fe.fused_retinex(x.float() / 255, PipelineConfig()),
])
def test_unported_k1_options_raise(call):
    x = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call(x)


def test_unported_k3_options_and_bad_inputs_raise():
    xb, maps, halo, rows, _ = _curve_block("hybrid", 16, 24, seed=5)
    xb, maps = torch.from_numpy(xb), torch.from_numpy(maps)
    cfg = PipelineConfig(method="hybrid")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fe.fused_curve_enhance(xb, maps, cfg.replace(curve_downsample=2),
                               halo, rows, 24)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fe.fused_curve_enhance(xb, maps, cfg, halo, rows, 24, gain=maps)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fe.fused_curve_enhance(xb.float(), maps, cfg, halo, rows, 24)
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps[:, :, :, 1:], cfg, halo, rows, 24)
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps, cfg, 2, rows, 24)
    with pytest.raises(ValueError):
        fe.fused_curve_enhance(xb, maps, PipelineConfig(), halo, rows, 24)
    with pytest.raises(ValueError):
        fe.fused_retinex(torch.zeros((8, 8, 3), dtype=torch.uint8),
                         PipelineConfig())

