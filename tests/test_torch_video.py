"""The port's video path on the CPU against the JAX package's
VideoEnhancer on the CPU (its jnp path), with the same weights and frames.

Bars: float32 nets, max |du8| <= 1 with a changed share < 1e-3 (the JAX
package's bar between its kernels and its jnp path); bf16, PSNR >= 40 dB.
The carry: the illumination plane of retinex/hybrid within 1e-6 on the
consumed region (the band rows [halo - m, HB - halo + m) by the image's
columns; K4's carry outside the band is the band's edge rows, never read),
found 2.2e-8; the curve maps of curve within 1e-5, the float32 curve CNN's
own bar (tests/test_torch_models.py), found 1.3e-6. Output deltas found at
40x72: 0 for every float32 arm, retinex included (it has no conv).
"""

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import video as jvideo
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu_torch import pipeline as tpipe
from low_light_image_enhancement_tpu_torch import video as tvideo
from low_light_image_enhancement_tpu_torch.blocks import learned_halo
from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)


def _pair(kw, ema_in_kernel=True, alpha=0.3):
    ref = jvideo.VideoEnhancer(JConfig(**kw), alpha=alpha,
                               ema_in_kernel=ema_in_kernel)
    params = None if ref.model_params is None else \
        params_from_numpy(ref.model_params)
    port = tvideo.VideoEnhancer(PipelineConfig(**kw), alpha=alpha,
                                model_params=params, device="cpu",
                                ema_in_kernel=ema_in_kernel)
    return port, ref


def _delta(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return d.max(), (d > 0).mean()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def _run(port, ref, frames):
    """Both enhancers over the frames, with a reset before the third."""
    for i, f in enumerate(frames):
        if i == 2:
            port.reset()
            ref.reset()
        yield i, port.process(f), ref.process(f)


@pytest.mark.parametrize("kw,ema_in_kernel", [
    (dict(), True),
    (dict(), False),
    (dict(method="curve"), True),
    (dict(method="curve", curve_downsample=4), True),
    (dict(method="hybrid", curve_downsample=4), True),
    (dict(denoise_taps="guided"), True),
    (dict(denoise_taps="guided", guided_radius=4,
          denoise_guide="perchannel"), False),
    (dict(method="hybrid", curve_downsample=4, denoise_taps="guided"), True),
])
def test_video_matches_jax(kw, ema_in_kernel):
    kw = dict(kw, compute_dtype="float32")
    frames, _ = synth_batch(3, 40, 72, seed=3)
    port, ref = _pair(kw, ema_in_kernel)
    cfg = PipelineConfig(**kw)
    m, halo = canvas_margin(cfg), learned_halo(cfg)
    for i, got, want in _run(port, ref, frames):
        assert got.shape == frames[i].shape and got.dtype == np.uint8
        dmax, share = _delta(got, want)
        assert dmax <= 1 and share < 1e-3, (i, dmax, share)
        c_port = port._state[1].numpy()
        c_ref = np.asarray(ref._state[1])
        assert c_port.shape == c_ref.shape
        if cfg.method == "curve":
            np.testing.assert_allclose(c_port, c_ref, atol=1e-5, rtol=0)
        else:
            band = slice(halo - m, c_ref.shape[0] - halo + m)
            np.testing.assert_allclose(c_port[band, m:m + 72],
                                       c_ref[band, m:m + 72], atol=1e-6,
                                       rtol=0)


def test_video_hybrid_bf16_psnr_vs_jax():
    """bf16 curve CNN: PSNR >= 40 dB; found 56-57 dB at 40x72 ds 4."""
    frames, _ = synth_batch(3, 40, 72, seed=4)
    port, ref = _pair(dict(method="hybrid", curve_downsample=4))
    for i, got, want in _run(port, ref, frames):
        assert _psnr(got, want) >= 40.0, i


@pytest.mark.parametrize("kw,ema_in_kernel", [
    (dict(), True), (dict(), False),
    (dict(method="curve", curve_downsample=4, compute_dtype="float32"),
     True),
])
def test_multistream_equals_lone_streams_and_resets_one(kw, ema_in_kernel):
    """Stream i of a batched step against a lone VideoEnhancer, and
    reset(1) re-seeds stream 1 alone. retinex: bit for bit. curve: the CPU
    convolution sums a batch of 2 in another order than a batch of 1 (maps
    9.5e-7 apart), so it is held to the u8 bar (found: one value off by 1
    of 8,640 in a frame)."""
    cfg = PipelineConfig(**kw)
    frames, _ = synth_batch(6, 40, 72, seed=5)
    frames = frames.reshape(3, 2, 40, 72, 3)
    make = dict(device="cpu", ema_in_kernel=ema_in_kernel)
    multi = tvideo.MultiStreamVideoEnhancer(2, cfg, **make)
    lone = [tvideo.VideoEnhancer(cfg, model_params=multi.model_params,
                                 **make) for _ in range(2)]
    for t in range(3):
        if t == 2:
            multi.reset(1)
            lone[1].reset()
        outs = multi.process(frames[t])
        for s in range(2):
            want = lone[s].process(frames[t, s])
            if cfg.method == "retinex":
                np.testing.assert_array_equal(outs[s], want)
            else:
                dmax, share = _delta(outs[s], want)
                assert dmax <= 1 and share < 1e-3, (t, s, dmax, share)
    # stream 0 kept its carry through the reset: it is not a fresh stream
    fresh = tvideo.VideoEnhancer(cfg, model_params=multi.model_params,
                                 **make)
    assert _delta(outs[0], fresh.process(frames[2, 0]))[0] > 1


@pytest.mark.parametrize("kw", [dict(), dict(method="curve"),
                                dict(method="curve", curve_downsample=4)])
def test_carry_bytes_match_jax(kw):
    frame = synth_batch(1, 40, 72, seed=6)[0][0]
    port, ref = _pair(dict(kw, compute_dtype="float32"))
    with pytest.raises(RuntimeError):
        port.carry_bytes
    port.process(frame)
    ref.process(frame)
    assert port.carry_bytes == ref.carry_bytes
    multi = tvideo.MultiStreamVideoEnhancer(3, PipelineConfig(**kw),
                                            model_params=port.model_params,
                                            device="cpu")
    multi.process(np.stack([frame] * 3))
    assert multi.carry_bytes == 3 * ref.carry_bytes


def test_alpha_one_matches_stateless_pipeline():
    """At alpha 1 the retinex step is the stateless graph, with the gain
    written exp(gamma log L - log L) instead of exp((gamma-1) log L). The
    two round apart and tip u8 rounding ties: found max |du8| 1 on 0.5-0.6%
    of the values, the same values as the JAX package's alpha-1 video
    against its own pipeline. Bar: the JAX package's, max |du8| <= 1
    (tests/integration/test_video.py), and a changed share under 1%."""
    frames, _ = synth_batch(3, 40, 72, seed=7)
    pipe = tpipe.EnhancePipeline(PipelineConfig(), device="cpu")
    for ema_in_kernel in (True, False):
        ve = tvideo.VideoEnhancer(PipelineConfig(), alpha=1.0, device="cpu",
                                  ema_in_kernel=ema_in_kernel)
        for f in frames:
            dmax, share = _delta(ve.process(f), pipe.enhance(f))
            assert dmax <= 1 and share < 1e-2, (dmax, share)


def test_video_options_and_inputs_are_checked():
    for method in ("fcn", "decom"):
        with pytest.raises(ValueError, match="no temporal carry"):
            tvideo.VideoEnhancer(PipelineConfig(method=method), device="cpu")
    # the guided tail, refused before K4's was ported, runs
    guided = tvideo.VideoEnhancer(PipelineConfig(denoise_taps="guided"),
                                  device="cpu")
    assert guided.process(np.zeros((16, 24, 3), np.uint8)).shape == (16, 24,
                                                                     3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tvideo.VideoEnhancer(device="cuda")
    with pytest.raises(ValueError):
        tvideo.MultiStreamVideoEnhancer(0, device="cpu")
    ve = tvideo.VideoEnhancer(device="cpu")
    ve.process(np.zeros((16, 24, 3), np.uint8))
    with pytest.raises(ValueError, match="frame size changed"):
        ve.process(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(TypeError):
        ve.process(np.zeros((16, 24, 3), np.float32))
    multi = tvideo.MultiStreamVideoEnhancer(2, device="cpu")
    with pytest.raises(ValueError):
        multi.process(np.zeros((3, 16, 24, 3), np.uint8))
    with pytest.raises(ValueError):
        multi.reset(2)


@pytest.mark.parametrize("kw,ema_in_kernel", [
    (dict(), True), (dict(denoise_taps="guided"), False),
    (dict(method="hybrid", curve_downsample=4), True),
])
def test_video_step_takes_f32_blocks(kw, ema_in_kernel):
    """video_step on an f32 block (refused before f32 I/O was ported)
    against the JAX video_step on the same block: two chained frames, f32
    out within 1e-5 on the consumed columns, the carries within 1e-6."""
    kw = dict(kw, compute_dtype="float32")
    cfg, jcfg = PipelineConfig(**kw), JConfig(**kw)
    frames, _ = synth_batch(2, 33, 47, seed=9)
    params = None
    if cfg.method != "retinex":
        jparams = jvideo.VideoEnhancer(jcfg).model_params
        params = params_from_numpy(jparams)
    m = canvas_margin(cfg)
    tstate, jstate = (torch.zeros((1,), dtype=torch.bool), None), None
    for f in frames:
        xb = tvideo.pad_video_block(torch.from_numpy(f[None]), cfg)
        xf = xb.float() * (1.0 / 255.0)
        if tstate[1] is None:
            tstate = (tstate[0], torch.zeros((1,) + xb.shape[-2:]))
            jstate = (np.zeros((1,), bool), np.zeros((1,) + xb.shape[-2:],
                                                     np.float32))
        tstate, got = tvideo.video_step(tstate, xf, cfg, 0.3, params, 33,
                                        47, ema_in_kernel=ema_in_kernel)
        jstate, want = jvideo.video_step(
            jstate, xf.numpy(), jcfg, 0.3,
            None if params is None else jparams, 33, 47,
            ema_in_kernel=ema_in_kernel)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy()[..., :33, m:m + 47],
                                   np.asarray(want)[..., :33, m:m + 47],
                                   atol=1e-5, rtol=0)
        halo = learned_halo(cfg)
        np.testing.assert_allclose(
            tstate[1].numpy()[:, halo:-halo, m:m + 47],
            np.asarray(jstate[1])[:, halo:-halo, m:m + 47], atol=1e-6,
            rtol=0)
