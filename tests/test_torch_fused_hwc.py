"""K8 (kernels/fused_enhance_hwc.py) against the JAX package's
``enhance_hwc_u8`` in interpret mode: the retinex graph with the
per-channel full-tap bilateral on u8 HWC, bit for bit, and the same
NotImplementedError for the other guides and taps. The canvas form
(``pad_hwc``, ``fused_retinex_hwc``) against the JAX package's, Δ 0: the
padded canvas exactly, the enhanced canvas on the image's region."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.kernels import fused_enhance_hwc as jhwc
from low_light_image_enhancement_tpu.kernels.striping import plan_stripes
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.kernels import fused_enhance as fe
from low_light_image_enhancement_tpu_torch.kernels import (
    fused_enhance_hwc as thwc,
)
from low_light_image_enhancement_tpu_torch.kernels.striping import (
    plan_canvas,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

_PERCHANNEL_FULL = dict(denoise_guide="perchannel", denoise_taps="full")


@pytest.mark.parametrize("size", [(33, 47), (40, 72)])
def test_hwc_plain_matches_jax(size):
    lows, _ = synth_batch(2, *size, seed=5)
    want = np.asarray(jhwc.enhance_hwc_u8(
        jnp.asarray(lows), JConfig(**_PERCHANNEL_FULL), interpret=True))
    got = thwc.enhance_hwc_u8(torch.from_numpy(lows),
                              PipelineConfig(**_PERCHANNEL_FULL))
    assert got.dtype == torch.uint8 and got.shape == lows.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_hwc_without_denoise_takes_any_tail():
    cfg = PipelineConfig(denoise_strength=0.0)
    lows, _ = synth_batch(1, 16, 24, seed=6)
    got = thwc.enhance_hwc_u8(torch.from_numpy(lows), cfg)
    np.testing.assert_array_equal(
        got.numpy(), fe.fused_retinex_plain(torch.from_numpy(lows), cfg))


@pytest.mark.parametrize("kw", [dict(), dict(denoise_taps="full"),
                                dict(denoise_guide="perchannel"),
                                dict(denoise_taps="guided")])
def test_hwc_raises_where_jax_does(kw):
    lows, _ = synth_batch(1, 8, 16)
    with pytest.raises(NotImplementedError):
        jhwc.enhance_hwc_u8(jnp.asarray(lows), JConfig(**kw), interpret=True)
    with pytest.raises(NotImplementedError, match="per-channel full-tap"):
        thwc.enhance_hwc_u8(torch.from_numpy(lows), PipelineConfig(**kw))
    assert thwc.enhance_hwc_u8.launches == 0


def test_hwc_checks_its_input():
    with pytest.raises(ValueError, match="retinex"):
        thwc.enhance_hwc_u8(torch.zeros((1, 8, 8, 3), dtype=torch.uint8),
                            PipelineConfig(method="hybrid",
                                           **_PERCHANNEL_FULL))
    with pytest.raises(ValueError, match=r"\(B,H,W,3\)"):
        thwc.enhance_hwc_u8(torch.zeros((1, 8, 8, 4), dtype=torch.uint8),
                            PipelineConfig(**_PERCHANNEL_FULL))


@pytest.mark.parametrize("size", [(33, 47), (40, 72)])
def test_hwc_canvas_form_matches_jax(size):
    """pad_hwc equal to JAX's, Δ 0; fused_retinex_hwc (its plain version
    here) of JAX's shape, equal to JAX's interpret-mode fused_retinex_hwc
    on rows [0, H) and cols [margin, margin + W), Δu8 0, and to
    enhance_hwc_u8 there."""
    h, w = size
    lows, _ = synth_batch(2, h, w, seed=7)
    jplan = plan_stripes(h, w, 4)
    plan = plan_canvas(h, w, 4)
    assert (plan.padded_h, plan.padded_w) == (jplan.padded_h,
                                              jplan.padded_w)
    jpad = jhwc.pad_hwc(jnp.asarray(lows), jplan, h, w)
    tpad = thwc.pad_hwc(torch.from_numpy(lows), plan, h, w)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    want = np.asarray(jhwc.fused_retinex_hwc(
        jpad, JConfig(**_PERCHANNEL_FULL), jplan, interpret=True))
    cfg = PipelineConfig(**_PERCHANNEL_FULL)
    got = thwc.fused_retinex_hwc(tpad, cfg, plan)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got[:, :h, 4:4 + w].numpy(),
                                  want[:, :h, 4:4 + w])
    np.testing.assert_array_equal(
        got[:, :h, 4:4 + w].numpy(),
        thwc.enhance_hwc_u8(torch.from_numpy(lows), cfg).numpy())
    with pytest.raises(ValueError, match="canvas"):
        thwc.fused_retinex_hwc(tpad[:, 1:], cfg, plan)
    with pytest.raises(NotImplementedError):
        thwc.fused_retinex_hwc(tpad, PipelineConfig(), plan)
