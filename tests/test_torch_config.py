"""The port's PipelineConfig, presets and block geometry equal the JAX
package's."""

import dataclasses

import pytest

from low_light_image_enhancement_tpu import blocks as jblocks
from low_light_image_enhancement_tpu import config as jc
from low_light_image_enhancement_tpu.kernels.striping import plan_stripes
from low_light_image_enhancement_tpu_torch import blocks as tblocks
from low_light_image_enhancement_tpu_torch import config as tc
from low_light_image_enhancement_tpu_torch.kernels.striping import plan_canvas


def test_fields_and_defaults_equal():
    def fields(cls):
        return [(f.name, f.type, f.default) for f in dataclasses.fields(cls)]

    assert fields(tc.PipelineConfig) == fields(jc.PipelineConfig)
    assert tc.MARGIN == jc.MARGIN


def test_presets_equal():
    assert list(tc.PRESETS) == list(jc.PRESETS)
    for name, cfg in jc.PRESETS.items():
        assert dataclasses.asdict(tc.PRESETS[name]) == dataclasses.asdict(cfg)


@pytest.mark.parametrize("kw", [
    dict(method="unet"), dict(blur_radius=0), dict(blur_sigma=0.0),
    dict(denoise_strength=1.5), dict(denoise_sigma=0.0),
    dict(denoise_kernel="box"), dict(denoise_guide="rgb"),
    dict(denoise_taps="box"), dict(denoise_taps="guided", guided_radius=9),
    dict(denoise_taps="guided", guided_eps=0.0), dict(conv_impl="cudnn"),
    dict(curve_downsample=3), dict(spatial_shards=0),
    dict(spatial_shards=2, data_shards=2),
])
def test_validation_errors_match(kw):
    with pytest.raises(ValueError) as want:
        jc.PipelineConfig(**kw)
    with pytest.raises(ValueError) as got:
        tc.PipelineConfig(**kw)
    assert str(got.value) == str(want.value)


_GEOMETRY_CASES = [
    dict(), dict(method="hybrid"), dict(method="curve"),
    dict(method="curve", curve_downsample=4), dict(method="fcn"),
    dict(method="decom", denoise_taps="guided", guided_radius=4),
    dict(method="hybrid", denoise_strength=0.0),
    dict(method="fcn", denoise_taps="guided", guided_radius=2),
    dict(method="fcn", denoise_taps="guided", guided_radius=4),
    dict(method="decom"),
    dict(method="decom", denoise_taps="guided", guided_radius=2),
]


@pytest.mark.parametrize("kw", _GEOMETRY_CASES)
def test_margins_and_block_geometry_match(kw):
    t, j = tc.PipelineConfig(**kw), jc.PipelineConfig(**kw)
    assert tc.canvas_margin(t) == jc.canvas_margin(j)
    assert tc.denoise_radius(t) == jc.denoise_radius(j)
    assert tblocks.cnn_radius(t) == jblocks.cnn_radius(j)
    assert tblocks.learned_halo(t) == jblocks.learned_halo(j)
    assert tblocks.single_block_halo(t) == jblocks.single_block_halo(j)
    for h, w in ((400, 600), (33, 47), (1080, 1920)):
        assert tblocks.block_geometry(t, h, w) == \
            jblocks.block_geometry(j, h, w)


@pytest.mark.parametrize("h,w", [(400, 600), (33, 47), (64, 64)])
def test_canvas_matches_one_stripe_plan(h, w):
    j = plan_stripes(h, w, jc.MARGIN)
    assert j.n_stripes == 1
    assert plan_canvas(h, w, jc.MARGIN) == (j.padded_h, j.padded_w, j.margin)


def test_conv_impl_resolution():
    assert tblocks.resolve_conv_impl(tc.PipelineConfig()).conv_impl == "xla"
    # ported: ops/patch_conv.py's arms resolve to themselves
    assert tblocks.resolve_conv_impl(
        tc.PipelineConfig(conv_impl="packed")).conv_impl == "packed"
