"""The layout-persistent entry points of the port's EnhancePipeline.

K1's canvas form (plain version, on the CPU) against the JAX package's
canvas path (EnhancePipeline(pallas_interpret=True): the Pallas K1 in
interpret mode on its own staged canvas), each cropped by its own
crop_canvas: max |du8| <= 1 with a changed share < 1e-3, the main path's
bar (f32 I/O quantized on both sides). Then the port against itself:
planar, canvas and the three enhance_stream stagings equal enhance_batch
exactly, and the canvas path's refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.kernels.fused_enhance import (
    fused_retinex as jax_k1,
)
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.io.prefetch import (
    from_planar,
    to_planar,
)
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    fused_retinex_canvas,
    fused_retinex_canvas_plain,
)
from low_light_image_enhancement_tpu_torch.ops.colorspace import quantize_u8
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

CANVAS_CASES = {
    "default": (dict(), False),
    "guided r2": (dict(denoise_taps="guided", guided_radius=2), False),
    "f32": (dict(), True),
    "blur r16": (dict(blur_radius=16, blur_sigma=5.0), False),
}


def _delta(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return int(d.max()), float((d > 0).mean())


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 33, 47)])
@pytest.mark.parametrize("case", sorted(CANVAS_CASES))
def test_canvas_form_matches_jax_canvas_path(case, shape):
    kw, f32 = CANVAS_CASES[case]
    b, h, w = shape
    lows = synth_batch(b, h, w, seed=1)[0]
    ref = jpipe.EnhancePipeline(JConfig(**kw), pallas_interpret=True)
    port = EnhancePipeline(PipelineConfig(**kw), device="cpu")
    jc, pc = ref.stage_canvas(lows), port.stage_canvas(lows)
    plan = port.canvas_plan(h, w)
    m = plan.margin
    if f32:
        jout = jax_k1(jnp.asarray(jc, jnp.float32) / 255.0, ref.config,
                      ref.canvas_plan(h, w), interpret=True)
        want = quantize_u8(torch.from_numpy(np.array(
            jout[..., :h, m:m + w])))
        got = fused_retinex_canvas_plain(
            torch.from_numpy(pc).float() / 255.0, port.config, m,
            plan.padded_h - 2 * m)
        got = quantize_u8(got[..., :h, m:m + w])
        want, got = want.numpy(), got.numpy()
    else:
        want = ref.crop_canvas(ref.enhance_batch_device_canvas(
            jnp.asarray(jc), h, w), h, w)
        got = port.crop_canvas(fused_retinex_canvas(
            torch.from_numpy(pc), port.config, m, plan.padded_h - 2 * m),
            h, w)
    assert got.shape == want.shape
    dmax, share = _delta(got, want)
    print(f"{case} {shape}: max|du8|={dmax} changed={share:.2e}")
    assert dmax <= 1 and share < 1e-3, (case, shape, dmax, share)


@pytest.mark.parametrize("size", [(48, 64), (33, 47)])
@pytest.mark.parametrize("kw", [
    dict(), dict(denoise_taps="guided", guided_radius=4),
    dict(method="hybrid"), dict(method="curve", curve_downsample=2)])
def test_planar_and_canvas_equal_enhance_batch(kw, size):
    pipe = EnhancePipeline(PipelineConfig(**kw), device="cpu")
    lows = synth_batch(2, *size, seed=2)[0]
    ref = pipe.enhance_batch(lows)
    got = pipe.enhance_batch_device_planar(torch.from_numpy(to_planar(lows)))
    np.testing.assert_array_equal(from_planar(got.numpy()), ref)
    if pipe.config.method == "retinex":
        canvas = pipe.stage_canvas(lows)
        out = pipe.enhance_batch_device_canvas(torch.from_numpy(canvas),
                                               *size)
        assert out.shape[-2:] == (canvas.shape[-2] - 2 * pipe.canvas_plan(
            *size).margin, canvas.shape[-1])
        np.testing.assert_array_equal(pipe.crop_canvas(out, *size), ref)


@pytest.mark.parametrize("staging", ["hwc", "planar", "canvas"])
def test_enhance_stream_stagings_equal_enhance_batch(staging):
    pipe = EnhancePipeline(PipelineConfig(), device="cpu")
    lows = synth_batch(4, 40, 56, seed=3)[0]
    ref = pipe.enhance_batch(lows)
    frames = list(pipe.enhance_stream(iter(lows), staging=staging,
                                      workers=2))
    assert len(frames) == 4
    for got, want in zip(frames, ref):
        np.testing.assert_array_equal(got, want)
    batches = list(pipe.enhance_stream(iter([lows[:2], lows[2:]]),
                                       staging=staging, depth=1, workers=2))
    np.testing.assert_array_equal(np.concatenate(batches), ref)


def test_canvas_plan_geometry():
    pipe = EnhancePipeline(PipelineConfig(), device="cpu")
    assert pipe.canvas_plan(400, 600) == (408, 640, 4)
    assert pipe.canvas_plan(1080, 1920) == (1088, 2048, 4)
    guided = EnhancePipeline(PipelineConfig(denoise_taps="guided",
                                            guided_radius=4), device="cpu")
    assert guided.canvas_plan(400, 600) == (432, 640, 16)
    assert pipe.stage_canvas(np.zeros((400, 600, 3), np.uint8)).shape == \
        (1, 3, 408, 640)


def test_canvas_path_rejects_wrong_geometry_and_methods():
    pipe = EnhancePipeline(PipelineConfig(), device="cpu")
    with pytest.raises(ValueError, match="plan"):
        pipe.enhance_batch_device_canvas(
            torch.zeros((1, 3, 50, 128), dtype=torch.uint8), 48, 64)
    with pytest.raises(ValueError, match="canvas"):
        pipe.enhance_batch_device_canvas(
            torch.zeros((1, 3, 56, 128), dtype=torch.float32), 48, 64)
    with pytest.raises(ValueError, match="staging"):
        next(pipe.enhance_stream(iter([]), staging="nhwc"))
    hybrid = EnhancePipeline(PipelineConfig(method="hybrid"), device="cpu")
    with pytest.raises(NotImplementedError, match="canvas"):
        hybrid.enhance_batch_device_canvas(
            torch.zeros((1, 3, 56, 128), dtype=torch.uint8), 48, 64)
    with pytest.raises(NotImplementedError, match="canvas"):
        list(hybrid.enhance_stream(iter([np.zeros((48, 64, 3), np.uint8)]),
                                   staging="canvas"))
    with pytest.raises(ValueError, match="retinex"):
        fused_retinex_canvas(torch.zeros((1, 3, 56, 128), dtype=torch.uint8),
                             PipelineConfig(method="hybrid"), 4, 48)
    with pytest.raises(ValueError, match="cannot hold"):
        fused_retinex_canvas(torch.zeros((1, 3, 56, 128), dtype=torch.uint8),
                             PipelineConfig(), 4, 50)
