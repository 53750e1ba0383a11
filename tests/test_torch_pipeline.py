"""EnhancePipeline(device="cpu") against the JAX package's
EnhancePipeline(force_jnp=True) with the same weights.

Bars: retinex and float32 hybrid/curve, max |du8| <= 1 with a changed share
< 1e-3 (the JAX package's own bar between its kernels and its jnp path);
bf16 hybrid, PSNR >= 40 dB, since bf16 convs round at other places in the
two frameworks (tests/test_torch_models.py) and a one-step change of a
curve map moves some pixels by a u8 step or two."""

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.models import weights as jweights
from low_light_image_enhancement_tpu.config import PRESETS as JPRESETS
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu_torch import pipeline as tpipe
from low_light_image_enhancement_tpu_torch.config import (
    PRESETS,
    PipelineConfig,
)
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)


def _pair(kw, bucket=None):
    ref = jpipe.EnhancePipeline(JConfig(**kw), force_jnp=True, bucket=bucket)
    params = None if ref.model_params is None else \
        params_from_numpy(ref.model_params)
    port = tpipe.EnhancePipeline(PipelineConfig(**kw), model_params=params,
                                 device="cpu", bucket=bucket)
    return port, ref


def _delta(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return d.max(), (d > 0).mean()


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("size", [(64, 96), (33, 47)])
@pytest.mark.parametrize("kw", [
    dict(), dict(method="hybrid", compute_dtype="float32"),
    dict(method="curve", compute_dtype="float32"),
])
def test_pipeline_matches_jax(kw, size):
    lows, _ = synth_batch(2, *size)
    port, ref = _pair(kw)
    got, want = port.enhance_batch(lows), ref.enhance_batch(lows)
    assert got.shape == lows.shape and got.dtype == np.uint8
    dmax, share = _delta(got, want)
    assert dmax <= 1 and share < 1e-3, (dmax, share)


@pytest.mark.parametrize("method", ["curve", "hybrid"])
def test_lowres_maps_pipeline_matches_jax(method):
    """curve_downsample 4: the CNN at 1/4 (the antialiased downsample),
    K3 upsampling the maps (found: max |du8| 0 at 40x72 b2)."""
    lows, _ = synth_batch(2, 40, 72, seed=3)
    port, ref = _pair(dict(method=method, curve_downsample=4,
                           compute_dtype="float32"))
    dmax, share = _delta(port.enhance_batch(lows), ref.enhance_batch(lows))
    assert dmax <= 1 and share < 1e-3, (dmax, share)


@pytest.mark.parametrize("size", [(64, 96), (33, 47)])
def test_hybrid_bf16_psnr_vs_jax(size):
    lows, _ = synth_batch(2, *size, seed=1)
    port, ref = _pair(dict(method="hybrid"))
    p = _psnr(port.enhance_batch(lows), ref.enhance_batch(lows))
    assert p >= 40.0, p


def test_bucket_crops_back_exactly():
    lows, _ = synth_batch(2, 33, 47, seed=2)
    port, ref = _pair(dict(method="hybrid", compute_dtype="float32"),
                      bucket=64)
    got = port.enhance_batch(lows)
    assert got.shape == lows.shape
    dmax, share = _delta(got, ref.enhance_batch(lows))
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    single = port.enhance(lows[1])
    np.testing.assert_array_equal(single, got[1])
    np.testing.assert_array_equal(port(lows[1]), single)


def test_default_params_are_the_shipped_weights():
    hybrid = tpipe.EnhancePipeline(PipelineConfig(method="hybrid"),
                                   device="cpu")
    want = params_from_numpy(
        jpipe.EnhancePipeline(JConfig(method="hybrid"),
                              force_jnp=True).model_params)
    for name, layer in want.items():
        torch.testing.assert_close(hybrid.model_params[name]["w"], layer["w"],
                                   rtol=0, atol=0)
    assert tpipe.EnhancePipeline(device="cpu").model_params is None
    # a width the shipped weights do not have: random init from the seed
    a = tpipe.EnhancePipeline(PipelineConfig(method="curve",
                                             curve_features=8),
                              device="cpu", rng_seed=3)
    b = tpipe.EnhancePipeline(PipelineConfig(method="curve",
                                             curve_features=8),
                              device="cpu", rng_seed=3)
    assert a.model_params["c1"]["w"].shape == (8, 3, 3, 3)
    torch.testing.assert_close(a.model_params["c2"]["w"],
                               b.model_params["c2"]["w"], rtol=0, atol=0)


@pytest.mark.parametrize("kw,ported", [
    (dict(method="hybrid", denoise_taps="guided", compute_dtype="float32"),
     True),
    (dict(method="curve", denoise_taps="guided", compute_dtype="float32"),
     True),
    # the sharded configs, ported since these ids were given (parallel/):
    # against the JAX package's sharded pipeline on its fake devices
    pytest.param(dict(spatial_shards=2), True, id="kw2-False"),
    pytest.param(dict(data_shards=2), True, id="kw3-False"),
    (dict(denoise_taps="guided"), True),
    (dict(method="hybrid", curve_downsample=4, denoise_taps="guided",
          compute_dtype="float32"), True),
    # the conv_impl arms of ops/patch_conv.py, ported since these ids were
    # given, in the default bf16
    pytest.param(dict(method="fcn", conv_impl="gemm"), True, id="kw6-False"),
    pytest.param(dict(method="hybrid", conv_impl="packed12"), True,
                 id="kw7-False"),
])
def test_unported_configs_raise(kw, ported):
    """The configs still to port raise; the guided tails on retinex, curve
    and hybrid, the sharded configs and the gemm/packed conv arms, which
    raised before they were ported, match the JAX package's jnp path: max
    |du8| <= 1 on a share < 1e-3 of the values, and with bf16 nets PSNR >=
    40 dB (the bar of bf16 nets: XLA computes a fused chain of bf16 ops in
    float32 and rounds once, the port rounds op by op)."""
    if not ported:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tpipe.EnhancePipeline(PipelineConfig(**kw), device="cpu")
        return
    lows, _ = synth_batch(2, 33, 47, seed=4)
    port, ref = _pair(kw)
    got, want = port.enhance_batch(lows), ref.enhance_batch(lows)
    dmax, share = _delta(got, want)
    if kw.get("method", "retinex") != "retinex" and \
            kw.get("compute_dtype", "bfloat16") == "bfloat16":
        assert dmax <= 1 and _psnr(got, want) >= 40.0, (dmax, share)
        return
    assert dmax <= 1 and share < 1e-3, (dmax, share)


def test_device_is_explicit_and_inputs_are_checked():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpipe.EnhancePipeline(device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            tpipe.enhance(np.zeros((8, 8, 3), np.uint8))
    with pytest.raises(ValueError):
        tpipe.EnhancePipeline(device="meta")
    pipe = tpipe.EnhancePipeline(device="cpu")
    with pytest.raises(TypeError):
        pipe.enhance_batch_device(torch.zeros((1, 8, 8, 3)))
    with pytest.raises(ValueError):
        pipe.enhance_batch_device(torch.zeros((1, 8, 8, 4), dtype=torch.uint8))
    with pytest.raises(ValueError):
        pipe.enhance(np.zeros((8, 8), np.uint8))
    out = pipe.enhance_batch_device(torch.zeros((1, 8, 8, 3),
                                                dtype=torch.uint8))
    assert out.device.type == "cpu" and out.shape == (1, 8, 8, 3)
    pipe.warmup([(2, 16, 24)])


# ------------------------------------------------- fcn, decom, the presets #

_LEARNED = {
    # the quality frontier: decom, decom_relit_guided, guided tail r=4
    "quality": (PRESETS["quality"], JPRESETS["quality"]),
    # fcn with the default luma/sep/exp bilateral tail
    "quality_fast": (PRESETS["quality_fast"], JPRESETS["quality_fast"]),
    "decom-bilateral": (PipelineConfig(method="decom"),
                        JConfig(method="decom")),
}


def _learned_pair(name, compute_dtype):
    tcfg, jcfg = _LEARNED[name]
    ref = jpipe.EnhancePipeline(jcfg.replace(compute_dtype=compute_dtype),
                                force_jnp=True)
    port = tpipe.EnhancePipeline(tcfg.replace(compute_dtype=compute_dtype),
                                 model_params=params_from_numpy(
                                     ref.model_params), device="cpu")
    return port, ref


@pytest.mark.parametrize("name", sorted(_LEARNED))
def test_learned_preset_f32_matches_jax(name):
    """float32 nets: max |du8| <= 1, as for hybrid. Measured at 40x72 b2:
    0 for all three. decom's relight is a true power (``**``), which XLA
    and PyTorch may round an ulp apart, so a u8 step stays allowed."""
    lows, _ = synth_batch(2, 40, 72)
    port, ref = _learned_pair(name, "float32")
    got, want = port.enhance_batch(lows), ref.enhance_batch(lows)
    assert got.shape == lows.shape and got.dtype == np.uint8
    dmax, share = _delta(got, want)
    assert dmax <= 1 and share < 1e-3, (dmax, share)


@pytest.mark.parametrize("name", sorted(_LEARNED))
def test_learned_preset_bf16_psnr_vs_jax(name):
    """bfloat16 nets: PSNR >= 40 dB, hybrid's bar for bf16. Measured at
    40x72 b2: 57-65 dB, 2-12% of values one u8 step off (the jitted JAX
    pipeline drops some of the bf16 roundings between fused ops)."""
    lows, _ = synth_batch(2, 40, 72, seed=1)
    port, ref = _learned_pair(name, "bfloat16")
    p = _psnr(port.enhance_batch(lows), ref.enhance_batch(lows))
    assert p >= 40.0, p


def test_learned_default_params_are_the_shipped_weights():
    for method, weights in (("fcn", "fcn"), ("decom", "decom_relit")):
        pipe = tpipe.EnhancePipeline(PipelineConfig(method=method),
                                     device="cpu")
        want = params_from_numpy(jweights.resolve_weights(weights))
        assert set(pipe.model_params) == set(want)
        for name, layer in want.items():
            torch.testing.assert_close(pipe.model_params[name]["w"],
                                       layer["w"], rtol=0, atol=0)
    quality = tpipe.EnhancePipeline(PRESETS["quality"], device="cpu")
    torch.testing.assert_close(
        quality.model_params["c1"]["w"],
        params_from_numpy(jweights.resolve_weights(
            "decom_relit_guided"))["c1"]["w"], rtol=0, atol=0)
