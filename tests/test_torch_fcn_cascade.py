"""K7 (kernels/fcn_cascade.py) and the fcn net's conv_impl="cascade" arm
against the JAX package's cascade kernel and net, run in interpret mode on
the CPU, and the pipeline under conv_impl="cascade" against the JAX
pipeline with its kernels in interpret mode.

Bars: float32 within 1e-5 over the six layers; the pipeline float32 max
|du8| <= 1 with a changed share < 1e-3, bf16 PSNR >= 40 dB. The JAX
kernel and net run under ``jax.jit``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.kernels import fcn_cascade as jcas
from low_light_image_enhancement_tpu.kernels.mxu_conv import (
    pack_dense9_weights,
)
from low_light_image_enhancement_tpu.models import weights as jweights
from low_light_image_enhancement_tpu.ops.patch_conv import (
    depth_to_space,
    space_to_depth,
)
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.kernels import fcn_cascade as tcas
from low_light_image_enhancement_tpu_torch.kernels import mxu_conv as tmx
from low_light_image_enhancement_tpu_torch.models.fcn import _dilations
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)
from test_torch_mxu_conv import assert_within, check_pipeline, pipeline_pair

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

DILS = _dilations()[1:]   # 2, 4, 8, 16, 32, 1


def _stack(seed=0, c=24):
    """Unit-scale NHWC input (2, 70, 72, c): 70 rows are a multiple of no
    tile or band; He-scaled HWIO weights and biases of six layers."""
    rng = np.random.default_rng(seed)
    x = rng.random((2, 70, 72, c), dtype=np.float32)
    ws = [(rng.standard_normal((3, 3, c, c)) * np.sqrt(2.0 / (9 * c)))
          .astype(np.float32) for _ in DILS]
    bs = [(0.1 * rng.standard_normal(c)).astype(np.float32) for _ in DILS]
    return x, ws, bs


def _torch_stack(ws, bs):
    return ([torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
             for w in ws], [torch.from_numpy(b) for b in bs])


def test_cascade_plain_matches_jax_kernel():
    x, ws, bs = _stack()
    want = jax.jit(lambda x, ws, bs: depth_to_space(jcas.fcn_cascade_mxu(
        space_to_depth(x),
        [pack_dense9_weights(w, dilation=d) for w, d in zip(ws, DILS)],
        bs, [max(1, d // 2) for d in DILS], interpret=True)))(x, ws, bs)
    tws, tbs = _torch_stack(ws, bs)
    got = tcas.fcn_cascade_mxu(torch.from_numpy(x), tws, tbs, DILS)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert_within(got.numpy(), want, "float32")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_is_the_layers_in_turn(dtype):
    """The cascade equals K6b layer by layer, bit for bit."""
    x, ws, bs = _stack(seed=1, c=8)
    tws, tbs = _torch_stack(ws, bs)
    xt = torch.from_numpy(x).to(dtype)
    want = xt
    for w, b, d in zip(tws, tbs, DILS):
        want = tmx.conv2d_dense9_mxu(want, w, b, act="leaky", dilation=d)
    got = tcas.fcn_cascade_mxu(xt, tws, tbs, DILS)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tcas.fcn_cascade_mxu.launches == 0


def test_cascade_checks_its_arguments():
    x, ws, bs = _stack(seed=2, c=8)
    tws, tbs = _torch_stack(ws, bs)
    xt = torch.from_numpy(x)
    with pytest.raises(ValueError, match="layers"):
        tcas.fcn_cascade_mxu(xt, tws, tbs[:-1], DILS)
    with pytest.raises(ValueError, match="layers"):
        tcas.fcn_cascade_mxu(xt, tws * 2, tbs * 2, DILS * 2)
    wide = torch.zeros((16, 8, 3, 3))
    with pytest.raises(ValueError, match="width"):
        tcas.fcn_cascade_mxu(xt, [wide], [torch.zeros(16)], [1])


def test_apply_fcn_cascade_matches_jax():
    """The shipped fcn weights at 80x96, float32."""
    params = jweights.resolve_weights("fcn")
    x = np.random.default_rng(3).random((2, 3, 80, 96), dtype=np.float32)
    want = jax.jit(functools.partial(
        jcas.apply_fcn_cascade, compute_dtype=jnp.float32,
        interpret=True))(params, jnp.asarray(x))
    got = tcas.apply_fcn_cascade(params_from_numpy(params),
                                 torch.from_numpy(x), compute_dtype="float32")
    assert got.shape == want.shape
    assert_within(got.numpy(), want, "float32")


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
def test_cascade_pipeline_matches_jax(compute_dtype):
    lows, _ = synth_batch(2, 24, 40, seed=4)
    port, ref = pipeline_pair(
        PipelineConfig(method="fcn", conv_impl="cascade"),
        JConfig(method="fcn", conv_impl="cascade"), compute_dtype)
    check_pipeline(port, ref, lows, compute_dtype)
