"""The nets' conv_impl arms gemm, packed and packed12 (``apply_*_gemm``,
``apply_*_packed``, ``ops/patch_conv.py``) against the JAX package's same
arms, on weights carried over from it (``params_from_numpy``): each net
under each arm, a gradient through the packed arms, ``EnhancePipeline``
end to end and one video step.

Bars: the nets in float32 within 3e-6 (gemm) and 3e-5 (packed), the JAX
package's own bars against its xla arm (``tests/unit/
test_model_gemm_parity.py``, ``test_model_packed_parity.py``; each conv
form in bf16 is held to one bf16 step in tests/test_torch_patch_conv.py);
the gradients within 1e-5; pipelines and the video step in float32 max
|du8| <= 1 with a changed share < 1e-3. The JAX references run under
``jax.jit``."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu import video as jvideo
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.models import curve_cnn as jcnn
from low_light_image_enhancement_tpu.models import decom as jdecom
from low_light_image_enhancement_tpu.models import fcn as jfcn
from low_light_image_enhancement_tpu_torch import pipeline as tpipe
from low_light_image_enhancement_tpu_torch import video as tvideo
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.models import curve_cnn as tcnn
from low_light_image_enhancement_tpu_torch.models import decom as tdecom
from low_light_image_enhancement_tpu_torch.models import fcn as tfcn
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

# net -> (layer widths (Cin, Cout, k), JAX module, port module, apply
# name, input shape): fcn tall enough that its dilation-32 layer has
# interior pixels
_NETS = {
    "curve": ([(3, 8, 3)] + [(8, 8, 3)] * 3 + [(16, 8, 3)] * 2
              + [(16, 6, 3)], jcnn, tcnn, "apply_curve_cnn",
              (2, 3, 16, 24)),
    "fcn": ([(3, 8, 3)] + [(8, 8, 3)] * 6 + [(8, 3, 1)], jfcn, tfcn,
            "apply_fcn", (1, 3, 72, 80)),
    "decom": ([(4, 8, 3)] + [(8, 8, 3)] * 3 + [(8, 4, 3)], jdecom, tdecom,
              "apply_decom_net", (2, 3, 16, 24)),
}
# arm -> (function suffix, keyword arguments, float32 bar)
_ARMS = {"gemm": ("_gemm", {}, 3e-6),
         "packed": ("_packed", {}, 3e-5),
         "packed12": ("_packed", {"block": (1, 2)}, 3e-5)}


def _params(widths, seed=3):
    """He-scaled HWIO weights and small biases from a seeded numpy draw,
    named as the nets name them (fcn's 1x1 head ``out``)."""
    rng = np.random.default_rng(seed)
    params = {}
    for i, (cin, cout, k) in enumerate(widths, start=1):
        w = rng.standard_normal((k, k, cin, cout)) * np.sqrt(
            2.0 / (k * k * cin))
        params["out" if k == 1 else f"c{i}"] = {
            "w": w.astype(np.float32),
            "b": (0.05 * rng.standard_normal(cout)).astype(np.float32)}
    return params


def _net(name, arm):
    """(JAX params, port params, JAX apply, port apply, input)."""
    widths, jmod, tmod, fn, shape = _NETS[name]
    suffix, kw, _ = _ARMS[arm]
    params = _params(widths)
    kw = dict(kw, n_iter=2) if name == "curve" else kw
    x = np.random.default_rng(4).random(shape, dtype=np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, params),
            params_from_numpy(params),
            functools.partial(getattr(jmod, fn + suffix), **kw),
            functools.partial(getattr(tmod, fn + suffix), **kw), x)


def _outs(y):
    """A net's output (one array, or decom's (R, L)) as numpy arrays."""
    return [np.asarray(t, np.float32)
            for t in (y if isinstance(y, tuple) else (y,))]


@pytest.mark.parametrize("arm", sorted(_ARMS))
@pytest.mark.parametrize("name", sorted(_NETS))
def test_net_arm_matches_jax(name, arm):
    jp, tp, japply, tapply, x = _net(name, arm)
    want = jax.jit(lambda p, x: japply(p, x, compute_dtype=jnp.float32))(
        jp, jnp.asarray(x))
    got = tapply(tp, torch.from_numpy(x), compute_dtype="float32")
    for g, w in zip(_outs(got), _outs(want)):
        assert g.shape == w.shape
        d = float(np.abs(g - w).max())
        print(f"{name} {arm}: max |d| {d:.3g}")
        assert d <= _ARMS[arm][2], d


@pytest.mark.parametrize("name", sorted(_NETS))
def test_packed_gradient_matches_jax(name):
    """d mean(out^2) / d params through the packed arm (the packing under
    autograd, not cached) against ``jax.grad`` of the JAX packed arm."""
    jp, tp, japply, tapply, x = _net(name, "packed")

    def jloss(p):
        return sum(jnp.mean(o ** 2) for o in jax.tree_util.tree_leaves(
            japply(p, jnp.asarray(x), compute_dtype=jnp.float32)))

    want = jax.jit(jax.grad(jloss))(jp)
    leaves = {f"{k}.{n}": t.requires_grad_(True)
              for k, layer in tp.items() for n, t in layer.items()}
    out = tapply(tp, torch.from_numpy(x), compute_dtype="float32")
    loss = sum(torch.mean(o ** 2) for o in (out if isinstance(out, tuple)
                                            else (out,)))
    loss.backward()
    worst = 0.0
    for key, t in leaves.items():
        layer, n = key.split(".")
        w = np.asarray(want[layer][n])
        g = t.grad.numpy()
        g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
        worst = max(worst, float(np.abs(g - w).max()))
    print(f"{name}: max |d grad| {worst:.3g}")
    assert worst <= 1e-5, worst
    assert any(float(t.grad.abs().max()) > 0 for t in leaves.values())


def _delta(got, want):
    d = np.abs(got.astype(int) - want.astype(int))
    return d.max(), (d > 0).mean()


@pytest.mark.parametrize("kw", [
    dict(method="fcn", conv_impl="gemm"),
    dict(method="fcn", conv_impl="packed"),
    dict(method="fcn", conv_impl="packed12"),
    dict(method="hybrid", conv_impl="gemm"),
    dict(method="hybrid", conv_impl="packed"),
    dict(method="hybrid", conv_impl="packed12"),
    dict(method="hybrid", conv_impl="packed", curve_downsample=4),
    dict(method="curve", conv_impl="gemm", curve_downsample=4),
    dict(method="curve", conv_impl="packed12"),
    dict(method="decom", conv_impl="gemm"),
    dict(method="decom", conv_impl="packed", denoise_taps="guided"),
    dict(method="decom", conv_impl="packed12"),
], ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_pipeline_arm_matches_jax(kw):
    kw = dict(kw, compute_dtype="float32")
    lows, _ = synth_batch(2, 33, 47, seed=4)
    ref = jpipe.EnhancePipeline(JConfig(**kw), force_jnp=True)
    port = tpipe.EnhancePipeline(PipelineConfig(**kw), device="cpu",
                                 model_params=params_from_numpy(
                                     ref.model_params))
    got, want = port.enhance_batch(lows), ref.enhance_batch(lows)
    assert got.shape == lows.shape and got.dtype == np.uint8
    dmax, share = _delta(got, want)
    print(f"{kw}: max |du8| {dmax}, share {share:.3g}")
    assert dmax <= 1 and share < 1e-3, (dmax, share)


def test_video_step_packed_matches_jax():
    """Two frames of hybrid ds 4 under packed through VideoEnhancer (the
    video step reaches the net through blocks.curve_maps_for_kernel)."""
    kw = dict(method="hybrid", curve_downsample=4, conv_impl="packed",
              compute_dtype="float32")
    ref = jvideo.VideoEnhancer(JConfig(**kw), alpha=0.3)
    port = tvideo.VideoEnhancer(PipelineConfig(**kw), alpha=0.3,
                                model_params=params_from_numpy(
                                    ref.model_params), device="cpu")
    frames, _ = synth_batch(2, 40, 72, seed=3)
    for f in frames:
        dmax, share = _delta(port.process(f), ref.process(f))
        assert dmax <= 1 and share < 1e-3, (dmax, share)
