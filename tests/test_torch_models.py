"""The nets (curve CNN, fcn, decom) and their weights against the JAX
package's, with the shipped weights given to both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.models import curve_cnn as jcnn
from low_light_image_enhancement_tpu.models import decom as jdecom
from low_light_image_enhancement_tpu.models import fcn as jfcn
from low_light_image_enhancement_tpu.models import layers as jlayers
from low_light_image_enhancement_tpu.models import weights as jweights
from low_light_image_enhancement_tpu_torch.models import curve_cnn as tcnn
from low_light_image_enhancement_tpu_torch.models import decom as tdecom
from low_light_image_enhancement_tpu_torch.models import fcn as tfcn
from low_light_image_enhancement_tpu_torch.models import layers as tlayers
from low_light_image_enhancement_tpu_torch.models import weights as tweights

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)


def he_params(init, seed=0):
    """Parameters of the shapes ``init`` (a JAX package initialiser of no
    arguments) makes, read by ``jax.eval_shape`` (nothing runs), drawn as
    its initialisers draw them, with numpy: He-normal weights (HWIO) and
    zero biases. JAX's eager random init compiles op by op."""
    rng = np.random.default_rng(seed)

    def draw(leaf):
        if len(leaf.shape) != 4:
            return np.zeros(leaf.shape, np.float32)
        kh, kw, cin, _ = leaf.shape
        return (rng.standard_normal(leaf.shape)
                * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)

    return jax.tree_util.tree_map(draw, jax.eval_shape(init))


def _hybrid_weights():
    return jweights.load_pretrained("hybrid")


def _input(seed=0, shape=(2, 3, 32, 48)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def test_shipped_weights_load_the_same():
    for name in ("hybrid", "curve", "zeroref"):
        want = jweights.resolve_weights(name)
        got = tweights.resolve_weights(name)
        assert set(got) == set(want)
        for layer in want:
            for k in ("w", "b"):
                np.testing.assert_array_equal(got[layer][k], want[layer][k])
    assert tweights.load_pretrained("nonexistent") is None
    with pytest.raises(FileNotFoundError):
        tweights.resolve_weights("no_such_weights")


def test_params_from_numpy_is_oihw():
    p = tweights.params_from_numpy(_hybrid_weights())
    hwio = _hybrid_weights()["c5"]["w"]
    assert p["c5"]["w"].shape == (32, 64, 3, 3)
    np.testing.assert_array_equal(p["c5"]["w"].numpy(),
                                  hwio.transpose(3, 2, 0, 1))
    assert p["c7"]["b"].shape == (24,) and p["c7"]["w"].is_contiguous()


@pytest.mark.parametrize("dilation", [1, 2])
def test_conv2d_matches(dilation):
    rng = np.random.default_rng(1)
    x = rng.random((2, 5, 12, 16), dtype=np.float32)
    w = rng.standard_normal((3, 3, 5, 7)).astype(np.float32)
    b = rng.standard_normal(7).astype(np.float32)
    want = jlayers.conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                          jnp.asarray(w), jnp.asarray(b), jnp.float32,
                          dilation)
    got = tlayers.conv2d(torch.from_numpy(x),
                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                         torch.from_numpy(b), "float32", dilation)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=0)


def test_curve_cnn_f32_matches():
    x = _input()
    want = jcnn.apply_curve_cnn(_hybrid_weights(), jnp.asarray(x), n_iter=8,
                                compute_dtype=jnp.float32)
    got = tcnn.apply_curve_cnn(tweights.params_from_numpy(_hybrid_weights()),
                               torch.from_numpy(x), n_iter=8,
                               compute_dtype="float32")
    assert got.shape == (2, 8, 3, 32, 48) and got.dtype == torch.float32
    # the two conv implementations sum the 3x3xCin products in different
    # orders: float32 rounding, compounded over 7 layers
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_curve_cnn_bf16_within_bf16_rounding():
    x = _input(seed=2)
    want = np.asarray(jcnn.apply_curve_cnn(
        _hybrid_weights(), jnp.asarray(x), n_iter=8,
        compute_dtype=jnp.bfloat16))
    got = tcnn.apply_curve_cnn(tweights.params_from_numpy(_hybrid_weights()),
                               torch.from_numpy(x), n_iter=8,
                               compute_dtype="bfloat16").numpy()
    # Every layer rounds its output (and the bias add) to bf16, an 8-bit
    # significand: 2^-8 of relative error per rounding. The frameworks
    # accumulate each conv in a different order, so a value near a bf16
    # rounding boundary lands on the neighbouring bf16 number in one of
    # them, and that step can carry through the later layers. Measured at
    # this size: at most one bf16 step of the tanh head's output (|a| <= 1,
    # one step <= 2^-8) and ~1e-5 on average. Bound: two steps, 1e-4 mean.
    err = np.abs(got - want)
    assert err.max() <= 2 * 2.0 ** -8, err.max()
    assert err.mean() <= 1e-4, err.mean()


def test_curve_cnn_single_image_and_init():
    gen = torch.Generator().manual_seed(0)
    p = tcnn.init_curve_cnn(gen, features=8, n_iter=4)
    assert p["c1"]["w"].shape == (8, 3, 3, 3)
    assert p["c7"]["w"].shape == (12, 16, 3, 3)
    p2 = tcnn.init_curve_cnn(torch.Generator().manual_seed(0), 8, 4)
    np.testing.assert_array_equal(p["c4"]["w"].numpy(), p2["c4"]["w"].numpy())
    x = torch.from_numpy(_input(seed=3, shape=(3, 10, 14)))
    a = tcnn.apply_curve_cnn(p, x, n_iter=4)
    assert a.shape == (4, 3, 10, 14)
    assert float(a.abs().max()) <= 1.0


# ------------------------------------------------------------ fcn, decom #

_NETS = {
    # name: (shipped weights, JAX apply, port apply)
    "fcn": ("fcn", jfcn.apply_fcn, tfcn.apply_fcn),
    "decom": ("decom_relit_guided", jdecom.apply_decom_net,
              tdecom.apply_decom_net),
}


def _net_outputs(name, x, compute_dtype):
    weights, japply, tapply = _NETS[name]
    w = jweights.resolve_weights(weights)
    want = japply(w, jnp.asarray(x), compute_dtype=jnp.dtype(compute_dtype))
    got = tapply(tweights.params_from_numpy(w), torch.from_numpy(x),
                 compute_dtype=compute_dtype)
    if name == "decom":
        return (torch.cat(got, dim=1).numpy(),
                np.concatenate([np.asarray(v) for v in want], axis=1))
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("name", ["fcn", "decom"])
def test_net_f32_matches(name):
    # 80 columns: fcn's dilation-32 layer reads beyond the zero padding
    got, want = _net_outputs(name, _input(seed=4, shape=(2, 3, 24, 80)),
                             "float32")
    assert got.shape == want.shape == (2, 3 if name == "fcn" else 4, 24, 80)
    assert got.dtype == np.float32
    # conv sums in another order, over 5 (decom) or 8 (fcn) layers
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["fcn", "decom"])
def test_net_bf16_within_two_bf16_steps(name):
    got, want = _net_outputs(name, _input(seed=5, shape=(2, 3, 24, 80)),
                             "bfloat16")
    # The sigmoid head's output lies in (0, 1), where one bf16 step is at
    # most 2^-8. As for the curve CNN, a conv sum near a rounding boundary
    # lands on the neighbouring bf16 value in one framework, and the step
    # carries through the later layers. Measured over 3 seeds at this size
    # (with the sigmoid in JAX's form, models/layers.py): 0.01-0.4% of the
    # outputs differ, by one step, and under 0.2% by two (2^-7); mean
    # 3e-7 to 2.4e-5. Bound: two steps, 1e-4 mean.
    err = np.abs(got - want)
    assert err.max() <= 2 * 2.0 ** -8, err.max()
    assert err.mean() <= 1e-4, err.mean()


def test_conv2d_1x1_keeps_the_spatial_shape():
    """A 1x1 conv (fcn's head) pads nothing: SAME padding is
    dilation * (k - 1) // 2, not the dilation."""
    rng = np.random.default_rng(6)
    x = rng.random((2, 24, 10, 14), dtype=np.float32)
    w = rng.standard_normal((1, 1, 24, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    want = jlayers.conv2d(jnp.asarray(x.transpose(0, 2, 3, 1)),
                          jnp.asarray(w), jnp.asarray(b), jnp.float32)
    got = tlayers.conv2d(torch.from_numpy(x),
                         torch.from_numpy(w.transpose(3, 2, 0, 1).copy()),
                         torch.from_numpy(b), "float32")
    assert got.shape == (2, 3, 10, 14)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(want).transpose(0, 3, 1, 2),
                               atol=1e-5, rtol=0)
    p = tfcn.init_fcn(torch.Generator().manual_seed(0))
    assert p["out"]["w"].shape == (3, 24, 1, 1)
    assert tfcn.apply_fcn(p, torch.zeros((3, 9, 13))).shape == (3, 9, 13)
    with pytest.raises(ValueError):
        tlayers.conv2d(torch.zeros((1, 3, 8, 8)), torch.zeros((4, 3, 2, 2)),
                       torch.zeros(4), "float32")


def test_fcn_and_decom_init_and_single_image():
    assert tfcn._dilations() == jfcn._dilations(7) == (1, 2, 4, 8, 16, 32, 1)
    a = tdecom.init_decom_net(torch.Generator().manual_seed(1))
    b = tdecom.init_decom_net(torch.Generator().manual_seed(1))
    assert a["c1"]["w"].shape == (32, 4, 3, 3)
    assert a["c5"]["w"].shape == (4, 32, 3, 3)
    np.testing.assert_array_equal(a["c3"]["w"].numpy(), b["c3"]["w"].numpy())
    r, l = tdecom.apply_decom_net(a, torch.from_numpy(
        _input(seed=7, shape=(3, 10, 14))))
    assert r.shape == (3, 10, 14) and l.shape == (1, 10, 14)
    assert float(r.min()) >= 0.0 and float(l.max()) <= 1.0
