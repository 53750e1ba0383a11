"""The port's training losses (train.py) against the JAX package's: each
objective's value and its gradients against ``jax.value_and_grad`` on the
same numpy batch and the same weights (``params_from_numpy``), in float32,
on inputs that hit the gradient ties (exact zeros, a saturated patch);
the loss terms, the in-loss denoise tails, the tie forms, the config and
the nets' ``nn.Module`` wrappers.

Tolerances: loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4 (float32,
sums in another order). The JAX reference runs jitted where its graph
compiles in about a second, and eagerly where it holds SSIM (110 shifts,
each way): eager JAX compiles an op once for all the cases that share it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import train as jt
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu.models.curve_cnn import (
    apply_curve_cnn as j_apply_curve,
)
from low_light_image_enhancement_tpu.models.decom import (
    apply_decom_net as j_apply_decom,
    init_decom_net as j_init_decom,
)
from low_light_image_enhancement_tpu.models.fcn import (
    apply_fcn as j_apply_fcn,
    init_fcn as j_init_fcn,
)
from low_light_image_enhancement_tpu_torch import models as tm
from low_light_image_enhancement_tpu_torch import train as tt
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
    params_to_numpy,
)

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4

# the JAX package's tiny training size (tests/integration/test_train.py)
TINY = jt.TrainConfig(features=8, n_iter=2, batch_size=4, crop=32,
                      compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_conv():
    """A process's first CPU conv may sum in another order than the next
    ones (7e-6 of the zero-reference loss, whose TV term weighs 1600): one
    runs before the comparisons."""
    torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                               torch.ones(4, 3, 3, 3), padding=1)


def port_cfg(jcfg):
    return tt.TrainConfig(**dataclasses.asdict(jcfg))


def tie_batch():
    """(low, high) planar f32: the synthetic lows (7% exact zeros), a
    saturated 8x8 patch of 1.0 in both, and a zero patch in the low."""
    lows, highs = synth_batch(TINY.batch_size, TINY.crop, TINY.crop, seed=0)
    low = (lows.astype(np.float32) / 255.0).transpose(0, 3, 1, 2).copy()
    high = (highs.astype(np.float32) / 255.0).transpose(0, 3, 1, 2).copy()
    low[:, :, 4:12, 4:12] = 1.0
    high[:, :, 4:12, 4:12] = 1.0
    low[:, :, 20:28, 20:28] = 0.0
    return low, high


def jax_params(net):
    key = jax.random.PRNGKey(0)
    if net == "curve":
        return jt.init_train_state(TINY)[0]
    if net == "fcn":
        return j_init_fcn(key, features=TINY.features)
    return j_init_decom(key)


B = dataclasses.replace(TINY, denoise_in_loss=True)
G = dataclasses.replace(B, loss_tail_taps="guided")
# name: (net, loss, config, batch args, whether the JAX loss holds SSIM)
CASES = {
    "zeroref": ("curve", "zero_reference_loss", TINY, 1, False),
    "zeroref_bilateral_tail": ("curve", "zero_reference_loss", B, 1, False),
    "paired_curve_guided_tail": ("curve", "paired_curve_loss", G, 2, True),
    "fcn_bilateral_tail": ("fcn", "paired_loss", B, 2, True),
    "decom": ("decom", "decom_loss", TINY, 2, False),
    "decom_relit_guided_tail": (
        "decom", "decom_loss", dataclasses.replace(G, w_relit=1.0), 2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_and_grads_match_jax(case):
    net, loss_name, jcfg, n_args, has_ssim = CASES[case]
    args = tie_batch()[:n_args]
    jp = jax_params(net)
    j_loss = getattr(jt, loss_name)
    vg = jax.value_and_grad(lambda p, *a: j_loss(p, *a, jcfg), has_aux=True)
    (lj, mj), gj = (vg if has_ssim else jax.jit(vg))(
        jp, *map(jnp.asarray, args))

    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    leaves = [t.requires_grad_(True) for t in tt._leaves(pp)]
    lt, mt = getattr(tt, loss_name)(pp, *map(torch.from_numpy, args),
                                    port_cfg(jcfg))
    grads = params_to_numpy(tt._rebuild(pp, torch.autograd.grad(lt, leaves)))
    mt = {k: v.detach() for k, v in mt.items()}

    assert sorted(mt) == sorted(mj)
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]),
                                   rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
    for name, layer in grads.items():
        for k, g in layer.items():
            np.testing.assert_allclose(g, np.asarray(gj[name][k]),
                                       atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                       err_msg=f"{case} {name}.{k}")


def test_tie_forms_take_jax_gradients():
    """At a clip bound JAX gives half the gradient and at |0| gives 1;
    torch.clamp and torch.abs give 1 and 0, which is why the losses take
    _clip and _abs."""
    x = np.array([-0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    gj_clip = jax.grad(lambda v: jnp.sum(jnp.clip(v, 0.0, 1.0)))(x)
    gj_abs = jax.grad(lambda v: jnp.sum(jnp.abs(v)))(x)
    for fn, want in ((lambda v: tt._clip(v, 0.0, 1.0), gj_clip),
                     (tt._abs, gj_abs)):
        xt = torch.from_numpy(x).requires_grad_(True)
        (g,) = torch.autograd.grad(fn(xt).sum(), xt)
        np.testing.assert_array_equal(g.numpy(), np.asarray(want))
    xt = torch.from_numpy(x).requires_grad_(True)
    (g,) = torch.autograd.grad(torch.clamp(xt, 0.0, 1.0).sum(), xt)
    assert not np.array_equal(g.numpy(), np.asarray(gj_clip))


def test_loss_terms_match_jax():
    """The four terms and the pool, on sizes the 16x16 and 4x4 windows do
    not divide (the rows and columns past the last window dropped)."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 37, 45), np.float32)
    y = rng.random((2, 3, 37, 45), np.float32)
    a = rng.uniform(-1, 1, (2, 2, 3, 37, 45)).astype(np.float32)
    xt, yt, at = map(torch.from_numpy, (x, y, a))
    pairs = [
        (jt._avg_pool_plane(jnp.asarray(y), 4), tt._avg_pool_plane(yt, 4)),
        (jt.exposure_loss(jnp.asarray(y), 0.32),
         tt.exposure_loss(yt, 0.32)),
        (jt.color_constancy_loss(jnp.asarray(y)),
         tt.color_constancy_loss(yt)),
        (jt.spatial_consistency_loss(jnp.asarray(x), jnp.asarray(y)),
         tt.spatial_consistency_loss(xt, yt)),
        (jt.smoothness_loss(jnp.asarray(a)), tt.smoothness_loss(at)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=LOSS_RTOL, atol=1e-7)


@pytest.mark.parametrize("taps", ["bilateral", "guided"])
def test_denoise_tail_matches_jax(taps):
    low, _ = tie_batch()
    y = np.clip(low * 1.7, 0.0, 1.0)
    jcfg = dataclasses.replace(B, loss_tail_taps=taps)
    want = jt._denoise_tail(jnp.asarray(y), jcfg)
    got = tt._denoise_tail(torch.from_numpy(y), port_cfg(jcfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError, match="loss_tail_taps"):
        tt._denoise_tail(torch.from_numpy(y),
                         tt.TrainConfig(loss_tail_taps="box"))


def test_train_config_is_the_jax_one():
    want = {f.name: f.default for f in dataclasses.fields(jt.TrainConfig)}
    got = {f.name: f.default for f in dataclasses.fields(tt.TrainConfig)}
    assert got == want


@pytest.mark.parametrize("net", ["curve", "fcn", "decom"])
def test_module_wrappers(net):
    """The nn.Module wrappers: parameters named as the params dict's
    layers, forward equal to the functional apply and to the JAX
    package's on the carried weights, init/apply the functional pair."""
    jp = jax_params(net)
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    cls, kw, j_apply = {
        "curve": (tm.CurveEstimatorCNN,
                  dict(features=TINY.features, n_iter=TINY.n_iter),
                  lambda p, x: j_apply_curve(p, x, n_iter=TINY.n_iter)),
        "fcn": (tm.EnhanceFCN, dict(features=TINY.features), j_apply_fcn),
        "decom": (tm.DecomNet, {}, j_apply_decom),
    }[net]
    mod = cls(params=pp, **kw)
    names = {f"{n}.{k}" for n, layer in pp.items() for k in layer}
    assert {n for n, _ in mod.named_parameters()} == names
    low, _ = tie_batch()
    got = mod(torch.from_numpy(low))
    want = j_apply(jp, jnp.asarray(low))
    got, want = (got, want) if net != "decom" else (got[0], want[0])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    fresh = mod.init(torch.Generator().manual_seed(1))
    assert set(fresh) == set(pp)
    assert all(fresh[n]["w"].shape == pp[n]["w"].shape for n in pp)
    out = mod.apply(fresh, torch.from_numpy(low))
    assert all(torch.isfinite(o).all() for o in
               (out if isinstance(out, tuple) else (out,)))
