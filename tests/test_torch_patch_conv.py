"""The port's ``ops/patch_conv.py`` (the conv_impl arms gemm, packed and
packed12) against the JAX package's, on the same seeded numpy inputs: the
space-to-depth packing and every weight packer equal, the three conv forms
within 2e-5 in float32 (the JAX package's own bar against ``lax.conv``,
``tests/unit/test_patch_conv.py``) and within one bf16 step in bf16. The
JAX references run under ``jax.jit``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.ops import patch_conv as jpc
from low_light_image_enhancement_tpu_torch.ops import patch_conv as tpc

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

F32_BAR = 2e-5
_DT = {"float32": (jnp.float32, torch.float32),
       "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _hwio(cin, cout, seed):
    """He-scaled (3, 3, Cin, Cout) weights and a bias, numpy f32."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((3, 3, cin, cout))
         * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    return w, (0.1 * rng.standard_normal(cout)).astype(np.float32)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _nhwc(shape, seed):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def _close(got, want, dtype):
    """float32: within ``F32_BAR``; bf16: at most one bf16 step of the
    larger magnitude apart (the f32 sums differ in order and round to
    neighbouring bf16 values now and then)."""
    got = np.asarray(torch.as_tensor(got).float(), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    d = np.abs(got - want)
    print(f"max |d| {d.max():.3g}")
    if dtype == "float32":
        assert d.max() <= F32_BAR, d.max()
        return
    mag = np.maximum(np.abs(got), np.abs(want))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    assert np.all(d <= np.maximum(step, F32_BAR)), d.max()


@pytest.mark.parametrize("block", [(2, 2), (1, 2)])
def test_space_to_depth_matches_jax(block):
    x = _nhwc((2, 8, 12, 5), 0)
    got = tpc.space_to_depth(torch.from_numpy(x), block)
    want = np.asarray(jpc.space_to_depth(jnp.asarray(x), block))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tpc.depth_to_space(got, block).numpy(),
        np.asarray(jpc.depth_to_space(jnp.asarray(want), block)))
    np.testing.assert_array_equal(tpc.depth_to_space(got, block).numpy(), x)
    # phase-major: feature p*C + c holds pixel (bh*Y + py, bw*X + px, c),
    # unlike F.pixel_unshuffle's c*P + p
    bh, bw = block
    p = (bh - 1) * bw + 1
    assert got[0, 1, 2, p * 5 + 4] == x[0, bh + bh - 1, 2 * bw + 1, 4]
    with pytest.raises(ValueError, match="space_to_depth"):
        tpc.space_to_depth(torch.zeros((1, 7, 12, 3)), (2, 2))


def test_packers_match_jax():
    """Every packer equal to the JAX package's, structural zeros exact: the
    patch slabs (one group and a skip concat of two), the bias, the im2col
    matrix and the block conv's weights at every (block, dilation) the nets
    reach, in F.conv2d's (out, in, kh, kw) order."""
    w, b = _hwio(16, 8, 1)
    wt = _oihw(w)
    for groups in ((), (8, 8)):
        np.testing.assert_array_equal(
            tpc.pack_patch_weights(wt, groups).numpy(),
            np.asarray(jpc.pack_patch_weights(jnp.asarray(w), groups)))
    np.testing.assert_array_equal(
        tpc.pack_bias(torch.from_numpy(b)).numpy(),
        np.asarray(jpc.pack_bias(jnp.asarray(b))))
    np.testing.assert_array_equal(
        tpc.pack_im2col_weights(wt).numpy(),
        np.asarray(jpc.pack_im2col_weights(jnp.asarray(w))))
    for block in ((2, 2), (1, 2), (2, 1)):
        for dil in (1, 2, 4, 32):
            for groups in ((), (8, 8)):
                want = np.asarray(jpc.pack_block_conv_weights(
                    jnp.asarray(w), groups, dilation=dil, block=block))
                got = tpc.pack_block_conv_weights(
                    wt, groups, dilation=dil, block=block)
                np.testing.assert_array_equal(
                    got.numpy(), want.transpose(3, 2, 0, 1))
    with pytest.raises(ValueError, match="incompatible"):
        tpc.pack_block_conv_weights(wt, dilation=3)
    assert tpc.even_image(33, 47) == jpc.even_image(33, 47) == (34, 48)


@pytest.mark.parametrize("dtype", sorted(_DT))
def test_conv2d_patch_gemm_matches_jax(dtype):
    """The patch GEMM on a skip concat of two packed inputs (groups)."""
    jd, td = _DT[dtype]
    a, c = _nhwc((2, 16, 24, 8), 2), _nhwc((2, 16, 24, 8), 3)
    w, b = _hwio(16, 8, 4)
    jx = jnp.concatenate([jpc.space_to_depth(jnp.asarray(a)),
                          jpc.space_to_depth(jnp.asarray(c))], -1)
    want = jax.jit(lambda x, w, b: jpc.conv2d_patch_gemm(
        x, jpc.pack_patch_weights(w, (8, 8)), jpc.pack_bias(b), jd,
        groups=(8, 8)))(jx, jnp.asarray(w), jnp.asarray(b))
    xp = torch.from_numpy(np.array(jx))
    got = tpc.conv2d_patch_gemm(xp, tpc.pack_patch_weights(_oihw(w), (8, 8)),
                                tpc.pack_bias(torch.from_numpy(b)), td,
                                groups=(8, 8))
    assert got.dtype == td
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("dil", [1, 2, 8])
def test_conv2d_im2col_gemm_matches_jax(dil, dtype):
    jd, td = _DT[dtype]
    x = _nhwc((2, 16, 24, 8), 5)
    w, b = _hwio(8, 8, 6)
    want = jax.jit(lambda x, w, b: jpc.conv2d_im2col_gemm(
        x, jpc.pack_im2col_weights(w), b, jd, dilation=dil))(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tpc.conv2d_im2col_gemm(torch.from_numpy(x),
                                 tpc.pack_im2col_weights(_oihw(w)),
                                 torch.from_numpy(b), td, dilation=dil)
    assert got.dtype == td
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", sorted(_DT))
@pytest.mark.parametrize("dil", [1, 2])
@pytest.mark.parametrize("block", [(2, 2), (1, 2)])
def test_conv2d_block_xla_matches_jax(block, dil, dtype):
    jd, td = _DT[dtype]
    bh, bw = block
    step = (max(1, dil // bh), max(1, dil // bw))
    x = _nhwc((2, 16, 24, 8), 7)
    w, b = _hwio(8, 8, 8)
    jx = jpc.space_to_depth(jnp.asarray(x), block)
    want = jax.jit(lambda x, w, b: jpc.conv2d_block_xla(
        x, jpc.pack_block_conv_weights(w, dilation=dil, block=block), b, jd,
        step=step))(jx, jnp.asarray(w), jnp.asarray(b))
    got = tpc.conv2d_block_xla(
        torch.from_numpy(np.array(jx)),
        tpc.pack_block_conv_weights(_oihw(w), dilation=dil, block=block),
        torch.from_numpy(b), td, step=step)
    assert got.dtype == td
    _close(got, want, dtype)


def test_cached_pack_once_per_parameter_and_not_under_grad():
    """A parameter set packs once per dtype and form, again after an
    in-place change; with a gradient to flow it packs on every call, so
    autograd sees the packing."""
    w = _oihw(_hwio(8, 8, 9)[0])
    calls = []

    def pack():
        calls.append(1)
        return tpc.pack_block_conv_weights(w)

    a = tpc.cached_pack((w,), "float32", "test form", pack)
    assert tpc.cached_pack((w,), torch.float32, "test form", pack) is a
    assert len(calls) == 1
    tpc.cached_pack((w,), "bfloat16", "test form", pack)
    assert len(calls) == 2
    w.mul_(2.0)
    b = tpc.cached_pack((w,), "float32", "test form", pack)
    assert len(calls) == 3 and torch.equal(b, 2.0 * a)
    wg = w.clone().requires_grad_(True)
    g1 = tpc.cached_pack((wg,), "float32", "g", lambda: wg * 1.0)
    g2 = tpc.cached_pack((wg,), "float32", "g", lambda: wg * 1.0)
    assert g1 is not g2 and g1.requires_grad
