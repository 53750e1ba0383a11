"""The port's guided filter (ops/guided.py), its dispatch through
ops/denoise.py and core.denoise_tail, against the JAX package's, on the
same random planes (numpy, seeded).

Bars: the integral-image public ops within 1e-6 (cumsum sums in another
order in the two frameworks); the shift cores bit-equal, since both run
the same eager ops in the same order (JAX eagerly, not under jit, which
fuses and rounds some sums differently)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.ops import denoise as jdn
from low_light_image_enhancement_tpu.ops import filters as jf
from low_light_image_enhancement_tpu.ops import guided as jg
from low_light_image_enhancement_tpu_torch import core as tcore
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.ops import denoise as tdn
from low_light_image_enhancement_tpu_torch.ops import filters as tf
from low_light_image_enhancement_tpu_torch.ops import guided as tg


def _planes(shape, seed=0):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize("radius", [0, 1, 3])
def test_box_mean_matches(radius):
    x = _planes((2, 3, 13, 21), seed=radius)
    np.testing.assert_allclose(
        tg.box_mean(torch.from_numpy(x), radius).numpy(),
        np.asarray(jg.box_mean(jnp.asarray(x), radius)), rtol=0, atol=1e-6)


def test_guided_filter_and_denoise_match():
    x = _planes((2, 3, 16, 24), seed=4)
    guide = _planes((2, 1, 16, 24), seed=5)
    np.testing.assert_allclose(
        tg.guided_filter(torch.from_numpy(x), torch.from_numpy(guide), 2,
                         1e-2).numpy(),
        np.asarray(jg.guided_filter(jnp.asarray(x), jnp.asarray(guide), 2,
                                    1e-2)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tg.guided_denoise(torch.from_numpy(x), 3, 1e-2, 0.7).numpy(),
        np.asarray(jg.guided_denoise(jnp.asarray(x), 3, 1e-2, 0.7)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize("radius", [1, 2, 4])
def test_shift_cores_bit_equal(radius):
    x = _planes((3, 24, 40), seed=10 + radius)
    tx, jx = torch.from_numpy(x), jnp.asarray(x)
    np.testing.assert_array_equal(
        tg.box_mean_shift(tx, radius, tf.roll2d).numpy(),
        np.asarray(jg.box_mean_shift(jx, radius, jf.roll2d)))
    np.testing.assert_array_equal(
        tg.guided_core_shift(tx[0], 1e-2, 0.8, tf.roll2d, radius).numpy(),
        np.asarray(jg.guided_core_shift(jx[0], 1e-2, 0.8, jf.roll2d,
                                        radius)))
    got = tg.guided_joint_core_shift([tx[c] for c in range(3)], 1e-2, 1.0,
                                     tf.roll2d, radius)
    want = jg.guided_joint_core_shift([jx[c] for c in range(3)], 1e-2, 1.0,
                                      jf.roll2d, radius)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("guide", ["luma", "perchannel"])
def test_denoise_planar_guided_matches(guide):
    x = _planes((2, 3, 20, 36), seed=20)
    got = tdn.denoise_planar(torch.from_numpy(x), 12.5, 1.0, tf.roll2d,
                             "exp", guide, "guided", 3, 1e-2)
    want = jdn.denoise_planar(jnp.asarray(x), 12.5, 1.0, jf.roll2d, "exp",
                              guide, "guided", 3, 1e-2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_denoise_tail_passes_the_guided_radius_and_eps():
    """core.denoise_tail runs the config's guided_radius and guided_eps; the
    cores' own defaults (r=2, eps 3e-3) are not the config's (eps 1e-2)."""
    x = _planes((1, 3, 24, 40), seed=21)
    cfg = PipelineConfig(method="decom", denoise_taps="guided",
                         guided_radius=4)
    got = tcore.denoise_tail(torch.from_numpy(x), cfg).numpy()
    inv2s2 = 1.0 / (2.0 * cfg.denoise_sigma * cfg.denoise_sigma)
    want = jdn.denoise_planar(jnp.asarray(x), inv2s2, cfg.denoise_strength,
                              jf.roll2d, cfg.denoise_kernel,
                              cfg.denoise_guide, "guided", 4, 1e-2)
    np.testing.assert_array_equal(got, np.asarray(want))
    defaults = jdn.denoise_planar(jnp.asarray(x), inv2s2,
                                  cfg.denoise_strength, jf.roll2d,
                                  cfg.denoise_kernel, cfg.denoise_guide,
                                  "guided")
    assert np.abs(got - np.asarray(defaults)).max() > 1e-3
