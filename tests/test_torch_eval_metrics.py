"""The port's eval metrics (eval/metrics.py) against the JAX package's, on
the same random u8 pairs (numpy, seeded). Bar: 1e-4 (float32 sums in
another order; the cube root is a power in the port, ``cbrt`` in JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.eval import metrics as jm
from low_light_image_enhancement_tpu_torch.data.synth import synth_pair
from low_light_image_enhancement_tpu_torch.eval import metrics as tm


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    noise = rng.integers(-20, 21, shape)
    return a, np.clip(a.astype(int) + noise, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(3, 24, 40, 3), (17, 29, 3)],
                         ids=["batch", "single"])
@pytest.mark.parametrize("name", ["psnr_u8", "ssim_u8", "delta_e76_u8"])
def test_metric_matches_jax(name, shape):
    a, b = _pair(shape, seed=len(shape))
    got = getattr(tm, name)(torch.from_numpy(a), torch.from_numpy(b))
    want = np.asarray(getattr(jm, name)(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_metrics_on_an_eval15_pair():
    """The synthetic eval-15 set's first pair (what LOLDataset('eval15')
    reads with no LOL data on disk) gives the same numbers."""
    low, high = synth_pair(0, 40, 60, seed=0)
    for name in ("psnr_u8", "ssim_u8", "delta_e76_u8"):
        got = float(getattr(tm, name)(torch.from_numpy(low),
                                      torch.from_numpy(high)))
        want = float(getattr(jm, name)(jnp.asarray(low), jnp.asarray(high)))
        assert abs(got - want) <= 1e-4 * max(1.0, abs(want)), (name, got,
                                                               want)
    identical = tm.psnr_u8(torch.from_numpy(low), torch.from_numpy(low))
    assert float(identical) == pytest.approx(120.0)
