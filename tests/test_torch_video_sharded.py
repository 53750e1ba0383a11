"""The port's SpatialShardedVideoEnhancer on a CPU mesh (the CPU device
repeated) against the port's single-device VideoEnhancer and the JAX
package's SpatialShardedVideoEnhancer on its eight fake CPU devices (its
jnp path), on the same flickering frames and weights.

The contract: each shard's EMA carry evolves as the single-device carry
does on every row the tail reads, so the frames match over a sequence, up
to u8 rounding ties: max |du8| <= 1 on < 1e-3 of the pixels (the JAX
package's own bar, tests/parallel/test_video_sharded.py), f32 nets.
"""

import functools

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import parallel as jpar
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu_torch import parallel as tpar
from low_light_image_enhancement_tpu_torch import video as tvideo
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.core import illumination_boost
from low_light_image_enhancement_tpu_torch.data.synth import synth_pair
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)

CPU = torch.device("cpu")

CASES = {
    "retinex": dict(),
    "curve ds2": dict(method="curve", curve_downsample=2,
                      compute_dtype="float32"),
    "hybrid ds2": dict(method="hybrid", curve_downsample=2,
                       compute_dtype="float32"),
}


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_boost():
    """A process's first illumination boost on the CPU may round apart
    from the next ones (tests/test_torch_parallel.py): one runs first."""
    illumination_boost(torch.rand(1, 3, 16, 16), PipelineConfig())


def cpu_mesh(n):
    return tpar.make_mesh(1, n, [CPU] * n)


def tvideo_sharded(cfg, n_spatial, make):
    return tpar.SpatialShardedVideoEnhancer(cpu_mesh(n_spatial), cfg, **make)


def flicker_frames(n=4, h=96, w=64, seed=3):
    """The JAX package's test frames: one scene at a jittered exposure."""
    rng = np.random.default_rng(seed)
    _, gt = synth_pair(0, h, w, seed=seed)
    scene = gt.astype(np.float32) / 255.0
    out = []
    for _ in range(n):
        level = 0.15 + 0.10 * rng.random()
        f = np.clip(scene * level + rng.normal(0, 0.005, scene.shape), 0, 1)
        out.append((f * 255).astype(np.uint8))
    return out


@functools.lru_cache(maxsize=None)
def jax_run(case, n_spatial, h):
    """The JAX package's sharded enhancer over the frames: (weights, the
    enhanced frames)."""
    sve = jpar.SpatialShardedVideoEnhancer(
        jpar.make_mesh(n_data=1, n_spatial=n_spatial), JConfig(**CASES[case]),
        alpha=0.3, force_jnp=True)
    return sve.model_params, [sve.process(f) for f in flicker_frames(h=h)]


def assert_tie_close(a, b, what):
    d = np.abs(a.astype(int) - b.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (what, d.max(),
                                                    (d > 0).mean())


@pytest.mark.parametrize("case,n_spatial,h,ema_in_kernel", [
    ("retinex", 4, 96, True),
    ("retinex", 8, 128, False),
    ("curve ds2", 2, 96, True),
    ("hybrid ds2", 2, 96, True),
])
def test_sharded_video_matches_single_device_and_jax(case, n_spatial, h,
                                                     ema_in_kernel):
    """Four frames through the sharded enhancer: each frame against the
    port's VideoEnhancer and the JAX package's sharded enhancer. retinex
    runs K4's plain version a shard (ema_in_kernel) or the eager gain and
    K1's gain form; curve and hybrid the curve CNN and K3's."""
    jparams, jouts = jax_run(case, n_spatial, h)
    params = None if jparams is None else params_from_numpy(jparams)
    cfg = PipelineConfig(**CASES[case])
    make = dict(alpha=0.3, model_params=params, device="cpu",
                ema_in_kernel=ema_in_kernel)
    sve = tvideo_sharded(cfg, n_spatial, make)
    ve = tvideo.VideoEnhancer(cfg, **make)
    for i, (f, jout) in enumerate(zip(flicker_frames(h=h), jouts)):
        got = sve.process(f)
        assert got.shape == f.shape and got.dtype == np.uint8
        assert_tie_close(got, ve.process(f), ("single", i))
        assert_tie_close(got, jout, ("jax", i))


def test_sharded_video_reset_and_guards():
    sve = tvideo_sharded(PipelineConfig(), 2, dict(alpha=0.3, device="cpu"))
    frames = flicker_frames(n=2)
    o1 = sve.process(frames[0])
    sve.process(frames[1])
    sve.reset()
    # after a reset the EMA re-seeds: the first frame's output again
    np.testing.assert_array_equal(sve.process(frames[0]), o1)
    with pytest.raises(ValueError, match="frame size"):
        sve.process(np.zeros((32, 48, 3), np.uint8))
    with pytest.raises(ValueError, match="H, W, 3"):
        sve.process(np.zeros((96, 64, 4), np.uint8))
    with pytest.raises(TypeError, match="uint8"):
        sve.process(np.zeros((96, 64, 3), np.float32))
    with pytest.raises(ValueError, match="spatial"):
        tpar.SpatialShardedVideoEnhancer(object(), PipelineConfig(),
                                         device="cpu")
    with pytest.raises(ValueError, match="no temporal carry"):
        tvideo_sharded(PipelineConfig(method="fcn"), 2, dict(device="cpu"))
    with pytest.raises(ValueError, match="receptive-field halo"):
        tvideo_sharded(PipelineConfig(**CASES["curve ds2"]), 8,
                       dict(device="cpu")).process(frames[0])


def test_sharded_video_carry_is_per_shard_and_compact():
    """The carry is a stack of per-shard carries, each the shard's halo'd
    block at 1/ds for curve."""
    cfg = PipelineConfig(method="curve", curve_downsample=2)
    sve = tvideo_sharded(cfg, 2, dict(device="cpu"))
    with pytest.raises(RuntimeError, match="first frame"):
        sve.carry_bytes
    sve.process(flicker_frames(n=1)[0])
    n_sp, it, c, hb_ds, wp_ds = sve._carry_shape
    assert n_sp == 2 and (it, c) == (cfg.curve_iters, 3)
    assert sve.carry_bytes == n_sp * it * c * hb_ds * wp_ds * 4
    assert [tuple(s[1].shape) for s in sve._state] == [
        (1, it, c, hb_ds, wp_ds)] * 2
