"""The port's meshes, halo exchange, spatially sharded enhance and sharded
pipeline dispatch on the CPU, against the JAX package's ``parallel`` on its
eight fake CPU devices (tests/conftest.py) and the port's own single-device
pipeline, on the same numpy inputs.

The port's mesh repeats the CPU device (``[cpu] * n``), its counterpart of
the fake devices; the kernels run their plain versions.

Bars: retinex u8 Δ 0 against the port's single-device pipeline, and the
JAX package's sharded u8 path (its Pallas kernel in interpret mode) parts
from it only where the two single-device paths part; f32
retinex within 1e-6 of the JAX package's sharded f32 path; the learned
methods (f32 nets) max |du8| <= 1 on < 1e-3 of the pixels, the JAX
package's own bar between its sharded and single-device outputs
(tests/parallel/test_sharding.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import parallel as jpar
from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu_torch import parallel as tpar
from low_light_image_enhancement_tpu_torch import pipeline as tpipe
from low_light_image_enhancement_tpu_torch.config import (
    PRESETS,
    PipelineConfig,
)
from low_light_image_enhancement_tpu_torch.core import illumination_boost
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_boost():
    """A process's first illumination boost on the CPU, run on several
    threads, may round some values apart from the next ones (found: 11%
    of a block's values in 2 of 8 fresh processes, a u8 tie flipped; never
    on one thread): one runs before the comparisons."""
    illumination_boost(torch.rand(1, 3, 16, 16), PipelineConfig())


def cpu_mesh(n_data, n_spatial):
    return tpar.make_mesh(n_data, n_spatial, [CPU] * (n_data * n_spatial))


def planar(lows):
    return np.ascontiguousarray(np.transpose(lows, (0, 3, 1, 2)))


def jax_sharded(x, cfg, mesh, model_params=None, **kw):
    """The JAX package's enhance_spatial_sharded under one jit, as its
    pipeline runs it (eager shard_map dispatches op by op, ~20x slower)."""
    fn = jax.jit(lambda v, p: jpar.enhance_spatial_sharded(
        v, cfg, mesh, model_params=p, **kw))
    return np.asarray(fn(jnp.asarray(x), model_params))


def delta(got, want):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    return d.max(), (d > 0).mean()


def test_make_mesh_shapes_and_errors():
    mesh = tpar.make_mesh(n_spatial=4, devices=[CPU] * 8)
    assert mesh.shape == {"data": 2, "spatial": 4}
    assert mesh.axis_names == ("data", "spatial")
    assert mesh.flat == [CPU] * 8 and mesh.distinct() == [CPU]
    assert tpar.make_mesh(n_data=8, devices=[CPU] * 8).shape == {
        "data": 8, "spatial": 1}
    with pytest.raises(ValueError, match="need 16 devices"):
        tpar.make_mesh(n_data=16, n_spatial=1, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.make_mesh(n_spatial=3, devices=[CPU] * 8)
    with pytest.raises(ValueError, match="one type"):
        tpar.Mesh([["cpu", "meta"]])


@pytest.mark.parametrize("n", [1, 2, 8])
def test_halo_pad_matches_edge_pad(n):
    """Each shard's halo'd block is the edge-padded image's rows around
    it; a shard of several holding fewer rows than the halo raises."""
    m = 3
    x = torch.from_numpy(np.random.default_rng(0).random((2, 64, 16),
                                                         np.float32))
    hl = 64 // n
    got = tpar.halo_pad(list(x.split(hl, dim=-2)), m)
    want = np.pad(x.numpy(), ((0, 0), (m, m), (0, 0)), mode="edge")
    for s, block in enumerate(got):
        assert block.is_contiguous()
        np.testing.assert_array_equal(block.numpy(),
                                      want[:, s * hl:s * hl + hl + 2 * m])
    with pytest.raises(ValueError, match="halo"):
        tpar.halo_pad(list(x.split(2, dim=-2)), m)


@functools.lru_cache(maxsize=1)
def _u8_case():
    """The u8 retinex case's input and the JAX package's single-device
    output (its Pallas K1 in interpret mode), planar."""
    lows, _ = synth_batch(2, 64, 100)
    ref = jpipe.EnhancePipeline(JConfig(), pallas_interpret=True)
    return lows, planar(ref.enhance_batch(lows))


@pytest.mark.parametrize("n_spatial", [2, 4, 8])
def test_spatial_sharded_u8_retinex_matches_pipeline_and_jax(n_spatial):
    """u8 retinex through K1's canvas form a shard: Δ 0 against the port's
    single-device enhance_batch_device. On 8 shards also against the JAX
    package's sharded u8 path (its Pallas kernel in interpret mode): the
    main path's bar, and exactly the values where the two single-device
    paths part (found: one u8 tie in 38,400, the same with and without
    sharding on both sides), so sharding adds no difference on either
    side."""
    cfg = PipelineConfig()
    lows, jsingle = _u8_case()
    x = planar(lows)
    got = tpar.enhance_spatial_sharded(torch.from_numpy(x), cfg,
                                       cpu_mesh(1, n_spatial)).numpy()
    pipe = tpipe.EnhancePipeline(cfg, device="cpu")
    single = planar(pipe.enhance_batch_device(torch.from_numpy(lows)).numpy())
    np.testing.assert_array_equal(got, single)
    if n_spatial != 8:
        return
    jmesh = jpar.make_mesh(n_data=1, n_spatial=n_spatial)
    ref = jax_sharded(x, JConfig(), jmesh, use_pallas=True, interpret=True)
    dmax, share = delta(got, ref)
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    np.testing.assert_array_equal(got != ref, single != jsingle)


@pytest.mark.parametrize("shape", [(1, 4), (2, 4)])
def test_spatial_sharded_f32_retinex_matches_jax(shape):
    """f32 retinex (K1's canvas form a shard, f32 in and out), rows over
    spatial and the batch over data, within 1e-6 of the JAX package's
    sharded f32 path on the same mesh shape."""
    x = np.random.default_rng(1).random((2, 3, 48, 64), np.float32)
    got = tpar.enhance_spatial_sharded(torch.from_numpy(x), PipelineConfig(),
                                       cpu_mesh(*shape)).numpy()
    ref = jax_sharded(x, JConfig(), jpar.make_mesh(*shape))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("kw,n_spatial,h,w", [
    (dict(method="curve"), 4, 64, 96),
    (dict(method="hybrid"), 2, 64, 96),
    (dict(method="decom"), 4, 64, 96),
    (dict(method="fcn"), 2, 160, 96),   # radius 64: a 72-row halo
    (dict(method="curve", curve_downsample=2), 2, 96, 80),
])
def test_learned_spatial_sharded_matches_pipeline_and_jax(kw, n_spatial, h,
                                                          w):
    """The learned methods a shard through enhance_learned_block with the
    receptive field as the halo, at the JAX package's shapes, f32 nets:
    against the port's single-device pipeline and the JAX package's
    sharded output on the same weights."""
    jcfg = JConfig(compute_dtype="float32", **kw)
    jpipe_ref = jpipe.EnhancePipeline(jcfg, force_jnp=True)
    params = params_from_numpy(jpipe_ref.model_params)
    cfg = PipelineConfig(compute_dtype="float32", **kw)
    lows, _ = synth_batch(2 if "curve_downsample" not in kw else 1, h, w)
    x = planar(lows)
    got = tpar.enhance_spatial_sharded(torch.from_numpy(x), cfg,
                                       cpu_mesh(1, n_spatial), params)
    single = tpipe.EnhancePipeline(cfg, model_params=params,
                                   device="cpu").enhance_batch(lows)
    dmax, share = delta(got.numpy(), planar(single))
    assert dmax <= 1 and share < 1e-3, ("single", dmax, share)
    ref = jax_sharded(x, jcfg, jpar.make_mesh(n_data=1, n_spatial=n_spatial),
                      jpipe_ref.model_params)
    dmax, share = delta(got.numpy(), ref)
    assert dmax <= 1 and share < 1e-3, ("jax", dmax, share)


def test_learned_sharded_rejects_too_many_shards():
    """A shard must own at least the receptive-field halo's rows: fcn on 8
    shards of a 64-row image raises, naming it."""
    cfg = PipelineConfig(method="fcn", compute_dtype="float32")
    params = tpipe.EnhancePipeline(cfg, device="cpu").model_params
    x = torch.zeros((1, 3, 64, 64))
    with pytest.raises(ValueError, match="receptive-field halo"):
        tpar.enhance_spatial_sharded(x, cfg, cpu_mesh(1, 8), params)
    with pytest.raises(ValueError, match="model_params"):
        tpar.enhance_spatial_sharded(x, cfg, cpu_mesh(1, 2))
    with pytest.raises(ValueError, match="data axis"):
        tpar.enhance_spatial_sharded(torch.zeros((3, 3, 64, 64)),
                                     PipelineConfig(), cpu_mesh(2, 1))


def test_shard_batch_fn_matches_and_places_rest():
    mesh = cpu_mesh(4, 2)
    f = lambda x, p: torch.sin(x) * p["k"]
    x = torch.arange(16.0).reshape(16, 1)
    got = tpar.shard_batch_fn(f, mesh)(x, {"k": torch.tensor(2.0)})
    torch.testing.assert_close(got, torch.sin(x) * 2.0, rtol=0, atol=0)
    with pytest.raises(ValueError, match="not divisible"):
        tpar.shard_batch_fn(f, mesh)(x[:6], {"k": torch.tensor(2.0)})


def test_pipeline_data_shards_pads_and_equals_unsharded():
    """data_shards=3 splits the batch over a mesh of 3; enhance_batch pads
    a batch of 4 with the last image up to 6 and crops; the device entry
    point raises on a batch that does not divide, as the JAX package's."""
    imgs, _ = synth_batch(4, 40, 64, seed=2)
    base = tpipe.EnhancePipeline(PipelineConfig(), device="cpu")
    dp = tpipe.EnhancePipeline(PipelineConfig(data_shards=3), device="cpu")
    want = base.enhance_batch(imgs)
    np.testing.assert_array_equal(dp.enhance_batch(imgs), want)
    np.testing.assert_array_equal(
        dp.enhance_batch_device(torch.from_numpy(imgs[:3])).numpy(),
        want[:3])
    planar_out = dp.enhance_batch_device_planar(
        torch.from_numpy(planar(imgs[:3])))
    np.testing.assert_array_equal(planar_out.numpy(), planar(want[:3]))
    with pytest.raises(ValueError, match="not divisible"):
        dp.enhance_batch_device(torch.from_numpy(imgs))


def test_pipeline_spatial_shards_config5_and_rules():
    """PRESETS["config5_4k_sharded"] (8 spatial shards) runs on a CPU mesh
    of 8 and equals the unsharded pipeline; the planar entry point raises
    under spatial_shards, and a config asking for both shardings raises,
    as in the JAX package."""
    cfg5 = PRESETS["config5_4k_sharded"]
    assert cfg5.spatial_shards == 8
    imgs, _ = synth_batch(1, 72, 96, seed=5)
    got = tpipe.EnhancePipeline(cfg5, device="cpu")
    got.warmup([(1, 72, 96)])
    want = tpipe.EnhancePipeline(cfg5.replace(spatial_shards=1),
                                 device="cpu").enhance_batch(imgs)
    np.testing.assert_array_equal(got.enhance_batch(imgs), want)
    with pytest.raises(NotImplementedError, match="planar"):
        got.enhance_batch_device_planar(torch.from_numpy(planar(imgs)))
    with pytest.raises(ValueError, match="combined"):
        PipelineConfig(spatial_shards=2, data_shards=2)
    with pytest.raises(ValueError):
        JConfig(spatial_shards=2, data_shards=2)


def test_cli_reaches_the_sharded_dispatch(tmp_path, capsys):
    """llie-torch enhance --data-shards 2, and --preset config5_4k_sharded
    (8 spatial shards), on the CPU: the file equals the unsharded
    pipeline's output."""
    from low_light_image_enhancement_tpu_torch import cli
    from low_light_image_enhancement_tpu_torch.io.codec import (
        decode_image,
        encode_image,
    )

    low = synth_batch(1, 72, 64, seed=4)[0][0]
    src = tmp_path / "dark.png"
    encode_image(low, src)
    want = tpipe.EnhancePipeline(device="cpu").enhance(low)
    for i, flags in enumerate((["--data-shards", "2"],
                               ["--preset", "config5_4k_sharded"])):
        dst = tmp_path / f"bright{i}.png"
        assert cli.main(["enhance", str(src), str(dst), "--device",
                         "cpu"] + flags) == 0
        np.testing.assert_array_equal(decode_image(dst), want)
    assert "wrote" in capsys.readouterr().out


def test_jax_has_eight_fake_devices():
    """The JAX references above run on tests/conftest.py's eight fake CPU
    devices."""
    assert len(jax.devices()) == 8
