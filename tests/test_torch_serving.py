"""EnhanceServer on the CPU: batching by shape, equality with
pipeline.enhance, backpressure and close()."""

import threading

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch import (
    EnhancePipeline,
    EnhanceServer,
    PipelineConfig,
    ServerSaturated,
)
from low_light_image_enhancement_tpu_torch.data.synth import synth_pair

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)


def _imgs():
    return ([synth_pair(i, 40, 56)[0] for i in range(4)]
            + [synth_pair(i, 70, 90)[0] for i in range(4)])


@pytest.mark.parametrize("method", ["retinex", "hybrid", "fcn"])
def test_two_threads_two_shapes_equal_pipeline_enhance(method):
    cfg = PipelineConfig(method=method)
    pipe = EnhancePipeline(cfg, device="cpu", bucket=64)
    imgs = _imgs()
    want = [pipe.enhance(img) for img in imgs]
    got = [None] * len(imgs)
    with EnhanceServer(pipeline=pipe, max_batch=4, max_delay_ms=2.0) as srv:
        def client(ids):
            for i in ids:
                got[i] = srv.submit(imgs[i]).result(timeout=120)

        threads = [threading.Thread(target=client, args=(range(k, 8, 2),))
                   for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive()
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_reject_overflow_and_close_resolves_every_future():
    img = synth_pair(0, 24, 32)[0]
    srv = EnhanceServer(PipelineConfig(), device="cpu", max_queue=2,
                        overflow="reject", max_delay_ms=60_000.0)
    futs = [srv.submit(img), srv.submit(img)]
    with pytest.raises(ServerSaturated):
        srv.submit(img)
    assert not any(f.done() for f in futs)  # waiting for max_delay
    srv.close(timeout=120)
    want = EnhancePipeline(device="cpu", bucket=64).enhance(img)
    for f in futs:
        np.testing.assert_array_equal(f.result(timeout=0), want)
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(img)


def test_full_group_dispatches_without_waiting_and_checks_args():
    img = synth_pair(1, 24, 32)[0]
    with EnhanceServer(PipelineConfig(), device="cpu", max_batch=2,
                       max_delay_ms=60_000.0) as srv:
        futs = [srv.submit(img) for _ in range(2)]
        for f in futs:
            assert f.result(timeout=60).shape == img.shape
        with pytest.raises(ValueError):
            srv.submit(img[..., :2])
    with pytest.raises(ValueError):
        EnhanceServer(PipelineConfig(), device="cpu", overflow="drop")
    # data parallelism: the batch buckets start at data_shards (a CPU mesh
    # repeats the CPU device, so it is not clamped) and are its multiples
    with EnhanceServer(PipelineConfig(data_shards=2), device="cpu",
                       max_batch=5, max_delay_ms=1.0) as srv:
        assert srv._batch_buckets == [2, 6]
        assert srv.submit(img).result(timeout=60).shape == img.shape


@pytest.mark.parametrize("kw", [dict(denoise_taps="guided"),
                                dict(method="hybrid", denoise_taps="guided",
                                     compute_dtype="float32")])
def test_guided_server_matches_jax_jnp_path(kw):
    """The guided tails through the server: its answers equal the JAX
    package's jnp pipeline on the same image and weights (max |du8| <= 1,
    changed share < 1e-3). The image is a multiple of the server's bucket:
    a bucket pads it with replicas, which the curve CNN of hybrid sees where
    it would see zeros past the margin."""
    from low_light_image_enhancement_tpu import pipeline as jpipe
    from low_light_image_enhancement_tpu.config import PipelineConfig as JC
    from low_light_image_enhancement_tpu_torch.models.weights import (
        params_from_numpy,
    )

    ref = jpipe.EnhancePipeline(JC(**kw), force_jnp=True)
    params = None if ref.model_params is None else \
        params_from_numpy(ref.model_params)
    img = synth_pair(5, 64, 64)[0]
    pipe = EnhancePipeline(PipelineConfig(**kw), model_params=params,
                           device="cpu", bucket=64)
    with EnhanceServer(pipeline=pipe, max_delay_ms=1.0) as srv:
        got = srv.submit(img).result(timeout=120)
    d = np.abs(got.astype(int) - ref.enhance(img).astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3, (d.max(), (d > 0).mean())
