"""The port's PrefetchQueue on device="cpu": the ordering, transform,
worker-pool, error-propagation, close and depth cases of the JAX package's
tests/io/test_prefetch.py and test_prefetch_workers.py (their timing
cases excepted), the planar helpers, and the CUDA contract: a queue for a
CUDA device that is not there raises."""

import threading

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch.io.prefetch import (
    PrefetchQueue,
    from_planar,
    to_planar,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)


def test_yields_all_items_in_order_as_tensors():
    src = [np.full((4, 4), i, np.float32) for i in range(10)]
    got = list(PrefetchQueue(src, depth=2, device="cpu"))
    assert all(isinstance(x, torch.Tensor) for x in got)
    assert [float(x[0, 0]) for x in got] == list(range(10))


def test_transform_applied():
    q = PrefetchQueue([1, 2, 3], depth=2, transform=lambda x: x * 10,
                      device_put=False)
    assert list(q) == [10, 20, 30]


@pytest.mark.parametrize("fail_at", [2, 4])
def test_error_propagates_after_the_good_items(fail_at):
    def flaky():
        for i in range(10):
            if i == fail_at:
                raise IOError(f"bad image {i}")
            yield i

    got = []
    with pytest.raises(IOError, match=f"bad image {fail_at}"):
        for x in PrefetchQueue(flaky(), depth=2, device_put=False):
            got.append(x)
    assert got == list(range(fail_at))


def test_close_unblocks_producer():
    def gen():
        for _ in range(1000):
            yield np.zeros((64, 64))

    q = PrefetchQueue(gen(), depth=1, device="cpu")
    next(q)
    q.close()
    assert q._thread.is_alive() is False


def test_depth_workers_and_device_validation():
    with pytest.raises(ValueError):
        PrefetchQueue([1], depth=0)
    with pytest.raises(ValueError):
        PrefetchQueue([1], workers=0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        PrefetchQueue([1], device="meta")


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("the card is there: chip_smoke.py runs the queue on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PrefetchQueue([np.zeros(4)], device="cuda")
    # without device_put the device is not used
    assert list(PrefetchQueue([1], device="cuda", device_put=False)) == [1]


def test_workers_preserve_order():
    def transform(i):
        for _ in range((i * 7) % 3 * 1000):  # uneven work, no clock
            pass
        return np.full((2, 2), i)

    q = PrefetchQueue(range(30), depth=4, transform=transform,
                      device="cpu", workers=4)
    assert [int(x[0, 0]) for x in q] == list(range(30))


def test_workers_actually_parallel():
    barrier = threading.Barrier(3, timeout=30)

    def transform(i):
        if i < 3:
            barrier.wait()  # deadlocks unless >= 3 transforms run at once
        return i

    q = PrefetchQueue(range(8), depth=8, transform=transform,
                      device_put=False, workers=4)
    assert list(q) == list(range(8))


def test_workers_error_propagates():
    def transform(i):
        if i == 5:
            raise ValueError("bad decode")
        return i

    got = []
    with pytest.raises(ValueError, match="bad decode"):
        for x in PrefetchQueue(range(10), depth=2, transform=transform,
                               device_put=False, workers=3):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]


def test_stress_many_items():
    assert list(PrefetchQueue(range(500), depth=4, device_put=False)) == \
        list(range(500))


def test_to_from_planar_roundtrip():
    x = np.random.default_rng(0).integers(0, 256, (2, 5, 7, 3),
                                          dtype=np.uint8)
    p = to_planar(x)
    assert p.shape == (2, 3, 5, 7) and p.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(from_planar(p), x)
