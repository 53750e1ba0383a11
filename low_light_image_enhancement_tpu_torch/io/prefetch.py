"""Double-buffered host -> device prefetch queue.

A background thread pulls host batches from an iterator, optionally
transforms them (on a pool of ``workers`` threads, in order), and copies
them to the device, so that the copy of batch N + 1 overlaps the device's
work on batch N. The bounded queue (``depth``, 2 = double buffering) bounds
the device memory held by batches in flight.

On a CUDA device each host batch is first copied into a pinned buffer from
a small ring, then copied to the device with ``non_blocking=True`` on the
queue's own stream, which records an event. The consumer's stream waits
for that event before the batch is used, and ``record_stream`` keeps the
caching allocator from handing the batch's memory to the copy stream while
the consumer's work on it may still run. A pinned buffer is filled again
only after its copy's event has completed. On the CPU nothing is pinned:
a batch becomes a tensor over the host array.

The port of the JAX package's ``io/prefetch.py``, with the same ordering,
error and ``close`` semantics.
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

_SENTINEL = object()
# pinned buffers a queue fills in turn: one being filled while the copy out
# of the other may still run
PINNED_RING = 2


def to_planar(imgs):
    """Host-side HWC -> planar u8 ((..., H, W, 3) -> (..., 3, H, W), C
    contiguous). Run in a prefetch worker (``transform=``), so that the
    device skips the transpose."""
    return np.ascontiguousarray(np.moveaxis(np.asarray(imgs), -1, -3))


def from_planar(imgs):
    """Host-side planar -> HWC u8 (inverse of :func:`to_planar`), a new C
    contiguous array. It is written a channel at a time: numpy's copy of
    the moved axes interleaves a byte at a time, about 4x slower at
    1080p."""
    imgs = np.asarray(imgs)
    c = imgs.shape[-3]
    out = np.empty(imgs.shape[:-3] + imgs.shape[-2:] + (c,), imgs.dtype)
    for k in range(c):
        out[..., k] = imgs[..., k, :, :]
    return out


class _Staged:
    """A batch on the card and the event of its copy there."""

    __slots__ = ("tensor", "event")

    def __init__(self, tensor: torch.Tensor, event):
        self.tensor, self.event = tensor, event


class PrefetchQueue:
    """Iterate device-resident batches while the host prepares the next.

    Example::

        for batch in PrefetchQueue(host_batches, depth=2, device="cuda"):
            out = pipeline.enhance_batch_device(batch)
    """

    def __init__(
        self,
        source: Iterable[Any],
        depth: int = 2,
        device="cuda",
        transform: Optional[Callable[[Any], Any]] = None,
        device_put: bool = True,
        workers: int = 1,
    ):
        """``device_put`` copies each (transformed) batch, an array or a
        tuple or list of arrays (yielded as a tuple of tensors), to
        ``device`` (``"cuda"`` or ``"cpu"``; a CUDA device that is not there
        raises); without it the batches are yielded as they are and
        ``device`` is not used. ``workers > 1`` runs ``transform`` (a
        decode, say) on a thread pool while one coordinator keeps the order
        and issues the copies."""
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if workers < 1:
            raise ValueError("workers must be >= 1")
        if device_put:
            # pipeline imports this module: its device rule is taken here
            from low_light_image_enhancement_tpu_torch.pipeline import (
                resolve_device,
            )

            device = resolve_device(device, "PrefetchQueue")
        self._device = device
        self._source = iter(source)
        self._transform = transform
        self._device_put = device_put
        self._workers = workers
        self._cuda = device_put and self._device.type == "cuda"
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            self._ring = [None] * PINNED_RING   # (pinned buffer, its event)
            self._turn = 0
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # --------------------------------------------------- the worker side #

    def _pinned(self, k: int, host: torch.Tensor) -> torch.Tensor:
        """Pinned buffer k of the ring, once its last copy has completed,
        holding ``host``."""
        slot = self._ring[k]
        buf = None
        if slot is not None:
            buf, event = slot
            event.synchronize()
        if buf is None or buf.shape != host.shape or buf.dtype != host.dtype:
            buf = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        buf.copy_(host)
        return buf

    def _stage(self, item: Any) -> Any:
        """A batch on its way to the device: an array, or a tuple or list
        of arrays (a ``(low, high)`` pair) staged element by element, each
        through the pinned ring with its own event, as the JAX package's queue
        stages a pytree."""
        if not self._device_put:
            return item
        if isinstance(item, (tuple, list)):
            return tuple(self._stage_one(x) for x in item)
        return self._stage_one(item)

    def _stage_one(self, item: Any) -> Any:
        host = item if isinstance(item, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(item))
        if not self._cuda:
            return host.to(self._device)
        k = self._turn
        self._turn = (k + 1) % PINNED_RING
        buf = self._pinned(k, host)
        with torch.cuda.stream(self._stream):
            dev = buf.to(self._device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._ring[k] = (buf, event)
        return _Staged(dev, event)

    def _put(self, item: Any) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self) -> None:
        if self._workers == 1 or self._transform is None:
            for item in self._source:
                if self._stop.is_set():
                    return
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(self._stage(item)):
                    return
            return
        with ThreadPoolExecutor(self._workers) as pool:
            pending: "collections.deque" = collections.deque()
            exhausted = False
            while not self._stop.is_set():
                while not exhausted and len(pending) < 2 * self._workers:
                    try:
                        raw = next(self._source)
                    except StopIteration:
                        exhausted = True
                        break
                    pending.append(pool.submit(self._transform, raw))
                if not pending:
                    break
                item = pending.popleft().result()
                if not self._put(self._stage(item)):
                    for fut in pending:
                        fut.cancel()
                    return

    def _worker(self) -> None:
        try:
            if self._cuda:
                with torch.cuda.device(self._device):
                    self._produce()
            else:
                self._produce()
        except BaseException as e:  # handed to the consumer
            self._err = e
        finally:
            while not self._stop.is_set():
                try:
                    self._q.put(_SENTINEL, timeout=0.1)
                    break
                except queue.Full:
                    continue

    # ------------------------------------------------- the consumer side #

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        while True:
            if self._err is not None and self._q.empty():
                err, self._err = self._err, None
                raise err
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if item is _SENTINEL:
                if self._err is not None:
                    err, self._err = self._err, None
                    raise err
                raise StopIteration
            if isinstance(item, tuple):
                return tuple(self._unstage(x) for x in item)
            return self._unstage(item)

    def _unstage(self, item: Any) -> Any:
        """The consumer's stream waits for a staged tensor's copy."""
        if not isinstance(item, _Staged):
            return item
        consumer = torch.cuda.current_stream(self._device)
        consumer.wait_event(item.event)
        item.tensor.record_stream(consumer)
        return item.tensor

    def close(self) -> None:
        """Stop the worker and drop queued batches."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
