"""Micro-batching enhancement server.

``EnhanceServer`` accepts single-image requests from any number of threads,
groups them by bucketed shape, runs the pipeline once per group batch and
resolves one Future per request.

  * one dispatcher thread owns the device;
  * shapes are bucketed (``bucket``) and batch sizes too (1, 4, 16, ...,
    ``max_batch``), so a group's batch is one of a few sizes;
  * ``max_batch`` is enforced per shape group; ``max_delay_ms`` bounds the
    wait of a group that does not fill;
  * ``max_queue`` bounds requests in flight, and ``overflow`` says whether
    a full server blocks ``submit`` or raises ``ServerSaturated``;
  * ``close()`` drains every queued request before the dispatcher exits;
  * ``stats()`` counts requests, batches, slots launched and bytes copied
    to the device and back.

While spans record (``utils.profiling``), each request's wait in the queue
is a ``serve.queue`` span and each batch a ``serve.batch`` span around its
steps ``serve.stack``, ``serve.copy_in``, ``serve.run``, ``serve.copy_out``
and ``serve.resolve``; a request's span names its batch's id.

On CUDA the kernel library is built (once, under its lock) before the
dispatcher starts, so no request waits for ``nvcc``.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.parallel.sharding import mesh_for
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline
from low_light_image_enhancement_tpu_torch.utils.profiling import (
    record_span,
    recording,
    stage,
)

ShapeKey = Tuple[int, int]


class ServerSaturated(RuntimeError):
    """Raised by ``submit`` when ``max_queue`` is reached under the
    ``overflow='reject'`` policy."""


class EnhanceServer:
    def __init__(
        self,
        config: PipelineConfig = PipelineConfig(),
        pipeline: Optional[EnhancePipeline] = None,
        max_batch: int = 32,
        max_delay_ms: float = 5.0,
        bucket: int = 64,
        max_queue: Optional[int] = None,
        overflow: str = "block",
        device="cuda",
    ):
        """``pipeline`` (optional) is served as it is; otherwise one is made
        from ``config`` on ``device``. ``max_queue``: bound on in-flight
        requests (queued + batching + dispatched); ``overflow``:
        ``"block"`` (backpressure the producer) or ``"reject"`` (raise
        :class:`ServerSaturated`). ``None`` leaves the queue unbounded."""
        if overflow not in ("block", "reject"):
            raise ValueError(
                f"overflow must be 'block' or 'reject': {overflow!r}"
            )
        self._pipe = pipeline or EnhancePipeline(config, device=device,
                                                 bucket=bucket)
        if self._pipe.bucket is None:
            self._pipe.bucket = bucket
        self._bucket = self._pipe.bucket
        self._max_batch = max_batch
        self._max_delay = max_delay_ms / 1000.0
        # geometric batch buckets: a few batch sizes per shape, under 4x
        # padding compute in the worst case. Under data parallelism
        # (data_shards > 1) every batch must divide over the data mesh, so
        # the buckets start at its size, clamped to the cards there are as
        # the pipeline clamps it (data_shards=4 on 3 cards shards over 3)
        dshards = self._pipe.config.data_shards
        if dshards > 1:
            dshards = mesh_for(self._pipe.device, dshards, 1).shape["data"]
        top = -(-max_batch // dshards) * dshards   # a multiple of it
        self._batch_buckets = []
        b = dshards
        while b < top:
            self._batch_buckets.append(b)
            b *= 4
        self._batch_buckets.append(top)
        if self._pipe.device.type == "cuda":
            _build.load_library()
        self._q: "queue.Queue" = queue.Queue()
        # acquired per submit, released when the request's Future resolves
        self._capacity = (
            threading.BoundedSemaphore(max_queue) if max_queue else None
        )
        self._overflow = overflow
        self._stop = threading.Event()
        # serializes submit-vs-close so no request slips into the queue
        # after close() drained it
        self._submit_lock = threading.Lock()
        # per-shape pending items + arrival time of the oldest pending item
        self._pending: Dict[ShapeKey, List] = {}
        self._since: Dict[ShapeKey, float] = {}
        # counters: requests under _submit_lock, the rest by the dispatcher
        self._requests = self._batches = self._slots = 0
        self._bytes_in = self._bytes_out = 0
        self._thread = threading.Thread(target=self._dispatch, daemon=True)
        self._thread.start()

    # ------------------------------------------------------------- public #

    def submit(self, img_u8: np.ndarray) -> "Future[np.ndarray]":
        """Queue one (H, W, 3) u8 image; returns a Future of the result."""
        img_u8 = np.asarray(img_u8)
        if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
            raise ValueError(f"expected RGB (H,W,3), got {img_u8.shape}")
        if self._capacity is not None:
            # acquire BEFORE _submit_lock so a blocked producer cannot hold
            # the lock against close()
            if not self._capacity.acquire(
                blocking=self._overflow == "block"
            ):
                raise ServerSaturated(
                    "server at max_queue in-flight requests "
                    "(overflow='reject')"
                )
        fut: "Future[np.ndarray]" = Future()
        if self._capacity is not None:
            fut.add_done_callback(lambda _f: self._capacity.release())
        with self._submit_lock:
            if self._stop.is_set():
                if not fut.done():
                    fut.cancel()  # fires the callback -> capacity released
                raise RuntimeError("server closed")
            request = self._requests
            self._requests += 1
            self._q.put((img_u8, fut, request,
                         time.perf_counter() if recording() else None))
        return fut

    def enhance(self, img_u8: np.ndarray) -> np.ndarray:
        """Blocking convenience call."""
        return self.submit(img_u8).result()

    def stats(self) -> Dict[str, int]:
        """Counts since the server started: requests accepted, batches
        launched, slots launched (a batch's requests padded up to its
        batch size), bytes copied to the device and back."""
        return {"requests": self._requests, "batches": self._batches,
                "slots": self._slots, "bytes_in": self._bytes_in,
                "bytes_out": self._bytes_out}

    def close(self, timeout: float = 600.0) -> None:
        """Stop taking requests, serve every queued one, stop the
        dispatcher. Whatever a dead or hung dispatcher left is failed."""
        with self._submit_lock:
            self._stop.set()
        self._thread.join(timeout=timeout)
        err = RuntimeError(
            "server closed with the dispatcher "
            + ("hung" if self._thread.is_alive() else "dead")
        )
        try:
            while True:
                fut = self._q.get_nowait()[1]
                if not fut.done():
                    fut.set_exception(err)
        except queue.Empty:
            pass
        for items in list(self._pending.values()):
            for _, fut, *_ in list(items):
                if not fut.done():
                    try:
                        fut.set_exception(err)
                    except Exception:
                        pass  # lost a race with a late set_result

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---------------------------------------------------------- dispatch #

    def _key(self, img: np.ndarray) -> ShapeKey:
        g = self._bucket
        h, w, _ = img.shape
        return (-(-h // g) * g, -(-w // g) * g)

    def _b_pad(self, n: int) -> int:
        for b in self._batch_buckets:
            if b >= n:
                return b
        return self._max_batch

    def _add(self, item) -> None:
        key = self._key(item[0])
        if not self._pending.get(key):
            self._since[key] = time.monotonic()
        self._pending.setdefault(key, []).append(item)

    def _have_work(self) -> bool:
        return any(self._pending.values()) or not self._q.empty()

    def _dispatch(self) -> None:
        try:
            self._dispatch_loop()
        except BaseException as e:
            # fail every outstanding future so callers unblock
            for items in list(self._pending.values()):
                for _, fut, *_ in list(items):
                    if not fut.done():
                        fut.set_exception(e)
            raise

    def _dispatch_loop(self) -> None:
        while not self._stop.is_set() or self._have_work():
            # pull new arrivals (block briefly only when nothing is pending)
            timeout = 0.002 if any(self._pending.values()) else 0.05
            try:
                self._add(self._q.get(timeout=timeout))
                while True:
                    self._add(self._q.get_nowait())
            except queue.Empty:
                pass
            closing = self._stop.is_set()
            now = time.monotonic()
            for key in list(self._pending):
                items = self._pending[key]
                if not items:
                    continue
                full = len(items) >= self._max_batch
                due = now - self._since[key] >= self._max_delay
                if not (full or due or closing):
                    continue
                n = min(len(items), self._max_batch)
                take, rest = items[:n], items[n:]
                self._pending[key] = rest
                if rest:
                    self._since[key] = now
                self._run_group(key[0], key[1], take)

    def _run_group(self, hb: int, wb: int, items: List) -> None:
        batch_id = self._batches
        self._batches += 1
        b_pad = self._b_pad(len(items))
        self._slots += b_pad
        if recording():
            taken = time.perf_counter()
            for _, _, request, enqueued in items:
                if enqueued is not None:
                    record_span("serve.queue", enqueued, taken,
                                request_id=request, batch_id=batch_id)
        try:
            with stage("serve.batch", batch_id=batch_id,
                       requests=len(items), slots=b_pad) as span:
                with stage("serve.stack"):
                    padded = np.stack([
                        np.pad(img, ((0, hb - img.shape[0]),
                                     (0, wb - img.shape[1]), (0, 0)),
                               mode="edge")
                        for img, *_ in items
                    ])
                    if b_pad > len(items):
                        # replicate the last image up to the batch bucket
                        padded = np.concatenate(
                            [padded,
                             np.repeat(padded[-1:], b_pad - len(items),
                                       axis=0)]
                        )
                with stage("serve.copy_in"):
                    x = torch.from_numpy(padded).to(self._pipe.device)
                self._bytes_in += x.nbytes
                with stage("serve.run"):
                    y = self._pipe.enhance_batch_device(x)
                with stage("serve.copy_out"):
                    out = y.cpu().numpy()
                self._bytes_out += out.nbytes
                span.set(bytes_in=x.nbytes, bytes_out=out.nbytes)
                with stage("serve.resolve"):
                    for (img, fut, *_), res in zip(items, out):
                        h, w, _ = img.shape
                        if not fut.done():
                            fut.set_result(res[:h, :w])
        except BaseException as e:
            for _, fut, *_ in items:
                if not fut.done():
                    fut.set_exception(e)
            if not isinstance(e, Exception):
                raise
