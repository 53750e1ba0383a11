#!/usr/bin/env python3
"""Where the host's time goes in ``EnhancePipeline.enhance_stream`` on a
CUDA card: its parts timed alone, then the stream itself.

- pinned buffers: the first ``torch.empty(pin_memory=True)`` of a size and
  a cached one; a host array into a pinned buffer; the host -> device and
  device -> host copies from pinned and from pageable memory;
- the host layout work of the planar and canvas stagings
  (``io.prefetch.to_planar``/``from_planar``, ``stage_canvas``,
  ``crop_canvas``);
- whether a Python thread runs while another waits in
  ``torch.cuda.Event.synchronize`` (the stream's threads share the GIL);
- the ``PrefetchQueue`` alone (frames to the card, one small op each);
- ``enhance_stream`` in each staging with 1 and 2 workers, beside
  ``enhance_batch``'s host rate, default retinex.

Shapes: 600x400 frames in batches of 8 (64 frames) and single 1080p frames
(16). Each rate is the median of 3 runs after a warm-up run, on the host's
clock. Needs a CUDA card; run from the root of a tree:
``python3 tools/probe_stream.py``.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import low_light_image_enhancement_tpu_torch as llt  # noqa: E402
from low_light_image_enhancement_tpu_torch.io.prefetch import (  # noqa: E402
    PrefetchQueue,
    from_planar,
    to_planar,
)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def ms(fn, n=5) -> float:
    """Mean ms of fn over n calls after one, the card synchronised."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e3


def rate(run, frames: int) -> float:
    """Median frames/s of 3 runs of ``run`` after a warm-up run."""
    run()
    times = []
    for _ in range(3):
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return frames / statistics.median(times)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_stream: CUDA is not available", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cuda")
    torch.zeros(1, device=dev)
    rng = np.random.default_rng(0)
    shapes = {"600x400 b8": (8, 400, 600), "1080p b1": (1, 1080, 1920)}
    pipe = llt.EnhancePipeline(device="cuda")
    print(f"card: {card}")
    for name, shape in shapes.items():
        a = rng.integers(0, 256, shape + (3,), dtype=np.uint8)
        t = time.perf_counter()
        pinned = torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
        first = (time.perf_counter() - t) * 1e3
        del pinned
        t = time.perf_counter()
        pinned = torch.empty(a.shape, dtype=torch.uint8, pin_memory=True)
        cached = (time.perf_counter() - t) * 1e3
        host = torch.from_numpy(a)
        d = torch.empty(a.shape, dtype=torch.uint8, device=dev)
        p = to_planar(a)
        c = pipe.stage_canvas(a)
        plan = pipe.canvas_plan(*shape[1:])
        out = np.ascontiguousarray(c[..., :plan.padded_h - 2 * plan.margin,
                                     :])
        parts = {
            "host->pinned": ms(lambda: pinned.copy_(host)),
            "H2D pinned": ms(lambda: d.copy_(pinned, non_blocking=True)),
            "H2D pageable": ms(lambda: d.copy_(host)),
            "D2H pinned": ms(lambda: pinned.copy_(d, non_blocking=True)),
            "D2H pageable": ms(lambda: d.cpu()),
            "to_planar": ms(lambda: to_planar(a)),
            "from_planar": ms(lambda: from_planar(p)),
            "stage_canvas": ms(lambda: pipe.stage_canvas(a, plan)),
            "crop_canvas": ms(lambda: pipe.crop_canvas(out, *shape[1:],
                                                       plan)),
        }
        print(f"{name} on {card}: pinned alloc {first:.2f} ms (cached "
              f"{cached:.2f}); " + "; ".join(f"{k} {v:.3f} ms"
                                             for k, v in parts.items()))

    # a Python thread counting while another waits on an event
    event = torch.cuda.Event()
    torch.cuda._sleep(200_000_000)
    event.record()
    count, stop = [0], [False]

    def spin():
        while not stop[0]:
            count[0] += 1

    th = threading.Thread(target=spin)
    th.start()
    time.sleep(0.05)
    c0, t = count[0], time.perf_counter()
    event.synchronize()
    waited, counted = time.perf_counter() - t, count[0] - c0
    stop[0] = True
    th.join()
    print(f"Event.synchronize waited {waited * 1e3:.1f} ms; a Python thread "
          f"counted {counted} meanwhile")

    for name, (b, h, w) in shapes.items():
        n = 64 if b > 1 else 16
        base = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
        batches = [base ^ np.uint8(i) for i in range(n // b)]
        src = batches if b > 1 else [f[0] for f in batches]
        for workers in (1, 2):
            def queue_only():
                for x in PrefetchQueue(iter(batches), device="cuda",
                                       workers=workers,
                                       transform=np.ascontiguousarray):
                    x.add_(1)

            print(f"{name} on {card}: PrefetchQueue alone, workers "
                  f"{workers}: {rate(queue_only, n):.1f} frames/s")
            for staging in ("hwc", "planar", "canvas"):
                r = rate(lambda: list(pipe.enhance_stream(
                    iter(src), staging=staging, workers=workers)), n)
                print(f"{name} on {card}: enhance_stream {staging}, workers "
                      f"{workers}: {r:.1f} frames/s")
        r = rate(lambda: [pipe.enhance_batch(x) for x in batches], n)
        print(f"{name} on {card}: enhance_batch (pageable copies): "
              f"{r:.1f} frames/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
