"""Open-loop single requests to ``EnhanceServer``: u8 host images drawn
from a pool made from the seed, sent on Poisson arrivals at a fixed rate:
below the server's capacity, where its tail is the measure, or above it,
where the rate it completes is. Every seed sends the same set of gaps
between arrivals (the exponential distribution's quantiles, scaled to fill
the window exactly), in an order drawn from the seed. A request's latency runs from when it was due to when
its Future resolved; one that failed or is unresolved at the end of the
drain has none (it misses every limit).

The server gets the pipeline inside a wrapper that counts the batches it
launches and times each device call.

Mix parameters: ``height``, ``width``, ``pool`` (distinct images),
``rate_per_s``, ``max_batch``, ``max_delay_ms``, ``bucket`` (the server's
settings), ``sample_requests`` (answers kept for the check, drawn from the
seed), ``drain_s`` (how long past the window's close the answers are
awaited)."""

from __future__ import annotations

import math
import random
import time

import torch

from portbench import inputs
from portbench.harness import Record


class CountingPipeline:
    """The pipeline as the server sees it: ``enhance_batch_device`` timed
    and its batch counted; everything else passed through."""

    def __init__(self, pipe):
        self._pipe = pipe
        self.bucket = pipe.bucket
        self.launched, self.spans = [], []

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def enhance_batch_device(self, x):
        a = time.perf_counter()
        y = self._pipe.enhance_batch_device(x)
        self.spans.append((a, time.perf_counter()))
        self.launched.append(int(x.shape[0]))
        return y


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def batch_sizes(max_batch: int):
    """The batch sizes the server launches (one card, no data shards):
    1, 4, 16, ... below ``max_batch``, then ``max_batch``."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 4
    return out + [max_batch]


def arrival_offsets(n: int, seconds: float, rng: random.Random):
    """Offsets from the window's start of ``n`` Poisson arrivals filling
    ``seconds``: the exponential's quantiles at (i + 0.5) / n as the gaps,
    scaled to sum to ``seconds``, shuffled, the first request at 0."""
    gaps = [-math.log(1.0 - (i + 0.5) / n) for i in range(n)]
    scale = seconds / sum(gaps)
    rng.shuffle(gaps)
    out, t = [], 0.0
    for g in gaps:
        out.append(t)
        t += g * scale
    return out


def make_inputs(ctx):
    """The pool on the host, and each image edge-padded to the server's
    bucket as the server pads it (the reference's input)."""
    t = ctx.traffic
    h, w = t["height"], t["width"]
    hb, wb = _round_up(h, t["bucket"]), _round_up(w, t["bucket"])
    pool = inputs.low_light(ctx.gen, t["pool"], h, w, ctx.device)
    padded = torch.cat([pool, pool[:, -1:].expand(-1, hb - h, -1, -1)], 1)
    padded = torch.cat([padded, padded[:, :, -1:].expand(-1, -1, wb - w, -1)],
                       2)
    return pool.cpu().numpy(), {i: (padded[i:i + 1], (h, w))
                                for i in range(t["pool"])}


def reference_inputs(ctx):
    return make_inputs(ctx)[1]


def run(ctx) -> Record:
    from low_light_image_enhancement_tpu_torch.serving import EnhanceServer

    t = ctx.traffic
    host, refs = make_inputs(ctx)
    ctx.marks["inputs"] = time.perf_counter()
    pipe = ctx.pipeline
    pipe.bucket = t["bucket"]
    hb, wb = refs[0][0].shape[1:3]
    counting = CountingPipeline(pipe)
    server = EnhanceServer(pipeline=counting, max_batch=t["max_batch"],
                           max_delay_ms=t["max_delay_ms"], bucket=t["bucket"])
    try:
        return _serve(ctx, server, counting, host, refs, hb, wb)
    finally:
        server.close()


def _serve(ctx, server, counting, host, refs, hb, wb) -> Record:
    t = ctx.traffic
    pipe = counting._pipe
    # warm-up: every batch size the server launches, then its own path
    sizes = batch_sizes(t["max_batch"])
    for b in sizes:
        pipe.enhance_batch_device(torch.zeros((b, hb, wb, 3), dtype=torch.uint8,
                                              device=ctx.device))
    for b in sizes:
        for f in [server.submit(host[i % len(host)]) for i in range(b)]:
            f.result()
    ctx.sync()
    counting.launched.clear()
    counting.spans.clear()

    rng = random.Random(ctx.seed)
    n = max(1, round(t["rate_per_s"] * ctx.seconds))
    offsets = arrival_offsets(n, ctx.seconds, rng)
    image = [rng.randrange(len(host)) for _ in range(n)]
    sampled = set(rng.sample(range(n), min(t["sample_requests"], n)))
    # only the sampled requests' Futures are kept, so that an answer that
    # is not checked is freed once it has resolved
    kept = {}
    ok = [False] * n
    done = [None] * n
    sent, submit = [], []
    clock = time.perf_counter

    def resolved(k, f):
        ok[k] = not f.cancelled() and f.exception() is None
        done[k] = clock()

    ctx.begin_window()
    t0 = clock()
    for k in range(n):
        wait = t0 + offsets[k] - clock()
        if wait > 0:
            time.sleep(wait)
        a = clock()
        try:
            f = server.submit(host[image[k]])
        except Exception:       # a refused request: it misses
            continue
        submit.append((a, clock()))
        sent.append(k)
        if k in sampled:
            kept[k] = f
        f.add_done_callback(lambda f, k=k: resolved(k, f))
        del f
    close = t0 + ctx.seconds
    deadline = close + t["drain_s"]
    i = 0
    while i < len(sent) and clock() < deadline:
        if done[sent[i]] is None:
            time.sleep(0.02)
        else:
            i += 1
    ctx.sync()
    t1 = max([d for d in done if d is not None] + [t0])
    ctx.end_window()

    lat = [done[k] - (t0 + offsets[k]) if ok[k] and done[k] is not None
           else None for k in range(n)]
    samples = [(image[k], kept[k].result()) for k in sorted(sampled)
               if ok[k]]
    return Record(kind="serve", t0=t0, t1=t1, attempted=n,
                  failed=sum(1 for v in lat if v is None),
                  images=sum(ok), batch=1, height=t["height"],
                  width=t["width"], inputs=refs, samples=samples,
                  spans={"dispatch": list(counting.spans),
                         "server.submit": submit},
                  span_order=("dispatch", "server.submit"),
                  span_rest="server", latencies=lat,
                  launched=list(counting.launched),
                  due=[t0 + o for o in offsets], close=close,
                  missing=len(sampled) - len(samples))
