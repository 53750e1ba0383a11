"""Closed-loop batches on the device: ``EnhancePipeline.enhance_batch_device``
on device-resident u8 batches drawn in turn from a pool made from the seed,
dispatch running at most ``ahead`` steps ahead of completion (CUDA events).
The window's clock starts at the first dispatch and stops after a device
sync; the images of every step dispatched are counted.

Mix parameters: ``batch``, ``height``, ``width``, ``pool`` (distinct
batches), ``ahead``, ``sample_steps`` (outputs kept for the check,
a reservoir sample drawn from the seed)."""

from __future__ import annotations

import collections
import random
import time

import torch

from portbench import inputs
from portbench.harness import Record


def make_inputs(ctx):
    """The pool: key -> ((batch, h, w, 3) u8 on the device, (h, w))."""
    t = ctx.traffic
    pool = [inputs.low_light(ctx.gen, t["batch"], t["height"], t["width"],
                             ctx.device) for _ in range(t["pool"])]
    return {i: (x, (t["height"], t["width"])) for i, x in enumerate(pool)}


reference_inputs = make_inputs


def run(ctx) -> Record:
    t = ctx.traffic
    pool = make_inputs(ctx)
    ctx.marks["inputs"] = time.perf_counter()
    pipe = ctx.pipeline
    for x, _ in pool.values():       # warm-up: the kernels, cuDNN's plans
        pipe.enhance_batch_device(x)
    ctx.sync()
    rng = random.Random(ctx.seed)
    keep, samples = t["sample_steps"], []
    dispatch, sync = [], []
    pending = collections.deque()
    cuda = ctx.device.type == "cuda"
    n_pool = len(pool)
    clock = time.perf_counter

    ctx.begin_window()
    t0 = clock()
    i = 0
    while True:
        a = clock()
        y = pipe.enhance_batch_device(pool[i % n_pool][0])
        b = clock()
        dispatch.append((a, b))
        j = i if i < keep else rng.randrange(i + 1)
        if j < keep:
            if j == len(samples):
                samples.append((i % n_pool, y))
            else:
                samples[j] = (i % n_pool, y)
        i += 1
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
            pending.append(ev)
            if len(pending) > t["ahead"]:
                s = clock()
                pending.popleft().synchronize()
                sync.append((s, clock()))
        if b - t0 >= ctx.seconds:
            break
    s = clock()
    ctx.sync()
    t1 = clock()
    sync.append((s, t1))
    ctx.end_window()

    n = i * t["batch"]
    return Record(kind="batch", t0=t0, t1=t1, attempted=n, failed=0,
                  images=n, batch=t["batch"], height=t["height"],
                  width=t["width"], inputs=pool, samples=samples,
                  spans={"dispatch": dispatch, "sync": sync},
                  span_order=("dispatch", "sync"), span_rest="generator")
