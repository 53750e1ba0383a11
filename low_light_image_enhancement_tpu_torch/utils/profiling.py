"""Profiling hooks: ``torch.profiler`` traces of the host and the card,
viewable in Perfetto or ``chrome://tracing``, and named stages, so that
each pipeline stage is attributable in the trace's timeline (the JAX
package's ``utils/profiling.py``)."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator

import torch
from torch.autograd import DeviceType

__all__ = ["profile_trace", "stage", "DeviceEventsLost"]


class DeviceEventsLost(RuntimeError):
    """``torch.profiler`` recorded the block's CUDA kernel launches but no
    activity of the card: the trace's device side is empty."""


def launches_without_device_events(events) -> int:
    """The kernel launches among a trace's ``FunctionEvent``s when it
    holds no device event (kernel, copy or fill), else 0."""
    device = sum(1 for e in events if e.device_type == DeviceType.CUDA)
    return 0 if device else sum(1 for e in events
                                if "LaunchKernel" in e.name)


@contextlib.contextmanager
def profile_trace(log_dir) -> Iterator[torch.profiler.profile]:
    """Trace the block's host ops and, where CUDA is available, its CUDA
    kernels and copies, and write the trace into ``log_dir`` as Chrome
    trace JSON (``trace_<pid>_<ns>.json``) when the block ends. Yields the
    profiler: its ``key_averages()`` sums the time by op and kernel.

    Raises ``DeviceEventsLost`` after writing the trace when the block
    launched CUDA kernels and the trace holds no device event: torch's
    profiler (kineto on CUPTI) now and then drops a session's device
    activity in a process that has run an earlier session (PERF.md §7).
    Trace the block again, or in a fresh process."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
    lost = launches_without_device_events(prof.events()) if cuda else 0
    if lost:
        raise DeviceEventsLost(
            f"torch.profiler recorded {lost} CUDA kernel launches of the "
            f"block but no device event ({path}); trace it again, or in a "
            f"fresh process")


@contextlib.contextmanager
def stage(name: str) -> Iterator[None]:
    """A named range for a pipeline stage: a ``record_function`` range in
    ``torch.profiler``'s traces and, on CUDA, an NVTX range. Usable as a
    decorator or a context manager::

        with stage("illumination"):
            l = illumination_map(x)
    """
    nvtx = torch.cuda.is_available()
    with torch.profiler.record_function(name):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()
