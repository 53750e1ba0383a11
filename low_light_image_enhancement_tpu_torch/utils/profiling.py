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

__all__ = ["profile_trace", "stage"]


@contextlib.contextmanager
def profile_trace(log_dir) -> Iterator[torch.profiler.profile]:
    """Trace the block's host ops and, where CUDA is available, its CUDA
    kernels and copies, and write the trace into ``log_dir`` as Chrome
    trace JSON (``trace_<pid>_<ns>.json``) when the block ends. Yields the
    profiler: its ``key_averages()`` sums the time by op and kernel."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
