"""Profiling hooks: ``torch.profiler`` traces of the host and the card,
viewable in Perfetto or ``chrome://tracing``, and named spans at the port's
layer boundaries (the JAX package's ``utils/profiling.py``).

A span records only while a ``torch.profiler`` session records in this
process (``profile_trace``, or any other session), in every thread, those
started before the session too. Then each span keeps its name, parent,
start and end on ``time.perf_counter``, thread and a few integer
attributes in a bounded buffer in memory, read back by
``recorded_spans(t0, t1)``, and shows as a range in the session's trace
(torch's C++ ``RecordFunction``, as ``record_function`` enters it without
its Python layers) and, on CUDA, as an NVTX range. Otherwise a span costs
one check of a module flag."""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import math
import os
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import DeviceType

__all__ = ["profile_trace", "stage", "record_span", "recording",
           "recorded_spans", "Span", "DeviceEventsLost"]

# a 10 s window of the busiest benchmark cell holds about 100,000 spans
CAPACITY = 1 << 18


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
    profiler: its ``key_averages()`` sums the time by op and kernel. The
    block's spans are recorded (``recorded_spans``), in place of those of
    earlier sessions.

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
    _RECORDER.clear()
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


def recording() -> bool:
    """Whether spans record: while a ``torch.profiler`` session records in
    this process. torch sets the flag read here for the whole process; its
    per-thread state reads off in a thread started before the session."""
    return _autograd_profiler._is_profiler_enabled


class Span(NamedTuple):
    """A finished span. Times are ``time.perf_counter`` seconds;
    ``device_s`` is the device stream's time between the span's edges,
    idle inside it included (None where the span timed no device)."""

    id: int
    name: str
    parent: Optional[int]    # the id of the span open around it, if any
    start: float
    end: float
    thread: int              # ``threading.get_ident()`` of the recorder
    attrs: Dict[str, int]
    device_s: Optional[float]


class _Recorder:
    """Finished spans, at most ``capacity``: past it the oldest go,
    counted, and a window that a dropped span started in reads as lost.
    Each entry is ``[span, events]``; a span's pair of CUDA events is
    released once a read has turned it into ``device_s``."""

    def __init__(self, capacity: int = CAPACITY):
        self._spans = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.clear()

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self.dropped = 0
            self._dropped_start = -math.inf   # latest start among dropped

    def add(self, span: Span, events) -> None:
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                old = self._spans[0][0]
                self.dropped += 1
                self._dropped_start = max(self._dropped_start, old.start)
            self._spans.append([span, events])

    def spans(self, t0: float, t1: float) -> Optional[List[Span]]:
        with self._lock:
            if self._dropped_start >= t0:
                return None
            picked = [e for e in self._spans if t0 <= e[0].start <= t1]
        for entry in picked:
            s, ev = entry
            if ev is not None:
                ev[1].synchronize()
                entry[0] = s._replace(
                    device_s=ev[0].elapsed_time(ev[1]) * 1e-3)
                entry[1] = None
        return sorted((e[0] for e in picked), key=lambda s: (s.start, s.id))


_RECORDER = _Recorder()
_IDS = itertools.count(1)
_OPEN = threading.local()     # .stack: this thread's open spans
_NVTX: Optional[bool] = None  # CUDA's availability, read at the first span


def recorded_spans(t0: float, t1: float) -> Optional[List[Span]]:
    """The recorded spans that started in [t0, t1] (``perf_counter``
    seconds), by start, with their device times resolved (this waits for
    the device to pass each span's end); None when spans that started in
    the window, or after it, were dropped from the bounded buffer. The
    buffer holds the spans since the last ``profile_trace`` began."""
    return _RECORDER.spans(t0, t1)


def record_span(name: str, start: float, end: float, **attrs: int) -> None:
    """Record a finished span whose edges were read elsewhere, such as a
    request's wait from one thread's enqueue to another's take; it has no
    parent. Callers read ``start`` only where ``recording()``."""
    _RECORDER.add(Span(next(_IDS), name, None, start, end,
                       threading.get_ident(), attrs, None), None)


class _Stage:
    """``stage``'s object while nothing records: it does nothing, and as a
    decorator it opens a ``stage`` of its name at each call."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Stage":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs: int) -> None:
        """Add attributes known only inside the span."""

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with stage(name):
                return fn(*args, **kwargs)

        return wrapped


class _Span(_Stage):
    """``stage``'s object while recording."""

    __slots__ = ("device", "attrs", "id", "parent", "start", "events",
                 "range")

    def __init__(self, name: str, device, attrs: Dict[str, int]):
        self.name, self.device, self.attrs = name, device, attrs

    def __enter__(self) -> "_Span":
        global _NVTX
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1].id if stack else None
        self.id = next(_IDS)
        stack.append(self)
        self.range = _RecordFunctionFast(self.name)
        self.range.__enter__()
        if _NVTX is None:
            _NVTX = torch.cuda.is_available()
        if _NVTX:
            torch.cuda.nvtx.range_push(self.name)
        self.events = None
        if self.device is not None and self.device.type == "cuda":
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        end = time.perf_counter()
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        if _NVTX:
            torch.cuda.nvtx.range_pop()
        self.range.__exit__(*exc)
        _OPEN.stack.pop()
        _RECORDER.add(Span(self.id, self.name, self.parent, self.start, end,
                           threading.get_ident(), self.attrs, None),
                      self.events)
        return False

    def set(self, **attrs: int) -> None:
        self.attrs.update(attrs)


_IDLE: Dict[str, _Stage] = {}   # stage's objects while off, one a name


def stage(name: str, device: Optional[torch.device] = None,
          **attrs: int):
    """A named span: a context manager, or a decorator that opens one of
    its name (alone) at each call::

        with stage("pipeline.enhance_batch_device", batch=b, h=h, w=w):
            ...

    ``attrs``: a few integers (batch, height, width, ids, bytes); ``set``
    on the object ``with`` gives adds more inside the span. ``device``: the
    device the span's work runs on; on a CUDA device the span also takes
    the time of that device's current stream between its edges, from a
    pair of timing events (for work of many launches under names that are
    not the port's: the nets).

    It records only while ``recording()`` (see the module's docstring);
    otherwise it reads no clock, enters no profiler or NVTX range, and
    returns the one idle object of its name, whatever the arguments."""
    if not _autograd_profiler._is_profiler_enabled:
        idle = _IDLE.get(name)
        if idle is None:
            idle = _IDLE[name] = _Stage(name)
        return idle
    return _Span(name, device, attrs)
