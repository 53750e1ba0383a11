"""The port's spans (``utils/profiling.py``): off, a span reads no clock
and enters no range; on, while a ``torch.profiler`` session records, the
pipeline's spans nest in order, a thread started before the session
records, the bounded buffer drops its oldest spans and counts them, and a
span timed on a CPU device has no device time; a read releases a span's
CUDA events, and ``profile_trace`` starts from an empty buffer."""

import threading
import types

import pytest
import torch

from low_light_image_enhancement_tpu_torch import (
    EnhancePipeline,
    PipelineConfig,
)
from low_light_image_enhancement_tpu_torch.utils import profiling, stage

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture
def recorder(monkeypatch):
    """A fresh buffer of 8 spans in place of the process's."""
    rec = profiling._Recorder(capacity=8)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    return rec


def _session_spans(fn):
    """Run ``fn`` inside a profiler session; the spans it recorded."""
    t0 = profiling.time.perf_counter()
    with torch.profiler.profile(activities=CPU):
        assert profiling.recording()
        fn()
    return profiling.recorded_spans(t0, profiling.time.perf_counter())


def test_off_records_nothing_and_enters_no_range(monkeypatch, recorder):
    def boom(*a, **k):
        raise AssertionError("entered while off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(profiling, "_RecordFunctionFast", boom)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", boom)
    monkeypatch.setattr(torch.cuda, "is_available", boom)
    monkeypatch.setattr(profiling, "time",
                        types.SimpleNamespace(perf_counter=boom))
    assert not profiling.recording()
    assert stage("plain") is stage("plain")    # no object a call
    assert stage("a", torch.device("cpu"), batch=2) is stage("a")
    with stage("a", torch.device("cpu"), batch=2) as s:
        s.set(bytes_in=3)
    with stage("plain"):
        pass

    @stage("decorated")
    def f(x):
        return x + 1

    assert f(1) == 2
    pipe = EnhancePipeline(PipelineConfig(method="curve"), device="cpu")
    pipe.enhance_batch_device(torch.zeros((1, 16, 24, 3),
                                          dtype=torch.uint8))
    assert recorder.spans(-1e30, 1e30) == [] and recorder.dropped == 0


@pytest.mark.parametrize("method", ["retinex", "curve"])
def test_pipeline_spans_nest_in_order(method):
    pipe = EnhancePipeline(PipelineConfig(method=method), device="cpu")
    x = torch.zeros((2, 24, 40, 3), dtype=torch.uint8)
    pipe.enhance_batch_device(x)
    spans = _session_spans(lambda: pipe.enhance_batch_device(x))
    top = spans[0]
    assert top.name == "pipeline.enhance_batch_device"
    assert top.parent is None
    assert top.attrs == {"batch": 2, "h": 24, "w": 40}
    kids = [s for s in spans if s.parent == top.id]
    assert [s.name for s in kids] == (
        [] if method == "retinex"
        else ["nets.curve_cnn"])
    assert len(spans) == 1 + len(kids)
    for a, b in zip(kids, kids[1:]):
        assert a.end <= b.start
    for s in kids:
        assert top.start <= s.start <= s.end <= top.end
        assert s.device_s is None       # no CUDA device
    if method == "curve":
        assert kids[0].attrs == {"batch": 2}


def test_a_thread_started_before_the_session_records(tmp_path):
    go, done = threading.Event(), threading.Event()
    ident = []

    def worker():
        go.wait(timeout=60)
        ident.append(threading.get_ident())
        with stage("worker.step", item=7):
            with stage("worker.inner"):
                pass
        done.set()

    t = threading.Thread(target=worker)
    t.start()
    t0 = profiling.time.perf_counter()
    with profiling.profile_trace(str(tmp_path)):
        go.set()
        assert done.wait(timeout=60)
    t.join(timeout=60)
    assert not t.is_alive()
    spans = profiling.recorded_spans(t0, profiling.time.perf_counter())
    step, inner = [s for s in spans if s.name.startswith("worker.")]
    assert step.name == "worker.step" and step.attrs == {"item": 7}
    assert inner.parent == step.id
    assert step.thread == inner.thread == ident[0]


def test_the_bound_drops_the_oldest_and_counts_them(recorder):
    for k in range(11):
        profiling.record_span("s", float(k), k + 0.5, k=k)
    assert recorder.dropped == 3
    kept = profiling.recorded_spans(3.0, 100.0)
    assert [s.attrs["k"] for s in kept] == list(range(3, 11))
    # a window that a dropped span started in is lost
    assert profiling.recorded_spans(2.0, 100.0) is None
    assert profiling.recorded_spans(0.0, 5.0) is None


def test_a_span_timed_on_the_cpu_has_no_device_time(recorder):
    def work():
        with stage("nets.x", torch.device("cpu"), batch=1) as s:
            s.set(bytes_out=12)

    (span,) = _session_spans(work)
    assert span.device_s is None
    assert span.attrs == {"batch": 1, "bytes_out": 12}
    assert span.start <= span.end


def test_a_decorator_made_while_off_records_while_on(recorder):
    @stage("decorated")
    def f(a, b=1):
        return a + b

    assert f(2, b=3) == 5
    spans = _session_spans(lambda: f(1))
    assert [(s.name, s.attrs) for s in spans] == [("decorated", {})]


class _Event:
    """A timing CUDA event's stand-in: ``elapsed_time`` in ms."""

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 2.5


def test_a_read_resolves_device_time_and_releases_the_events(recorder):
    span = profiling.Span(1, "nets.x", None, 1.0, 2.0, 0, {"batch": 1},
                          None)
    recorder.add(span, (_Event(), _Event()))
    (got,) = profiling.recorded_spans(0.0, 3.0)
    assert got.device_s == pytest.approx(2.5e-3)
    assert list(recorder._spans) == [[got, None]]
    assert profiling.recorded_spans(0.0, 3.0) == [got]


def test_profile_trace_starts_from_an_empty_buffer(recorder, tmp_path):
    profiling.record_span("old", 1.0, 2.0)
    with profiling.profile_trace(str(tmp_path)):
        with stage("new"):
            pass
    assert [s.name for s in profiling.recorded_spans(0.0, 1e30)] == ["new"]
