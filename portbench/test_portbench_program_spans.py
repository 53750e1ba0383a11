"""The readers of the program's own spans on synthetic spans and device
operations (``nets_mfu_pct``, ``pipeline_host_ms.batch``,
``serve_queue_wait_p95_ms``, ``serve_fill_pct``,
``device_idle_pct.serve_host``) and of the serve split, their ``None`` where spans were dropped or
the program records none, and one traced CPU run of
``zero_dce.b48_600x400`` at a small size through the harness."""

import collections
import sys
from pathlib import Path

import pytest

from low_light_image_enhancement_tpu_torch.utils import profiling
from portbench import counts, harness, serve_split, spec
from portbench.test_portbench_stats import read, record, run

ROOT = Path(__file__).resolve().parents[1]
NET = {"layers": [["c1", 3, 32], ["c2", 32, 24]]}
CURVE = {"net": NET, "pipeline": {"method": "curve", "curve_downsample": 1}}


@pytest.fixture
def spans(monkeypatch):
    """A fresh buffer of the program's spans; ``add(name, start, end,
    device_s=None, **attrs)`` records one."""
    rec = profiling._Recorder(capacity=64)
    monkeypatch.setattr(profiling, "_RECORDER", rec)
    ids = iter(range(1, 1000))

    def add(name, start, end, device_s=None, **attrs):
        rec.add(profiling.Span(next(ids), name, None, start, end, 1, attrs,
                               device_s), None)

    return add


def traced(rec, ops=(), config=None):
    return run(rec, list(ops), config)


def test_nets_mfu_is_the_nets_flops_over_their_device_time(spans):
    rec = record(height=40, width=60)
    cfg = CURVE
    spans("nets.curve_cnn", 10.1, 10.2, device_s=0.05, batch=48)
    spans("nets.curve_cnn", 10.3, 10.4, device_s=0.03, batch=16)
    spans("nets.curve_cnn", 12.5, 12.6, device_s=9.0, batch=48)  # after
    spans("pipeline.enhance_batch_device", 10.0, 10.5, batch=48)
    flops = 2 * 9 * 40 * 60 * (3 * 32 + 32 * 24)
    assert counts.net_flops_per_image(NET["layers"], 40, 60) == flops
    want = 100 * flops * 64 / 0.08 / counts.PEAK_BF16_TENSOR_FLOPS
    assert read("nets_mfu_pct", traced(rec, config=cfg)) \
        == pytest.approx(want)
    # the curve net on an image scaled down 2x: a quarter of the work
    down = {"net": NET, "pipeline": {"method": "curve",
                                     "curve_downsample": 2}}
    assert read("nets_mfu_pct", traced(rec, config=down)) \
        == pytest.approx(want / 4)
    # a span that timed no device: no reading
    spans("nets.fcn", 11.0, 11.1, batch=1)
    assert read("nets_mfu_pct", traced(rec, config=cfg)) is None


def test_pipeline_host_ms_is_the_mean_span(spans):
    spans("pipeline.enhance_batch_device", 10.0, 10.002, batch=48)
    spans("pipeline.enhance_batch_device", 11.0, 11.004, batch=48)
    spans("nets.curve_cnn", 11.0, 11.001, batch=48)
    spans("pipeline.enhance_batch_device", 9.0, 9.5, batch=48)  # before
    assert read("pipeline_host_ms.batch", traced(record())) \
        == pytest.approx(3.0)


def test_queue_wait_p95_by_nearest_rank(spans):
    for k in range(20):
        spans("serve.queue", 10.0 + 0.01 * k, 10.0 + 0.01 * k + 0.001 * k,
              request_id=k, batch_id=k // 4)
    # the 19th smallest of waits 0, 1, ..., 19 ms
    assert read("serve_queue_wait_p95_ms", traced(record(kind="serve"))) \
        == pytest.approx(18.0)


def test_fill_is_requests_over_slots(spans):
    spans("serve.batch", 10.0, 10.1, batch_id=0, requests=3, slots=4)
    spans("serve.batch", 10.2, 10.3, batch_id=1, requests=16, slots=16)
    spans("serve.batch", 10.4, 10.5, batch_id=2, requests=1, slots=4)
    assert read("serve_fill_pct", traced(record(kind="serve"))) \
        == pytest.approx(100 * 20 / 24)


def test_idle_goes_to_the_dispatchers_host_steps(spans):
    """Window 10-12 s; the device runs 10.0-10.5 and 11.0-11.5. Idle
    10.5-11.0 and 11.5-12.0; the host steps cover 10.4-10.7 (0.2 idle),
    10.9-11.2 (0.1) and 11.8-12.5 (0.2 inside the window); serve.run and
    serve.copy_out do not count."""
    rec = record(kind="serve")
    ops = [(10.0, 10.5, "k"), (11.0, 11.5, "k")]
    spans("serve.stack", 10.4, 10.6)
    spans("serve.copy_in", 10.6, 10.7)
    spans("serve.resolve", 10.9, 11.2)
    spans("serve.resolve", 11.8, 12.5)
    spans("serve.run", 11.5, 11.8)
    spans("serve.copy_out", 10.7, 10.9)
    assert read("device_idle_pct.serve_host", traced(rec, ops)) \
        == pytest.approx(100 * 0.5 / 2.0)
    assert read("device_idle_pct.serve_host", traced(rec)) is None


def test_the_serve_split_shares_the_dispatchers_batch_time(spans):
    spans("serve.batch", 10.0, 10.1, batch_id=0, requests=4, slots=4)
    spans("serve.stack", 10.0, 10.03)
    spans("serve.copy_in", 10.03, 10.04)
    spans("serve.run", 10.04, 10.05)
    spans("serve.copy_out", 10.05, 10.099)
    spans("serve.batch", 10.2, 10.3, batch_id=1, requests=4, slots=4)
    spans("serve.stack", 10.2, 10.21)
    spans("serve.queue", 9.0, 10.2, request_id=3, batch_id=1)
    spans("serve.batch", 12.5, 12.9, batch_id=2, requests=4, slots=4)
    got = serve_split.read(traced(record(kind="serve")))
    assert set(got) == {"serve.stack", "serve.copy_in", "serve.run",
                        "serve.copy_out"}
    assert got["serve.stack"]["n"] == 2
    assert got["serve.stack"]["ms_each"] == pytest.approx(20.0)
    assert got["serve.stack"]["pct_of_batches"] == pytest.approx(20.0)
    assert got["serve.copy_out"]["pct_of_batches"] == pytest.approx(24.5)
    assert serve_split.read(run(record(kind="serve"), None)) is None


def test_no_reading_where_spans_were_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "_RECORDER", profiling._Recorder(2))
    for k in range(3):
        profiling.record_span("pipeline.enhance_batch_device", 10.0 + k,
                              10.5 + k, batch=1)
    assert read("pipeline_host_ms.batch", traced(record())) is None
    assert read("pipeline_host_ms.batch",
                traced(record(t0=11.0, t1=13.0))) == pytest.approx(500.0)


@pytest.mark.parametrize("name", ["nets_mfu_pct", "pipeline_host_ms.batch",
                                  "serve_queue_wait_p95_ms",
                                  "serve_fill_pct",
                                  "device_idle_pct.serve_host"])
def test_no_reading_from_a_program_without_spans(monkeypatch, spans, name):
    """A version of the program without the recorder, and an untraced
    run, read None and raise nothing."""
    spans("nets.curve_cnn", 10.1, 10.2, device_s=0.05, batch=48)
    spans("pipeline.enhance_batch_device", 10.1, 10.2, batch=48)
    assert read(name, run(record(), None, {"net": NET})) is None
    monkeypatch.setitem(
        sys.modules, "low_light_image_enhancement_tpu_torch.utils.profiling",
        None)
    assert read(name, traced(record(), [(10.0, 10.1, "k")],
                             {"net": NET})) is None


def test_a_traced_cpu_run_records_the_programs_spans():
    c = spec.cell(ROOT, "zero_dce.b48_600x400")
    c.traffic.update(batch=2, height=48, width=72, pool=2, sample_steps=2)
    r, _, _ = harness.execute(c, 2**31 + 61, 0.3, True, device="cpu")
    got = profiling.recorded_spans(r.record.t0, r.record.t1)
    names = collections.Counter(s.name for s in got)
    calls = len(r.record.spans["dispatch"])
    assert calls > 0
    for n in ("pipeline.enhance_batch_device", "nets.curve_cnn"):
        assert names[n] == calls, names
    host = read("pipeline_host_ms.batch", r)
    assert 0 < host <= read("dispatch_ms.batch", r)
    # no device: the readers of device time read nothing
    assert read("nets_mfu_pct", r) is None
    assert read("device_idle_pct.serve_host", r) is None


def test_a_traced_cpu_run_of_the_serving_mix_records_the_dispatcher():
    """The server's dispatcher thread starts before the window's profiler
    session, and its spans are recorded all the same."""
    c = spec.kept_cell(ROOT, "zero_dce", "serve_over_600x400")
    c.traffic.update(height=48, width=72, pool=4, rate_per_s=30,
                     sample_requests=1000, drain_s=30)
    r, _, _ = harness.execute(c, 2**31 + 62, 0.5, True, device="cpu")
    got = profiling.recorded_spans(r.record.t0, r.record.t1)
    queue = [s for s in got if s.name == "serve.queue"]
    batches = [s for s in got if s.name == "serve.batch"]
    assert len(queue) == r.record.images > 0
    assert sum(s.attrs["requests"] for s in batches) == len(queue)
    assert sum(s.attrs["slots"] for s in batches) == sum(r.record.launched)
    assert read("serve_queue_wait_p95_ms", r) > 0
    assert 0 < read("serve_fill_pct", r) <= 100
    split = serve_split.read(r)
    assert split["serve.run"]["n"] == len(batches)
    assert 0 < sum(v["pct_of_batches"] for v in split.values()) <= 100
    assert read("device_idle_pct.serve_host", r) is None
