"""The harness's arithmetic on synthetic records: the rate over the whole
window, tails over every request with failures as misses, the idle share
and idle gaps of a timeline, the roofline and MFU shares."""

import types
from pathlib import Path

import pytest

from portbench import counts, harness, spec, stats

ROOT = Path(__file__).resolve().parents[1]


def record(kind="batch", **kw):
    base = dict(kind=kind, t0=10.0, t1=12.0, attempted=480, failed=0,
                images=480, batch=48, height=400, width=600, inputs={},
                samples=[], spans={}, span_order=("dispatch", "sync"),
                span_rest="generator")
    base.update(kw)
    return harness.Record(**base)


def run(rec, ops=None, config=None, traffic=None):
    trace = None if ops is None else types.SimpleNamespace(device_ops=ops)
    return harness.Run(rec, config or {"pipeline": {"method": "curve"}},
                       traffic or {"drain_s": 60}, 1.5, trace)


def read(name, r):
    return spec.reader(ROOT, name)(r)


def test_rate_is_all_images_over_the_window():
    assert read("images_per_s", run(record())) == pytest.approx(240.0)


def test_served_rate_counts_answers_inside_the_window():
    """Answers that resolve after the window's close do not count; the
    rate is over the window's whole length, the first request due to the
    close."""
    due = [10.0 + 0.01 * i for i in range(300)]
    lat = [0.5] * 100 + [None] * 10 + [2.0] * 190
    # done at due + lat: the first 100 by 11.49; the last 190 after 13.1
    r = run(record(kind="serve", due=due, latencies=lat, close=12.0))
    assert read("served_images_per_s", r) == pytest.approx(100 / 2.0)


def test_p95_over_all_requests_failures_miss():
    lat = [0.010] * 95 + [None] * 5
    r = run(record(kind="serve", latencies=lat))
    assert read("serve_latency_p95_ms", r) == pytest.approx(10.0)
    lat = [0.010] * 94 + [None] * 6
    r = run(record(kind="serve", latencies=lat))
    # a miss counts as the window plus the drain: past any limit
    assert read("serve_latency_p95_ms", r) == pytest.approx(
        1e3 * (2.0 + 60))
    assert read("serve_latency_p50_ms", r) == pytest.approx(10.0)


def test_nearest_rank():
    assert stats.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert stats.nearest_rank([3.0], 0.5) == 3.0


def test_idle_share_of_a_timeline():
    ops = [(10.0, 10.5, "k"), (10.25, 11.0, "k"), (11.5, 11.75, "m"),
           (9.0, 10.1, "before"), (11.9, 13.0, "after")]
    r = run(record(), ops)
    # busy: [10, 11] + [11.5, 11.75] + [11.9, 12] = 1.35 of 2 s
    assert r.busy_s() == pytest.approx(1.35)
    assert read("device_idle_pct.batch", r) == pytest.approx(32.5)
    assert read("device_idle_pct.serve", r) == pytest.approx(32.5)
    r = run(record(), None)
    assert read("device_idle_pct.batch", r) is None


def test_idle_gaps_named_by_the_open_span():
    ops = [(10.0, 11.0, "k"), (11.5, 12.0, "k")]
    rec = record(spans={"dispatch": [(11.0, 11.2)], "sync": [(11.2, 11.4)]})
    b = harness.breakdown(run(rec, ops))
    assert b["device_ops"] == [["k", pytest.approx(1.5)]]
    # the one gap [11.0, 11.5]: its midpoint 11.25 lies in a sync span
    assert b["idle_gaps"] == [["sync", pytest.approx(0.5)]]
    g = stats.name_gaps([(0.0, 1.0), (2.0, 4.0)], {"dispatch": [(0, 1)]},
                        ("dispatch", "sync"), "generator")
    assert g == {"dispatch": 1.0, "generator": 2.0}


def test_roofline_and_mfu():
    p = {"method": "retinex", "blur_radius": 2, "denoise_strength": 1.0,
         "denoise_taps": "sep", "denoise_kernel": "exp",
         "denoise_guide": "luma"}
    # 10 batches, the card busy 2 ms a batch
    ops = [(10.0 + i * 0.002, 10.0 + (i + 1) * 0.002, "k1")
           for i in range(10)]
    r = run(record(images=480), ops, {"pipeline": p})
    least = counts.retinex_least_s(p, 48, 400, 600)
    assert read("retinex_roofline", r) == pytest.approx(100 * least / 0.002)
    assert read("retinex_roofline", run(record(images=480), [],
                                        {"pipeline": p})) is None
    net = {"layers": [["c1", 3, 32]]}
    r = run(record(images=480), ops, {"pipeline": {"method": "curve"},
                                      "net": net})
    want = (100 * counts.net_flops_per_image(net["layers"], 400, 600) * 480
            / 2.0 / 989e12)
    assert read("mfu_pct", r) == pytest.approx(want)


def test_dispatch_and_batch_means():
    rec = record(spans={"dispatch": [(0.0, 0.001), (1.0, 1.003)]})
    assert read("dispatch_ms.batch", run(rec)) == pytest.approx(2.0)
    rec = record(kind="serve", launched=[32, 16, 4])
    assert read("serve_batch_mean", run(rec)) == pytest.approx(52 / 3)
    assert read("serve_batch_mean", run(record(kind="serve"))) is None


def test_open_loop_latency_counts_from_the_due_time(monkeypatch):
    """The generator oversleeps once by 1 s: every request due meanwhile is
    sent late, and its latency counts the wait from when it was due."""
    import time as real_time

    from portbench.loops import serve_open

    woke = []

    class Clock:
        perf_counter = staticmethod(real_time.perf_counter)

        @staticmethod
        def sleep(s):
            real_time.sleep(s + (0.0 if woke else 1.0))
            if not woke:
                woke.append(real_time.perf_counter())

    monkeypatch.setattr(serve_open, "time", Clock)
    c = spec.kept_cell(ROOT, "zero_dce", "serve_over_600x400")
    c.traffic.update(height=24, width=40, pool=2, rate_per_s=20,
                     sample_requests=4, drain_s=30)
    r, _, _ = harness.execute(c, 9, 0.6, False, device="cpu")
    late = [(d, lat) for d, lat in zip(r.record.due, r.record.latencies)
            if d < woke[0]]
    assert len(late) >= 3
    for d, lat in late[1:]:
        assert lat >= woke[0] - d


def test_a_trace_that_lost_device_events_is_refused():
    rec = record(spans={"dispatch": [(10.0, 10.1), (10.5, 10.6),
                                     (11.0, 11.1)]})
    ops = [(10.2, 10.4, "k"), (10.7, 10.9, "k"), (11.2, 11.4, "k")]
    harness.check_trace(run(rec, ops))
    with pytest.raises(RuntimeError, match="lost"):
        harness.check_trace(run(rec, ops[:2]))
