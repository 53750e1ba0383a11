"""The median of the latencies that ``serve_latency_p95_ms`` reads, misses
included."""

from portbench import stats


def read(run):
    r = run.record
    miss = r.t1 - r.t0 + run.traffic["drain_s"]
    return 1e3 * stats.latency_quantile(r.latencies, 0.5, miss)
