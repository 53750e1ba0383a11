"""The 95th percentile, by nearest rank, of the latency of every request
sent in the window, from when it was due to when its answer resolved; a
failed or unresolved request counts as a miss (past any limit: the drain's
end)."""

from portbench import stats


def read(run):
    r = run.record
    miss = r.t1 - r.t0 + run.traffic["drain_s"]
    return 1e3 * stats.latency_quantile(r.latencies, 0.95, miss)
