"""The share of the traced window in which no device operation runs while
the server's dispatcher is inside its own host steps (``serve.stack``,
``serve.copy_in``, ``serve.resolve``): the idle its host work causes."""

from portbench import program_spans, stats

HOST_STEPS = ("serve.stack", "serve.copy_in", "serve.resolve")


def overlap(a, b) -> float:
    """The length of the intersection of two sorted lists of disjoint
    intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def read(run):
    spans = program_spans.window(run, *HOST_STEPS)
    if not spans or not run.trace.device_ops:
        return None
    r = run.record
    idle = stats.gaps([(a, b) for a, b, _ in run.trace.device_ops],
                      r.t0, r.t1)
    host = stats.merge([(s.start, s.end) for s in spans], r.t0, r.t1)
    return 100.0 * overlap(idle, host) / run.window_s
