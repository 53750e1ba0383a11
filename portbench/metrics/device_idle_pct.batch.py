"""The share of the traced window in which no device operation runs (the
union of the profiler's kernel, copy and set intervals); the batch cells'
name of the metric."""


def read(run):
    return run.idle_pct()
