"""The share of the traced window (first request due to last answer) in
which no device operation runs; the serving cells' name of the metric."""


def read(run):
    return run.idle_pct()
