"""The images whose answers came back while the window was open, over the
window's seconds (the first request due to the window's close)."""


def read(run):
    r = run.record
    ends = [d + lat for d, lat in zip(r.due, r.latencies) if lat is not None]
    return sum(1 for e in ends if e <= r.close) / (r.close - r.t0)
