"""The host's time inside each ``enhance_batch_device`` call (host clock,
no sync), the mean over the window's calls."""


def read(run):
    spans = run.record.spans["dispatch"]
    if not spans:
        return None
    return 1e3 * sum(b - a for a, b in spans) / len(spans)
