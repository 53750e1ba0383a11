"""The 95th percentile, by nearest rank, of the requests' waits in the
server's queue, from ``submit``'s enqueue until the dispatcher takes the
request into a batch (the program's ``serve.queue`` spans)."""

from portbench import program_spans, stats


def read(run):
    spans = program_spans.window(run, "serve.queue")
    if not spans:
        return None
    return 1e3 * stats.nearest_rank([s.end - s.start for s in spans], 0.95)
