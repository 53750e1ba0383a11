"""The host's time inside ``EnhancePipeline.enhance_batch_device``, read
from the program's own ``pipeline.enhance_batch_device`` spans (no sync),
the mean over the window's calls: the inside counterpart of
``dispatch_ms.batch``."""

from portbench import program_spans


def read(run):
    spans = program_spans.window(run, "pipeline.enhance_batch_device")
    if not spans:
        return None
    return 1e3 * sum(s.end - s.start for s in spans) / len(spans)
