"""The requests the server's batches carried over the slots it launched
(each batch padded up to its batch size), over the window's ``serve.batch``
spans."""

from portbench import program_spans


def read(run):
    spans = program_spans.window(run, "serve.batch")
    if not spans:
        return None
    slots = sum(s.attrs["slots"] for s in spans)
    return 100.0 * sum(s.attrs["requests"] for s in spans) / slots
