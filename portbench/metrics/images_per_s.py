"""All images whose outputs completed in the window, over the window's
seconds (first dispatch to after the last device sync)."""


def read(run):
    return run.record.images / run.window_s
