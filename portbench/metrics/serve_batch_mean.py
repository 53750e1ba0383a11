"""The mean batch of the device calls the server made in the window, as
launched (padded up to the server's batch sizes)."""


def read(run):
    launched = run.record.launched
    if not launched:
        return None
    return sum(launched) / len(launched)
