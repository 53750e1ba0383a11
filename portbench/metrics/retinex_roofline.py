"""The retinex work's least time a batch (``counts.retinex_least_s``: the
larger of its CUDA-core FLOPs over the float32 peak and its u8 bytes over
the HBM rate) over the device's busy time a batch in the traced window."""

from portbench import counts


def read(run):
    r = run.record
    busy = run.busy_s()
    if not busy:
        return None
    least = counts.retinex_least_s(run.config["pipeline"], r.batch,
                                   r.height, r.width)
    return 100.0 * least / (busy / (r.images / r.batch))
