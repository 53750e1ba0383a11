"""The whole step's share of the bf16 tensor peak, on the host's clock:
the net's FLOPs at the image's own size, times the images completed in the
window, over the window's seconds and 989 TFLOP/s. It is ``images_per_s``
as a share of the peak, so it moves with everything in the step (the net,
K3, the casts, the host's gaps), not with the net alone."""

from portbench import counts


def read(run):
    r = run.record
    flops = counts.net_flops_per_image(run.config["net"]["layers"],
                                       r.height, r.width)
    return (100.0 * flops * r.images / run.window_s
            / counts.PEAK_BF16_TENSOR_FLOPS)
