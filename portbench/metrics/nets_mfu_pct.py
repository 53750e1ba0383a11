"""The nets' share of the bf16 tensor peak while they run: the net's
FLOPs at the size it runs at (``counts.net_flops_per_image`` at the
image's own size, as ``mfu_pct`` counts them, over ``curve_downsample``
squared for the curve net, which runs on the image scaled down by it)
times the batch of each of the window's net spans (``nets.curve_cnn``,
``nets.fcn``, ``nets.decom_net``), summed, over the sum of their device
seconds (the stream's time between each span's edges, from CUDA events)
and 989 TFLOP/s. A conv or layout change in the nets moves it; K3, the
input cast, the crop and the host do not."""

from portbench import counts, program_spans


def read(run):
    spans = program_spans.window(run, "nets.curve_cnn", "nets.fcn",
                                 "nets.decom_net")
    if not spans or any(s.device_s is None for s in spans):
        return None
    r = run.record
    flops = counts.net_flops_per_image(run.config["net"]["layers"],
                                       r.height, r.width)
    ds = run.config["pipeline"].get("curve_downsample", 1)
    images = sum(s.attrs["batch"] / (ds * ds if s.name == "nets.curve_cnn"
                                     else 1) for s in spans)
    device_s = sum(s.device_s for s in spans)
    return 100.0 * flops * images / device_s / counts.PEAK_BF16_TENSOR_FLOPS
