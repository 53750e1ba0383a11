"""Throughput of the port: 600x400 (LOL-sized) images per second on one
card, by the chained marginal-rate protocol of the repository's root
``bench.py`` (which stays the JAX package's).

Run ``python -m low_light_image_enhancement_tpu_torch.bench`` (or
``llie-torch bench``); it prints ONE JSON line on stdout, last:
  {"metric": "images_per_sec_per_chip_600x400", "value": N,
   "unit": "images/sec/chip", ...}
and the rates on stderr.

Method, as the root ``bench.py``: a synthetic u8 batch (``bench_input``)
goes through ``EnhancePipeline.enhance_batch_device``; each step's output
is the next step's input, so no step can overlap or skip another. A short
chain (``n_short`` steps) and a long one (``n_long``) are each timed on
the host's clock from launch to ``torch.cuda.synchronize``, and the rate
is the batch over the marginal time a step between them, which cancels
the fixed launch and sync cost. ``chain="device"`` captures each chain
into one CUDA graph (``DeviceChain``), so a chain is one ``replay()``:
the counterpart of the JAX bench's one ``lax.fori_loop`` dispatch a
chain, which keeps the host's launch time out of the step. The graph's
output after ``n_short`` steps must equal the eager chain's (Δ 0), or the
call raises. ``chain="python"`` launches every step from Python. For
retinex on the card a canvas rate chains K1's canvas form alone (an edge
re-pad of the output canvas's bottom rows, then
``fused_retinex_canvas``), as the JAX bench's canvas rate does. The rates
are placed on the H100's roofline (``utils.roofline.roofline_report``).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

__all__ = ["METRIC", "bench_input", "eager_chain", "DeviceChain", "warm_up",
           "launch_counts", "canvas_step", "canvas_input", "bench_throughput", "power_limit", "main"]

METRIC = "images_per_sec_per_chip_600x400"


def bench_input(batch: int, h: int, w: int, device="cuda") -> torch.Tensor:
    """The bench's input: ``synth_batch(min(batch, 8), h, w)`` tiled to
    ``batch``, a (batch, h, w, 3) u8 tensor on ``device``."""
    from low_light_image_enhancement_tpu_torch.data.synth import synth_batch

    lows, _ = synth_batch(min(batch, 8), h, w)
    lows = np.tile(lows, (-(-batch // lows.shape[0]), 1, 1, 1))[:batch]
    return torch.from_numpy(np.ascontiguousarray(lows)).to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def eager_chain(step: Callable, x: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` chained steps launched from Python: each output is the next
    input."""
    for _ in range(n):
        x = step(x)
    return x


def _time_chain(step, x0, n: int, device) -> float:
    t0 = time.perf_counter()
    eager_chain(step, x0, n)
    _sync(device)
    return time.perf_counter() - t0


def _kernel_wrappers() -> Dict[str, Callable]:
    """The port's kernel wrappers by name; each counts its launches."""
    from low_light_image_enhancement_tpu_torch.kernels import (
        fcn_cascade,
        fused_enhance,
        fused_enhance_hwc,
        mxu_conv,
        tiled_denoise,
    )

    wrappers = [fused_enhance.fused_retinex,
                fused_enhance.fused_retinex_canvas,
                fused_enhance.fused_curve_enhance,
                fused_enhance.fused_retinex_ema,
                fused_enhance.fused_guided,
                fused_enhance.blur_illumination,
                tiled_denoise.tiled_denoise, mxu_conv.conv2d_patch_mxu,
                mxu_conv.conv2d_dense9_mxu, fcn_cascade.fcn_cascade_mxu,
                fused_enhance_hwc.enhance_hwc_u8]
    return {f.__name__: f for f in wrappers}


def launch_counts() -> Dict[str, int]:
    """The port's kernel wrappers' launch counts, by wrapper name. Taken
    before and after a capture, their difference is the kernels the graph
    holds: a wrapper counts once when its launch is captured, not at each
    replay."""
    return {k: f.launches for k, f in _kernel_wrappers().items()}


class DeviceChain:
    """``n`` chained steps from ``x0`` captured into one CUDA graph; each
    ``replay()`` runs them all and returns the last step's output (the
    same tensor every time). ``x0`` stays the graph's input: it must not
    change while the chain is in use. Warm the step up first (the kernel
    build, cuDNN's first-call set-up): nothing is warmed up here, so that
    the launches counted around the constructor are the captured ones."""

    def __init__(self, step: Callable, x0: torch.Tensor, n: int):
        if x0.device.type != "cuda":
            raise ValueError(f"a CUDA graph chain needs a CUDA tensor, got "
                             f"{x0.device}")
        self.device = x0.device
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            self.out = eager_chain(step, x0, n)

    def replay(self) -> torch.Tensor:
        self.graph.replay()
        return self.out

    def timed(self) -> float:
        """Seconds on the host's clock from the replay's launch to the
        device's sync."""
        t0 = time.perf_counter()
        self.graph.replay()
        torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def reset(self) -> None:
        """Free the graph and its memory pool."""
        self.graph.reset()
        self.out = None


def warm_up(step, x0, device, n: int = 3) -> None:
    """``n`` eager steps on a side stream, as torch asks before a capture
    (the kernel build, cuDNN's first-call set-up)."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        eager_chain(step, x0, n)
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)


def _rate(batch, t_short, t_long, n_short, n_long):
    """The marginal rate (batch over the marginal seconds a step), or,
    where the long chain measured no slower than the short one, the
    total-time rate of the long chain (positive, pessimistic: the sync
    included); the second value says which."""
    marginal = (t_long - t_short) / (n_long - n_short)
    if marginal > 0:
        return batch / marginal, False
    return batch * n_long / max(t_long, 1e-9), True


def _max_abs_du8(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.to(torch.int16) - b.to(torch.int16)).abs().max())


def _chained_rates(batch, repeats, n_short, n_long, t_pair):
    rates, fallbacks = [], 0
    for _ in range(repeats):
        r, fell = _rate(batch, *t_pair(), n_short, n_long)
        rates.append(r)
        fallbacks += fell
    return rates, fallbacks


def _graph_rates(step, x0, batch, repeats, n_short, n_long):
    """The device chain: the short and long chains captured into a graph
    each (after a warm-up), the short graph's output held to the eager
    chain's (anything but Δ 0 raises), one replay of each to upload them,
    then ``repeats`` timed pairs of replays. Returns the rates, the
    fallback count and a dict of ``graph_launches`` (the port's kernels
    the short graph holds), ``graph_max_abs_du8`` and
    ``capture_peak_bytes`` (the device memory allocated at the peak of the
    long capture)."""
    device = x0.device
    warm_up(step, x0, device)
    before = launch_counts()
    short = DeviceChain(step, x0, n_short)
    held = {k: n - before[k] for k, n in launch_counts().items()
            if n != before[k]}
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    long_ = DeviceChain(step, x0, n_long)
    peak = torch.cuda.max_memory_allocated(device)
    d = _max_abs_du8(short.replay(), eager_chain(step, x0, n_short))
    if d:
        raise RuntimeError(f"the CUDA graph's chain of {n_short} steps "
                           f"differs from the eager chain: max |du8| {d}")
    short.timed()
    long_.timed()
    rates, fallbacks = _chained_rates(batch, repeats, n_short, n_long,
                                      lambda: (short.timed(), long_.timed()))
    short.reset()
    long_.reset()
    return rates, fallbacks, {"graph_launches": held, "graph_max_abs_du8": d,
                              "capture_peak_bytes": peak}


def bench_throughput(
    batch: int = 48,
    h: int = 400,
    w: int = 600,
    repeats: int = 7,
    n_short: int = 8,
    n_long: int = 60,
    method: str = "retinex",
    chain: str = "device",
    device="cuda",
) -> dict:
    """Images a second of ``EnhancePipeline(PipelineConfig(method=method),
    device=device).enhance_batch_device`` on a batch of ``batch`` (h, w)
    images, by the chained marginal-rate protocol (the module's doc).

    ``chain="device"`` captures the short and long chains into one CUDA
    graph each and times their replays; it needs ``device="cuda"`` and
    raises a ``ValueError`` on the CPU. ``chain="python"`` launches each
    step from Python, after one discarded pair of chains.

    Returns the JAX bench's keys (``images_per_sec`` the median rate,
    ``canvas_images_per_sec``, ``rate_min``, ``rate_max``,
    ``rate_iqr_pct``, ``batch``, ``backend``, ``rates``), the card's
    ``device_name``, the roofline placement of the median, and
    ``n_fallback`` (repeats whose rate is the total-time one). A device
    chain adds ``graph_launches`` (the port's kernels in the short graph:
    a count a captured launch), ``graph_max_abs_du8`` (its output against
    the eager chain's, always 0: else it raised), ``capture_peak_bytes``
    (the device memory allocated at the peak of the long capture) and,
    for retinex, the canvas chain's ``canvas_graph_launches``."""
    from low_light_image_enhancement_tpu_torch.config import PipelineConfig
    from low_light_image_enhancement_tpu_torch.pipeline import (
        EnhancePipeline,
        resolve_device,
    )
    from low_light_image_enhancement_tpu_torch.utils.roofline import (
        roofline_report,
    )

    if chain not in ("device", "python"):
        raise ValueError(f"chain must be device or python: {chain!r}")
    device = resolve_device(device, "bench_throughput")
    if chain == "device" and device.type != "cuda":
        raise ValueError(
            "chain='device' captures each chain into one CUDA graph, which "
            f"needs device='cuda' (got {device}); use chain='python' on the "
            "CPU")
    if not 0 < n_short < n_long:
        raise ValueError(f"need 0 < n_short < n_long, got {n_short}, "
                         f"{n_long}")
    cfg = PipelineConfig(method=method)
    pipe = EnhancePipeline(cfg, device=device)
    step = pipe.enhance_batch_device
    x0 = bench_input(batch, h, w, device)
    step(x0)  # the kernel build and the first calls' set-up
    _sync(device)

    res: dict = {}
    if chain == "device":
        rates, fallbacks, res = _graph_rates(step, x0, batch, repeats,
                                             n_short, n_long)
    else:
        # steady state: one short and long chain pair run and discarded
        _time_chain(step, x0, n_short, device)
        _time_chain(step, x0, n_long, device)
        rates, fallbacks = _chained_rates(
            batch, repeats, n_short, n_long,
            lambda: (_time_chain(step, x0, n_short, device),
                     _time_chain(step, x0, n_long, device)))
    value = float(np.median(rates))

    canvas_value = None
    if chain == "device" and method == "retinex":
        canvas_value, canvas_held = _canvas_rate(pipe, x0, batch, h, w,
                                                 repeats, n_short, n_long)
        res["canvas_graph_launches"] = canvas_held

    out = {
        "images_per_sec": value,
        "canvas_images_per_sec": (round(canvas_value, 1) if canvas_value
                                  else None),
        "rate_min": float(np.min(rates)),
        "rate_max": float(np.max(rates)),
        "rate_iqr_pct": float(
            100.0 * (np.percentile(rates, 75) - np.percentile(rates, 25))
            / value),
        "batch": batch,
        "backend": device.type,
        "rates": [round(r, 1) for r in rates],
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "method": method,
        "chain": chain,
        "n_fallback": fallbacks,
        **res,
    }
    out.update(roofline_report(cfg, h, w, value))
    return out


def canvas_step(pipe, h: int, w: int) -> Callable:
    """The canvas chain's step for (h, w) images of a retinex pipeline: an
    edge re-pad of the output canvas's bottom rows to the canvas's height,
    then K1's canvas form (``fused_retinex_canvas``)."""
    from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
        fused_retinex_canvas,
    )

    plan = pipe.canvas_plan(h, w)
    m, cfg = plan.margin, pipe.config

    @torch.inference_mode()
    def step(v):
        # the bottom rows' edge pad as one copy of 8-byte words (the
        # canvas's width is a multiple of 128): a copy of single bytes
        # took as long as K1's canvas form, core.pad_edge's two gathers
        # longer
        b, c, rows, wp = v.shape
        words = v.view(torch.int64)
        vp = torch.cat([words, words[..., rows - 1:, :].expand(
            b, c, plan.padded_h - rows, wp // 8)], dim=-2)
        return fused_retinex_canvas(vp.view(torch.uint8), cfg, m,
                                    plan.padded_h - 2 * m)

    return step


def canvas_input(pipe, x0: torch.Tensor) -> torch.Tensor:
    """The canvas chain's first input: one step on the staged canvas
    (``stage_canvas``) of ``x0``'s images."""
    h, w = x0.shape[1:3]
    staged = pipe.stage_canvas(x0.cpu().numpy(), pipe.canvas_plan(h, w))
    return canvas_step(pipe, h, w)(torch.from_numpy(staged).to(x0.device))


def _canvas_rate(pipe, x0, batch, h, w, repeats, n_short, n_long):
    """The canvas rate of retinex on the card, the chain of
    ``canvas_step`` from ``canvas_input``: the median rate and the kernels
    the short graph holds."""
    rates, _, res = _graph_rates(canvas_step(pipe, h, w),
                                 canvas_input(pipe, x0), batch, repeats,
                                 n_short, n_long)
    return float(np.median(rates)), res["graph_launches"]


def power_limit(device=None) -> Optional[str]:
    """The card's power limit as ``nvidia-smi --query-gpu=power.limit``
    gives it (``"700.00 W"``), or None where nvidia-smi does not answer."""
    index = torch.device(device or "cuda").index or 0
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    line = out.strip().splitlines()[0] if out.strip() else ""
    return line.rsplit(",", 1)[-1].strip() or None


def main(argv=None) -> int:
    # the kernel library's objects are reused across runs; the marginal
    # rate never includes the build
    from low_light_image_enhancement_tpu_torch.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="python -m low_light_image_enhancement_tpu_torch.bench")
    parser.add_argument("--batch", type=int, default=48)
    parser.add_argument("--repeats", type=int, default=7)
    parser.add_argument("--method", default="retinex",
                        choices=["retinex", "curve", "hybrid", "fcn",
                                 "decom"],
                        help="pipeline method to bench (headline: retinex)")
    parser.add_argument("--chain", default="device",
                        choices=("device", "python"),
                        help="each chain one CUDA graph replay (device, the "
                             "default; the card only) or one Python launch "
                             "a step (python)")
    parser.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    parser.add_argument("--height", type=int, default=400)
    parser.add_argument("--width", type=int, default=600)
    parser.add_argument(
        "--watchdog", type=float, default=1200.0,
        help="seconds before an unresponsive device aborts the run with an "
             "error JSON line (exit 2) instead of hanging the caller")
    args = parser.parse_args(argv)
    metric = (METRIC if (args.height, args.width) == (400, 600)
              else f"images_per_sec_per_chip_{args.width}x{args.height}")

    if args.watchdog > 0:
        import os
        import threading

        done = threading.Event()

        def _abort():
            if done.wait(args.watchdog):
                return
            print(json.dumps({
                "metric": metric, "value": 0.0, "unit": "images/sec/chip",
                "error": f"watchdog: no result after {args.watchdog:.0f} s "
                         "(device unresponsive?)",
            }), flush=True)
            os._exit(2)

        threading.Thread(target=_abort, daemon=True).start()

    res = bench_throughput(batch=args.batch, h=args.height, w=args.width,
                           repeats=args.repeats, method=args.method,
                           chain=args.chain, device=args.device)
    if args.watchdog > 0:
        done.set()
    roofline = {k: v for k, v in res.items()
                if k.startswith("achieved_") or k.endswith("_util_pct")
                or k == "roofline_bound"}
    print(f"[bench] backend={res['backend']} batch={res['batch']} "
          f"method={res['method']} chain={res['chain']} "
          f"rates={res['rates']}", file=sys.stderr)
    print(json.dumps({
        "metric": metric,
        "value": round(res["images_per_sec"], 2),
        "unit": "images/sec/chip",
        "min": round(res["rate_min"], 2),
        "max": round(res["rate_max"], 2),
        "iqr_pct": round(res["rate_iqr_pct"], 2),
        "n_repeats": len(res["rates"]),
        "canvas_images_per_sec": res["canvas_images_per_sec"],
        **roofline,
        "method": res["method"],
        "chain": res["chain"],
        "device_name": res["device_name"],
        "power_limit": (power_limit(args.device)
                        if res["backend"] == "cuda" else None),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
