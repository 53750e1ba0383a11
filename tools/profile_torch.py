#!/usr/bin/env python3
"""Where the device time of the PyTorch/CUDA port goes, by kernel.

For each named image path, ``EnhancePipeline(device="cuda")
.enhance_batch_device`` runs at 600x400 batch 48 (synthetic LOL-shaped
images); for each video path (``video_*``, the arms of the JAX package's
1080p video benchmark), ``VideoEnhancer(device="cuda")``'s frame step runs
at 1080p with its state fed forward, alternating two frames. Each runs
under ``torch.profiler`` for a few calls after a warm-up
(``utils.profiling.profile_trace``, the calls inside ``stage(path)``; the
trace lands in ``build/traces/<path>/``). It prints, per
call, the wall time, the device-busy time (the sum of the CUDA kernels' and
copies' own device times), the idle share (1 - busy / wall), and the
kernels that take the most device time with their shares. The guided
paths (``*_guided``) run the guided tail at r 4 (retinex at r 2 too).

``stages`` is the port's counterpart of the JAX package's
``scripts/profile_stages.py``: K1 alone on the 600x400 b48 images, compiled
with its stages enabled in turn (none: u8 in, quantize, u8 out; + blur; +
boost; + denoise), each timed with CUDA events (the calls queued behind a
spin, so that the device alone is timed), and the differences are each
stage's device time; then the whole pipeline call, whose difference from
the full kernel is the host-to-kernel glue. ``stages_guided`` splits the
guided kernel (``csrc/fused_guided.cu``) of each family the same way, by
the parts of a launch it runs (``fused_guided(parts=...)``): the staging
alone, + the guided filter (``guided_tile``), + the store: K1 at r 2 and r
4 (luma) on the 600x400 b48 images, K3 hybrid at r 4 on its 600x400 b48
block, K3 at ds 4 with the gain plane (the video step's form) at r 2,
K4 at r 2 and K1's gain form at r 4 on a 1080p frame; beside them K5's
guided arm on the ``quality`` block, and each form's device time a
megapixel of output.
``stages_k3`` does the same for K3 (its
forms truncated instead: the tail off by strength 0, the curves off by
K1's gain form, which is K3's kernel without them): the video step's form
at 1080p b1 (the gain plane and maps at 1/4: u8 in, gain, u8 out; +
curves; + the bilateral tail) and hybrid's at 600x400 b48 (maps at 1/1:
curve's u8 in, curves, u8 out; + hybrid's blur and boost; + the tail).

Needs a CUDA card; run from the repository root:

    python3 tools/profile_torch.py [quality quality_fast retinex hybrid
                                    hybrid_pallas quality_pallas
                                    quality_fast_pallas quality_fast_cascade
                                    hybrid_pallas_f64 hybrid_pallas_f160
                                    retinex_guided retinex_guided_r2
                                    hybrid_guided hybrid_pallas_guided
                                    video_retinex
                                    video_retinex_extgain video_curve_ds4
                                    video_hybrid_ds4 video_retinex_guided
                                    video_hybrid_ds4_guided
                                    stages stages_guided stages_k3]
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import low_light_image_enhancement_tpu_torch as llt  # noqa: E402
from low_light_image_enhancement_tpu_torch.data.synth import (  # noqa: E402
    synth_batch,
)
from low_light_image_enhancement_tpu_torch.utils import (  # noqa: E402
    profile_trace,
    stage,
)

# each path's trace (Chrome trace JSON), one directory a path
TRACE_DIR = Path(__file__).resolve().parents[1] / "build" / "traces"

PATHS = {
    "retinex": llt.PipelineConfig(),
    "hybrid": llt.PipelineConfig(method="hybrid"),
    "quality": llt.PRESETS["quality"],
    "quality_fast": llt.PRESETS["quality_fast"],
    # the nets' convs as the port's kernels (K6a, K6b, K7)
    "hybrid_pallas": llt.PipelineConfig(method="hybrid", conv_impl="pallas"),
    "quality_pallas": llt.PRESETS["quality"].replace(conv_impl="pallas"),
    "quality_fast_pallas": llt.PRESETS["quality_fast"].replace(
        conv_impl="pallas"),
    "quality_fast_cascade": llt.PRESETS["quality_fast"].replace(
        conv_impl="cascade"),
    # the curve CNN at 64 and 160 features (random weights) under "pallas"
    "hybrid_pallas_f64": llt.PipelineConfig(method="hybrid",
                                            conv_impl="pallas",
                                            curve_features=64),
    "hybrid_pallas_f160": llt.PipelineConfig(method="hybrid",
                                             conv_impl="pallas",
                                             curve_features=160),
    # the guided tail (K1's and K3's)
    "retinex_guided": llt.PipelineConfig(denoise_taps="guided",
                                         guided_radius=4),
    "retinex_guided_r2": llt.PipelineConfig(denoise_taps="guided"),
    "hybrid_guided": llt.PipelineConfig(method="hybrid",
                                        denoise_taps="guided",
                                        guided_radius=4),
    "hybrid_pallas_guided": llt.PipelineConfig(method="hybrid",
                                               conv_impl="pallas",
                                               denoise_taps="guided",
                                               guided_radius=4),
}
# (config, ema_in_kernel) of the video benchmark's arms, alpha 0.3
VIDEO_PATHS = {
    "video_retinex": (llt.PipelineConfig(), True),
    "video_retinex_extgain": (llt.PipelineConfig(), False),
    "video_curve_ds4": (llt.PipelineConfig(method="curve",
                                           curve_downsample=4), True),
    "video_hybrid_ds4": (llt.PipelineConfig(method="hybrid",
                                            curve_downsample=4), True),
    "video_retinex_guided": (llt.PipelineConfig(denoise_taps="guided"),
                             True),
    "video_hybrid_ds4_guided": (llt.PipelineConfig(
        method="hybrid", curve_downsample=4, denoise_taps="guided"), True),
}
# K1's stages enabled in turn, as the JAX package's profile_stages.py
STAGE_STEPS = (("none", ()), ("blur", ("blur",)),
               ("boost", ("blur", "boost")),
               ("denoise", ("blur", "boost", "denoise")))
STAGE_PATHS = {"stages": llt.PipelineConfig()}
CALLS, TOP = 3, 12
SPIN_CYCLES = 50_000_000


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _report(what: str, run) -> None:
    """Profile CALLS calls of ``run`` after two warm-up calls, inside the
    stage ``what``; the trace goes to ``TRACE_DIR``."""
    for _ in range(2):
        run()
    torch.cuda.synchronize()
    slug = "".join(c if c.isalnum() else "_" for c in what)
    with profile_trace(TRACE_DIR / slug) as prof:
        with stage(what):
            t0 = time.perf_counter()
            for _ in range(CALLS):
                run()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    # the stage's own range on the device's timeline spans the kernels:
    # not a kernel of its own
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA") and e.key != what]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / CALLS
    print(f"{what}, {CALLS} calls: wall {wall_ms:.3f} ms/call, device busy "
          f"{busy_ms:.3f} ms/call, idle share "
          f"{max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:TOP]:
        ms = _device_us(e) / 1e3 / CALLS
        print(f"  {ms:9.3f} ms/call {ms / busy_ms:6.1%} "
              f"x{e.count // CALLS:<4d} {e.key[:110]}")


def profile(name: str, x: torch.Tensor) -> None:
    pipe = llt.EnhancePipeline(PATHS[name], device="cuda")
    _report(f"{name}: 600x400 b{x.shape[0]}",
            lambda: pipe.enhance_batch_device(x))


def profile_video(name: str, frame: torch.Tensor) -> None:
    """One call is one frame step at 1080p, the state fed forward."""
    cfg, ema_in_kernel = VIDEO_PATHS[name]
    ve = llt.VideoEnhancer(cfg, alpha=0.3, device="cuda",
                           ema_in_kernel=ema_in_kernel)
    ve.process(frame.cpu().numpy())  # builds the step and the state
    frames = (frame, torch.bitwise_xor(frame, 1))
    calls = [0]

    def step():
        ve._state, _ = ve._step(ve._state, frames[calls[0] % 2])
        calls[0] += 1

    _report(f"{name}: 1080p step", step)


def _device_ms(fn, iters: int = 20) -> float:
    """ms a call of the device alone: the calls queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def profile_stages(name: str, x: torch.Tensor) -> None:
    """K1's truncated forms differenced: each stage's device time."""
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )

    cfg = STAGE_PATHS[name]
    card = torch.cuda.get_device_name(0)
    ms = {}
    for step, stages in STAGE_STEPS:
        ms[step] = min(_device_ms(lambda: fe.fused_retinex(x, cfg,
                                                           stages=stages))
                       for _ in range(2))
    pipe = llt.EnhancePipeline(cfg, device="cuda")
    ms["pipeline"] = min(_device_ms(lambda: pipe.enhance_batch_device(x))
                         for _ in range(2))
    prev = 0.0
    print(f"{name}: K1 by stage, 600x400 b{x.shape[0]} on {card} (ms a call, "
          f"the device alone)")
    for step, _ in STAGE_STEPS:
        print(f"  + {step:<8s} {ms[step]:.4f} total, {ms[step] - prev:+.4f}")
        prev = ms[step]
    print(f"  pipeline  {ms['pipeline']:.4f} total, "
          f"{ms['pipeline'] - prev:+.4f} (the glue around the kernel)")


def profile_stages_k3(x: torch.Tensor, frame: torch.Tensor) -> None:
    """K3's truncated forms differenced: each stage's device time."""
    from low_light_image_enhancement_tpu_torch import video as tvideo
    from low_light_image_enhancement_tpu_torch.blocks import (
        _mask_extent,
        block_curve_maps,
        curve_maps_for_kernel,
        learned_halo,
    )
    from low_light_image_enhancement_tpu_torch.config import canvas_margin
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )
    from low_light_image_enhancement_tpu_torch.ops.colorspace import (
        normalize_u8,
    )
    from low_light_image_enhancement_tpu_torch.pipeline import pad_block

    card = torch.cuda.get_device_name(0)
    hybrid = llt.PipelineConfig(method="hybrid")
    params = llt.EnhancePipeline(hybrid, device="cuda").model_params
    off = dict(denoise_strength=0.0)
    # the video step's form: a 1080p block, its gain plane, maps at 1/4
    h4 = hybrid.replace(curve_downsample=4)
    xb = tvideo.pad_video_block(frame[None], h4)
    halo, m = learned_halo(h4), canvas_margin(h4)
    rows = xb.shape[-2] - 2 * halo
    gain = torch.full((1,) + xb.shape[-2:], 1.5, device=xb.device)
    with torch.inference_mode():
        cnn_in = torch.clamp(normalize_u8(xb) * gain[:, None], 0.0, 1.0)
        maps4 = curve_maps_for_kernel(_mask_extent(cnn_in, -halo, 1080, 1920,
                                                   m), h4, params)
    k1g = llt.PipelineConfig(**off)
    video = (("in/out", lambda: fe.fused_retinex_gain(xb, gain, k1g, halo,
                                                      rows)),
             ("curves", lambda: fe.fused_curve_enhance(
                 xb, maps4, h4.replace(**off), halo, rows, 1920, ds=4,
                 gain=gain)),
             ("tail", lambda: fe.fused_curve_enhance(
                 xb, maps4, h4, halo, rows, 1920, ds=4, gain=gain)))
    # hybrid's image form: 600x400 b48, maps at 1/1
    xb1, halo1 = pad_block(x, hybrid)
    rows1 = xb1.shape[-2] - 2 * halo1
    with torch.inference_mode():
        maps1 = block_curve_maps(xb1, hybrid, params, -halo1, 400, 600)
    curve = llt.PipelineConfig(method="curve", **off)
    image = (("curves", lambda: fe.fused_curve_enhance(
                 xb1, maps1, curve, halo1, rows1, 600)),
             ("boost", lambda: fe.fused_curve_enhance(
                 xb1, maps1, hybrid.replace(**off), halo1, rows1, 600)),
             ("tail", lambda: fe.fused_curve_enhance(
                 xb1, maps1, hybrid, halo1, rows1, 600)))
    for what, steps in (("video form, ds 4 + gain, 1080p b1", video),
                        (f"hybrid ds 1, 600x400 b{x.shape[0]}", image)):
        print(f"stages_k3: K3 {what} on {card} (ms a call, the device "
              f"alone)")
        prev = 0.0
        for step, fn in steps:
            t = min(_device_ms(fn) for _ in range(2))
            print(f"  + {step:<8s} {t:.4f} total, {t - prev:+.4f}")
            prev = t


def profile_stages_guided(x: torch.Tensor, frame: torch.Tensor) -> None:
    """The guided kernel's parts differenced, family by family."""
    from low_light_image_enhancement_tpu_torch import video as tvideo
    from low_light_image_enhancement_tpu_torch.blocks import (
        _mask_extent,
        block_curve_maps,
        block_net_image,
        curve_maps_for_kernel,
        learned_halo,
    )
    from low_light_image_enhancement_tpu_torch.config import canvas_margin
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )
    from low_light_image_enhancement_tpu_torch.kernels import (
        tiled_denoise as td,
    )
    from low_light_image_enhancement_tpu_torch.ops.colorspace import (
        normalize_u8,
    )
    from low_light_image_enhancement_tpu_torch.pipeline import pad_block

    card = torch.cuda.get_device_name(0)
    guided = dict(denoise_taps="guided")
    cfg0 = llt.PipelineConfig(**guided)
    hybrid = llt.PipelineConfig(method="hybrid", **guided)
    params = llt.EnhancePipeline(hybrid, device="cuda").model_params
    b = x.shape[0]
    forms = []
    for r in (2, 4):
        cfg = cfg0.replace(guided_radius=r)
        forms.append((f"K1 r {r} luma 600x400 b{b}", b * 400 * 600,
                      lambda cfg=cfg: fe.fused_retinex(x, cfg)))
    h4 = hybrid.replace(guided_radius=4)
    xb1, halo1 = pad_block(x, h4)
    rows1 = xb1.shape[-2] - 2 * halo1
    with torch.inference_mode():
        maps1 = block_curve_maps(xb1, h4, params, -halo1, 400, 600)
    forms.append((f"K3 hybrid r 4 600x400 b{b}", b * rows1 * xb1.shape[-1],
                  lambda: fe.fused_curve_enhance(xb1, maps1, h4, halo1,
                                                 rows1, 600)))
    v4 = hybrid.replace(curve_downsample=4)
    xbv = tvideo.pad_video_block(frame[None], v4)
    halo, m = learned_halo(v4), canvas_margin(v4)
    rows = xbv.shape[-2] - 2 * halo
    gain = torch.full((1,) + xbv.shape[-2:], 1.5, device=xbv.device)
    with torch.inference_mode():
        cnn_in = torch.clamp(normalize_u8(xbv) * gain[:, None], 0.0, 1.0)
        maps4 = curve_maps_for_kernel(_mask_extent(cnn_in, -halo, 1080, 1920,
                                                   m), v4, params)
    forms.append(("K3 ds 4 + gain r 2 1080p b1", rows * xbv.shape[-1],
                  lambda: fe.fused_curve_enhance(xbv, maps4, v4, halo, rows,
                                                 1920, ds=4, gain=gain)))
    g4 = cfg0.replace(guided_radius=4)
    xbg = tvideo.pad_video_block(frame[None], g4)
    halo_g = learned_halo(g4)
    rows_g = xbg.shape[-2] - 2 * halo_g
    gain_g = torch.full((1,) + xbg.shape[-2:], 1.5, device=xbg.device)
    forms.append(("K1 gain form r 4 1080p b1", rows_g * xbg.shape[-1],
                  lambda: fe.fused_retinex_gain(xbg, gain_g, g4, halo_g,
                                                rows_g)))
    xbe = tvideo.pad_video_block(frame[None], cfg0)
    halo_e = learned_halo(cfg0)
    rows_e = xbe.shape[-2] - 2 * halo_e
    carry = torch.full((1,) + xbe.shape[-2:], -1.0, device=xbe.device)
    forms.append(("K4 r 2 1080p b1", rows_e * xbe.shape[-1],
                  lambda: fe.fused_retinex_ema(xbe, carry, cfg0, halo_e,
                                               rows_e, 1920, 0.3)))
    orig = fe.fused_guided

    def with_parts(parts, fn):
        def part(*a, **k):
            return orig(*a, parts=parts, **k)

        part.launches = 0

        def run():
            fe.fused_guided = part
            try:
                return fn()
            finally:
                fe.fused_guided = orig
        return run

    print(f"stages_guided: the guided kernel by part on {card} (ms a call, "
          f"the device alone; us a megapixel of output)")
    for what, px, fn in forms:
        prev = 0.0
        print(f"  {what}:")
        for step, parts in (("staging", 0), ("guided", 1), ("store", 3)):
            t = min(_device_ms(with_parts(parts, fn)) for _ in range(2))
            print(f"    + {step:<8s} {t:.4f} total, {t - prev:+.4f}, "
                  f"{t / px * 1e9:.1f} us/Mpx")
            prev = t
    q = llt.PRESETS["quality"]
    xq, haloq = pad_block(x, q)
    rowsq = xq.shape[-2] - 2 * haloq
    with torch.inference_mode():
        y = block_net_image(xq, q, llt.EnhancePipeline(
            q, device="cuda").model_params, -haloq, 400, 600)
    t = min(_device_ms(lambda: td.tiled_denoise(y, q, haloq, rowsq))
            for _ in range(2))
    px = b * rowsq * y.shape[-1]
    print(f"  K5 guided r 4 luma (quality block {y.shape[-1]}x{rowsq} b{b}, "
          f"f32): {t:.4f} ms, {t / px * 1e9:.1f} us/Mpx")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_torch: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__)
    names = argv or (list(PATHS) + list(VIDEO_PATHS) + list(STAGE_PATHS)
                     + ["stages_guided", "stages_k3"])
    unknown = (set(names) - set(PATHS) - set(VIDEO_PATHS)
               - set(STAGE_PATHS) - {"stages_guided", "stages_k3"})
    if unknown:
        print(f"profile_torch: unknown paths {sorted(unknown)}",
              file=sys.stderr)
        return 2
    two = ("stages_guided", "stages_k3")
    if any(n in PATHS or n in STAGE_PATHS or n in two for n in names):
        x = torch.from_numpy(synth_batch(48, 400, 600, seed=5)[0]).cuda()
    if any(n in VIDEO_PATHS or n in two for n in names):
        frame = torch.from_numpy(synth_batch(1, 1080, 1920, seed=13)[0][0])
        frame = frame.cuda()
    for name in names:
        if name in PATHS:
            profile(name, x)
        elif name in STAGE_PATHS:
            profile_stages(name, x)
        elif name == "stages_guided":
            profile_stages_guided(x, frame)
        elif name == "stages_k3":
            profile_stages_k3(x, frame)
        else:
            profile_video(name, frame)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
