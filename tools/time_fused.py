#!/usr/bin/env python3
"""Device times of the port's kernels on the card, for an A/B of two
versions.

Times (CUDA events, the calls queued behind a spin so that the device
alone is timed, the mean of two rounds of ``ITERS`` calls) of the default
forms the main paths run: K1 ``fused_retinex`` on 600x400 b48 u8 (the
default config) and at 1080p b1, and on f32 600x400 b48; K8
``enhance_hwc_u8`` (K1's kernel, per-channel full 3x3) on 600x400 b48; K3
``fused_curve_enhance`` on hybrid's 600x400 b48 block (maps at 1/1, the
shipped weights; and on f32 data), on curve's at ds 2 and, as the video
step calls it, at ds 4 with the gain plane on a 1080p frame; K1's gain
form ``fused_retinex_gain`` (the bilateral tail) on a 1080p frame; K4
``fused_retinex_ema`` on a 1080p frame and on 600x400 b8; then, where the
tree has them, the guided forms (K1 at r 2
and 4 with the luma guide and r 4 per channel, K3 hybrid at r 4, K4 at
r 2 and 4, K3 at ds 4 with the gain plane at r 2 and 4, K1's gain form at
r 4); the blur plane past the tiles, ``blur_illumination`` on 600x400
b48 u8 HWC at r 16 e 1 (K1's wide blur) and r 32 e 8; then the kernels of
the learned paths on their 600x400 b48 blocks: K5 ``tiled_denoise`` on the
``quality`` and ``quality_fast`` nets' images, its bilateral arm also on
``quality_fast``'s 1080p b1 block and in the full 3x3 per-channel ``epan``
form, and, on random bf16 activations, K6a (hybrid's c5, 64 -> 32), K6b
(fcn's c2, d 2) and K7 (fcn's c2-c7). A form the tree does not have
prints "absent".

Needs a CUDA card and nvcc; run from the root of a tree:
``python3 tools/time_fused.py``. Copied into an unpacked older tree and
run there and here in turns (parent, change, change, parent), it compares
two versions on one card.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import low_light_image_enhancement_tpu_torch as llt  # noqa: E402
from low_light_image_enhancement_tpu_torch import video as tvideo  # noqa
from low_light_image_enhancement_tpu_torch.blocks import (  # noqa: E402
    _mask_extent,
    block_curve_maps,
    block_net_image,
    curve_maps_for_kernel,
    kernel_maps_ds,
    learned_halo,
)
from low_light_image_enhancement_tpu_torch.config import (  # noqa: E402
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.data.synth import (  # noqa: E402
    synth_batch,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    _build,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    fcn_cascade as fc,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    fused_enhance as fe,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    fused_enhance_hwc as hw,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    mxu_conv as mx,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    tiled_denoise as td,
)
from low_light_image_enhancement_tpu_torch.ops.colorspace import (  # noqa
    normalize_u8,
)
from low_light_image_enhancement_tpu_torch.pipeline import (  # noqa: E402
    pad_block,
)

ITERS = 20
SPIN_CYCLES = 50_000_000
FCN_DILATIONS = (2, 4, 8, 16, 32, 1)   # fcn c2-c7


def ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    vals = []
    for _ in range(2):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(ITERS):
            fn()
        end.record()
        end.synchronize()
        vals.append(start.elapsed_time(end) / ITERS)
    return sum(vals) / len(vals)


def main() -> int:
    if not torch.cuda.is_available():
        print("time_fused: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    t0 = time.perf_counter()
    _build.load_library()
    print(f"{card} | build {time.perf_counter() - t0:.1f} s | "
          f"{Path(__file__).resolve().parents[1]}")
    dev = torch.device("cuda")
    x48 = torch.from_numpy(synth_batch(48, 400, 600, seed=5)[0]).to(dev)
    cfg0 = llt.PipelineConfig()
    hybrid = llt.PipelineConfig(method="hybrid")
    params = llt.EnhancePipeline(hybrid, device="cuda").model_params

    def k3(cfg, f32=False):
        xb, halo = pad_block(x48, cfg)
        with torch.inference_mode():
            maps = block_curve_maps(xb, cfg, params, -halo, 400, 600)
        rows = xb.shape[-2] - 2 * halo
        xb = normalize_u8(xb) if f32 else xb
        ds = kernel_maps_ds(cfg)
        return lambda: fe.fused_curve_enhance(xb, maps, cfg, halo, rows, 600,
                                              ds=ds)

    frame = torch.from_numpy(synth_batch(1, 1080, 1920, seed=11)[0]).to(dev)
    x8 = x48[:8].contiguous()

    def k4(cfg, x=frame):
        xb = tvideo.pad_video_block(x, cfg)
        halo = learned_halo(cfg)
        rows = xb.shape[-2] - 2 * halo
        carry = torch.full((x.shape[0],) + xb.shape[-2:], -1.0, device=dev)
        return lambda: fe.fused_retinex_ema(xb, carry, cfg, halo, rows,
                                            x.shape[2], 0.3)

    def gain_form(cfg):
        xb = tvideo.pad_video_block(frame, cfg)
        halo, m = learned_halo(cfg), canvas_margin(cfg)
        rows = xb.shape[-2] - 2 * halo
        gain = torch.full((1,) + xb.shape[-2:], 1.5, device=dev)
        return lambda: fe.fused_retinex_gain(xb, gain, cfg, halo, rows)

    def k3_video(cfg):
        """K3 as the video step's hybrid arm calls it: maps at 1/4 of the
        block boosted by a gain plane, and the plane."""
        xb = tvideo.pad_video_block(frame, cfg)
        halo, m = learned_halo(cfg), canvas_margin(cfg)
        rows = xb.shape[-2] - 2 * halo
        gain = torch.full((1,) + xb.shape[-2:], 1.5, device=dev)
        with torch.inference_mode():
            cnn_in = torch.clamp(normalize_u8(xb) * gain[:, None], 0.0, 1.0)
            maps = curve_maps_for_kernel(
                _mask_extent(cnn_in, -halo, 1080, 1920, m), cfg, params)
        return lambda: fe.fused_curve_enhance(xb, maps, cfg, halo, rows,
                                              1920, ds=4, gain=gain)

    def k5(cfg, x=x48):
        xb, halo = pad_block(x, cfg)
        net = llt.EnhancePipeline(cfg, device="cuda").model_params
        with torch.inference_mode():
            y = block_net_image(xb, cfg, net, -halo, *x.shape[1:3])
        rows = xb.shape[-2] - 2 * halo
        return lambda: td.tiled_denoise(y, cfg, halo, rows)

    gen = torch.Generator(device="cuda").manual_seed(21)

    def conv_params(cin, cout):
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
        return (w * (2.0 / (9 * cin)) ** 0.5,
                0.1 * torch.randn((cout,), generator=gen, device=dev))

    def act(cfg, c):
        hb, wb = pad_block(x48, cfg)[0].shape[-2:]
        return torch.rand((48, hb, wb, c), generator=gen,
                          device=dev).to(torch.bfloat16)

    def k6a():
        xs = [act(hybrid, 32) for _ in range(2)]
        w, b = conv_params(64, 32)
        return lambda: mx.conv2d_patch_mxu(xs, w, b, act="relu")

    def k6b():
        x = act(llt.PRESETS["quality_fast"], 24)
        w, b = conv_params(24, 24)
        return lambda: mx.conv2d_dense9_mxu(x, w, b, act="leaky",
                                            dilation=2)

    def k7():
        x = act(llt.PRESETS["quality_fast"], 24)
        ws, bs = zip(*[conv_params(24, 24) for _ in FCN_DILATIONS])
        return lambda: fc.fcn_cascade_mxu(x, ws, bs, FCN_DILATIONS)

    hwc_cfg = cfg0.replace(denoise_guide="perchannel", denoise_taps="full")
    x48f = normalize_u8(x48)
    x1080 = frame
    guided = dict(denoise_taps="guided")
    cases = [
        ("K1 u8 default 600x400 b48", lambda: (lambda: fe.fused_retinex(
            x48, cfg0))),
        ("K1 u8 default 1080p b1", lambda: (lambda: fe.fused_retinex(
            x1080, cfg0))),
        ("K1 f32 default 600x400 b48", lambda: (lambda: fe.fused_retinex(
            x48f, cfg0))),
        ("K8 perchannel/full 600x400 b48", lambda: (
            lambda: hw.enhance_hwc_u8(x48, hwc_cfg))),
        ("K4 default 1080p b1", lambda: k4(cfg0)),
        ("K4 default 600x400 b8", lambda: k4(cfg0, x8)),
        ("K3 hybrid ds1 600x400 b48", lambda: k3(hybrid)),
        ("K3 hybrid ds4 + gain 1080p b1",
         lambda: k3_video(hybrid.replace(curve_downsample=4))),
        ("K3 hybrid f32 ds1 600x400 b48", lambda: k3(hybrid, f32=True)),
        ("K3 curve ds2 600x400 b48",
         lambda: k3(llt.PipelineConfig(method="curve", curve_downsample=2))),
        ("K1 gain form 1080p b1", lambda: gain_form(cfg0)),
        ("K1 guided r2 luma 600x400 b48", lambda: (lambda: fe.fused_retinex(
            x48, cfg0.replace(**guided)))),
        ("K1 guided r4 luma 600x400 b48", lambda: (lambda: fe.fused_retinex(
            x48, cfg0.replace(guided_radius=4, **guided)))),
        ("K1 guided r4 perchannel 600x400 b48", lambda: (
            lambda: fe.fused_retinex(x48, cfg0.replace(
                guided_radius=4, denoise_guide="perchannel", **guided)))),
        ("K3 hybrid guided r4 600x400 b48",
         lambda: k3(hybrid.replace(guided_radius=4, **guided))),
        ("K4 guided r2 1080p b1", lambda: k4(cfg0.replace(**guided))),
        ("K4 guided r4 1080p b1", lambda: k4(cfg0.replace(guided_radius=4,
                                                          **guided))),
        ("K3 hybrid ds4 + gain guided r2 1080p b1",
         lambda: k3_video(hybrid.replace(curve_downsample=4, **guided))),
        ("K3 hybrid ds4 + gain guided r4 1080p b1",
         lambda: k3_video(hybrid.replace(curve_downsample=4, guided_radius=4,
                                         **guided))),
        ("K1 gain form guided r4 1080p b1",
         lambda: gain_form(cfg0.replace(guided_radius=4, **guided))),
        ("blur plane r16 e1 600x400 b48", lambda: (
            lambda: fe.blur_illumination(x48, cfg0.replace(
                blur_radius=16, blur_sigma=5.0), 1, hwc=True))),
        ("blur plane r32 e8 600x400 b48", lambda: (
            lambda: fe.blur_illumination(x48, cfg0.replace(
                blur_radius=32, blur_sigma=32 / 3), 8, hwc=True))),
        ("K5 quality 600x400 b48", lambda: k5(llt.PRESETS["quality"])),
        ("K5 quality_fast 600x400 b48",
         lambda: k5(llt.PRESETS["quality_fast"])),
        ("K5 quality_fast 1080p b1",
         lambda: k5(llt.PRESETS["quality_fast"], x1080)),
        ("K5 fcn perchannel/full/epan 600x400 b48",
         lambda: k5(llt.PRESETS["quality_fast"].replace(
             denoise_taps="full", denoise_guide="perchannel",
             denoise_kernel="epan"))),
        ("K6a c5 64->32 bf16 hybrid block b48", k6a),
        ("K6b c2 24->24 d2 bf16 fcn block b48", k6b),
        ("K7 c2-c7 bf16 fcn block b48", k7),
    ]
    for name, make in cases:
        try:
            fn = make()
            fn()
        except (NotImplementedError, ValueError, TypeError) as e:
            print(f"  {name}: absent ({type(e).__name__})")
            continue
        print(f"  {name}: {ms(fn):.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
