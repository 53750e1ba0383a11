#!/usr/bin/env python3
"""Device times of K1, K3 and K4 on the card, for an A/B of two versions.

Times (CUDA events, the calls queued behind a spin so that the device
alone is timed, the mean of two rounds of ``ITERS`` calls) of the default
forms the main paths run: K1 ``fused_retinex`` on 600x400 b48 u8 (the
default config), K3 ``fused_curve_enhance`` on hybrid's 600x400 b48 block
(maps at 1/1, the shipped weights), K4 ``fused_retinex_ema`` on a 1080p
frame; then, where the tree has them, the guided forms of each (K1 at r 2
and 4 with the luma guide and r 4 per channel, K3 hybrid at r 4, K4 at
r 2, K1's gain form at r 4). A form the tree does not have prints
"absent".

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
    block_curve_maps,
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
    fused_enhance as fe,
)
from low_light_image_enhancement_tpu_torch.pipeline import (  # noqa: E402
    pad_block,
)

ITERS = 20
SPIN_CYCLES = 50_000_000


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

    def k3(cfg):
        xb, halo = pad_block(x48, cfg)
        with torch.inference_mode():
            maps = block_curve_maps(xb, cfg, params, -halo, 400, 600)
        rows = xb.shape[-2] - 2 * halo
        return lambda: fe.fused_curve_enhance(xb, maps, cfg, halo, rows, 600)

    frame = torch.from_numpy(synth_batch(1, 1080, 1920, seed=11)[0]).to(dev)

    def k4(cfg):
        xb = tvideo.pad_video_block(frame, cfg)
        halo = learned_halo(cfg)
        rows = xb.shape[-2] - 2 * halo
        carry = torch.full((1,) + xb.shape[-2:], -1.0, device=dev)
        return lambda: fe.fused_retinex_ema(xb, carry, cfg, halo, rows, 1920,
                                            0.3)

    def gain_form(cfg):
        xb = tvideo.pad_video_block(frame, cfg)
        halo, m = learned_halo(cfg), canvas_margin(cfg)
        rows = xb.shape[-2] - 2 * halo
        gain = torch.full((1,) + xb.shape[-2:], 1.5, device=dev)
        return lambda: fe.fused_retinex_gain(xb, gain, cfg, halo, rows)

    guided = dict(denoise_taps="guided")
    cases = [
        ("K1 u8 default 600x400 b48", lambda: (lambda: fe.fused_retinex(
            x48, cfg0))),
        ("K3 hybrid ds1 600x400 b48", lambda: k3(hybrid)),
        ("K4 default 1080p b1", lambda: k4(cfg0)),
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
        ("K1 gain form guided r4 1080p b1",
         lambda: gain_form(cfg0.replace(guided_radius=4, **guided))),
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
