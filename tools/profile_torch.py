#!/usr/bin/env python3
"""Where the device time of the PyTorch/CUDA port goes, by kernel.

For each named path, ``EnhancePipeline(device="cuda").enhance_batch_device``
runs at 600x400 batch 48 (synthetic LOL-shaped images) under
``torch.profiler`` for a few calls after a warm-up. It prints, per call,
the wall time, the device-busy time (the sum of the CUDA kernels' and
copies' own device times), the idle share (1 - busy / wall), and the
kernels that take the most device time with their shares. Needs a CUDA
card; run from the repository root:

    python3 tools/profile_torch.py [quality quality_fast retinex hybrid]
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

PATHS = {
    "retinex": llt.PipelineConfig(),
    "hybrid": llt.PipelineConfig(method="hybrid"),
    "quality": llt.PRESETS["quality"],
    "quality_fast": llt.PRESETS["quality_fast"],
}
CALLS, TOP = 3, 12


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def profile(name: str, x: torch.Tensor) -> None:
    pipe = llt.EnhancePipeline(PATHS[name], device="cuda")
    for _ in range(2):
        pipe.enhance_batch_device(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(CALLS):
            pipe.enhance_batch_device(x)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / CALLS
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3 / CALLS
    print(f"{name}: 600x400 b{x.shape[0]}, {CALLS} calls: wall "
          f"{wall_ms:.3f} ms/call, device busy {busy_ms:.3f} ms/call, idle "
          f"share {max(0.0, 1.0 - busy_ms / wall_ms):.3f}")
    kernels.sort(key=_device_us, reverse=True)
    for e in kernels[:TOP]:
        ms = _device_us(e) / 1e3 / CALLS
        print(f"  {ms:9.3f} ms/call {ms / busy_ms:6.1%} "
              f"x{e.count // CALLS:<4d} {e.key[:110]}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("profile_torch: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    x = torch.from_numpy(synth_batch(48, 400, 600, seed=5)[0]).cuda()
    print(torch.cuda.get_device_name(0), torch.__version__)
    for name in argv or list(PATHS):
        profile(name, x)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
