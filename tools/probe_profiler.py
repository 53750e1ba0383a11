#!/usr/bin/env python3
"""After which calls of the port does ``torch.profiler`` stop seeing the
card?

Each case runs in a process of its own: a sequence of the port's calls
(the steps below, as ``chip_smoke.py`` phases 7b and 8 make them), with a
check after the steps the case names. A check is one
``torch.profiler.profile(activities=[CPU, CUDA])`` around one K1 call
(``EnhancePipeline().enhance_batch_device`` at 600x400 b8), then one
``utils.profile_trace`` around another; it prints the CUDA events each
recorded and whether K1's kernel (``retinex_tile_kernel``) is among them.

Steps:
  prof_train  a profiler session over 2 steps of config 3's trainer at
              512x512 b16 bf16, read with key_averages (phase 7b's form);
  spatial     config 5 at 2160x3840 on 4 spatial shards of cuda:0 (8a);
  vs_k4       SpatialShardedVideoEnhancer, 4K retinex on 4 shards, the
              EMA in K4, 3 frames (8c's first case);
  vs_gain     the same with K1's gain form (8c's second);
  vs_hybrid   hybrid ds 4 at 1080p on 2 shards, f32 nets (8c's third);
  ve_k4       VideoEnhancer, 4K retinex on one device, 3 frames;
  nccl        a process group of one on nccl (initialize_distributed), an
              all_reduce, destroy_process_group (8d's form);
  nccl_kept   the same without destroy_process_group;
  gloo        a process group of one on gloo, an all_reduce, destroyed;
  empty_cache torch.cuda.empty_cache();
  sleep       2 s of sleep.

The cases ``torch_*`` use no module of the port: plain torch ops, to
tell whether torch itself loses the events. Each of 5 trials a burst runs
N in-place adds on a small tensor outside any profiler session, then one
session records one multiply; ``torch_prior`` opens and closes one
profiler session first, ``torch_fresh`` does not. Each prints, for each N,
the trials whose session held the launch call but no kernel event.

Prints torch's, CUDA's and the driver's versions, then a line a check:
``<case> after <step>: profiler <n> CUDA events (K1 yes/no); profile_trace
<n> (K1 yes/no | raised: ...)``. Needs a CUDA card; run from the
repository root:

    python3 tools/probe_profiler.py [case ...]
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# case -> its steps; a check runs at each "check" and at the case's end
CASES = {
    "fresh": [],
    "fresh_three_checks": ["check", "check"],
    "prof_train": ["prof_train"],
    "spatial": ["spatial"],
    "vs_k4": ["vs_k4"],
    "vs_gain": ["vs_gain"],
    "vs_hybrid": ["vs_hybrid"],
    "ve_k4": ["ve_k4"],
    "nccl": ["nccl"],
    "nccl_kept": ["nccl_kept"],
    "gloo": ["gloo"],
    # chip_smoke.py's order, checked after each step
    "sequence": ["prof_train", "check", "spatial", "check", "vs_k4",
                 "check", "vs_gain", "check", "vs_hybrid", "check", "nccl"],
    # the prefix after which a check saw nothing, then checks in a row
    "prefix": ["prof_train", "spatial", "vs_k4", "check", "check"],
    "prefix_again": ["prof_train", "spatial", "vs_k4", "check", "check"],
    "prefix_empty_cache": ["prof_train", "spatial", "vs_k4", "empty_cache",
                           "check", "check"],
    "prefix_sleep": ["prof_train", "spatial", "vs_k4", "sleep", "check"],
    "spatial_vs_k4": ["spatial", "vs_k4"],
    "prof_train_vs_k4": ["prof_train", "vs_k4"],
    "vs_k4_twice": ["vs_k4", "vs_k4"],
    # plain torch, no module of the port
    "torch_fresh": [],
    "torch_prior": [],
}


def _steps(torch):
    from low_light_image_enhancement_tpu_torch import train as tt
    from low_light_image_enhancement_tpu_torch.config import (
        PRESETS,
        PipelineConfig,
    )
    from low_light_image_enhancement_tpu_torch.data.synth_device import (
        synth_batch_iter,
        synth_pair_batch,
    )
    from low_light_image_enhancement_tpu_torch.ops.colorspace import (
        quantize_u8,
    )
    from low_light_image_enhancement_tpu_torch.parallel import (
        SpatialShardedVideoEnhancer,
        enhance_spatial_sharded,
        make_mesh,
    )
    from low_light_image_enhancement_tpu_torch.parallel.distributed import (
        initialize_distributed,
    )
    from low_light_image_enhancement_tpu_torch.video import VideoEnhancer

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    mesh = lambda ns: make_mesh(1, ns, [dev] * ns)

    def frames(n, h, w, seed):
        low, _ = synth_pair_batch(gen.manual_seed(seed), n, h, w, dev)
        return list(quantize_u8(low).permute(0, 2, 3, 1).contiguous().cpu()
                    .numpy())

    def prof_train():
        tcfg = tt.TrainConfig(batch_size=16)
        batch = next(synth_batch_iter(16, 512, 512, seed=3))[0]
        params, opt = tt.init_train_state(tcfg, seed=0)
        step = tt.make_train_step(tcfg)
        step(params, opt, batch)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(2):
                step(params, opt, batch)
            torch.cuda.synchronize()
        n = sum(1 for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA"))
        return f"its own session saw {n} CUDA kernels by name"

    def spatial():
        low, _ = synth_pair_batch(gen.manual_seed(10), 1, 2160, 3840, dev)
        enhance_spatial_sharded(quantize_u8(low),
                                PRESETS["config5_4k_sharded"], mesh(4))

    def video(cls_args, cfg, eik, size):
        def run():
            enh = cls_args(cfg, eik)
            for f in frames(3, *size, seed=11):
                enh.process(f)
        return run

    def process_group(backend, destroy):
        def run():
            import socket

            import torch.distributed as dist

            with socket.socket() as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            initialize_distributed(f"localhost:{port}", num_processes=1,
                                   process_id=0, device="cuda",
                                   backend=backend)
            t = torch.ones(4, device=dev)
            dist.all_reduce(t)
            torch.cuda.synchronize()
            if destroy:
                dist.destroy_process_group()
        return run

    sharded = lambda ns: lambda cfg, eik: SpatialShardedVideoEnhancer(
        mesh(ns), cfg, alpha=0.3, device="cuda", ema_in_kernel=eik)
    single = lambda cfg, eik: VideoEnhancer(cfg, alpha=0.3, device="cuda",
                                            ema_in_kernel=eik)
    hybrid = PipelineConfig(method="hybrid", curve_downsample=4,
                            compute_dtype="float32")
    return {
        "prof_train": prof_train,
        "spatial": spatial,
        "vs_k4": video(sharded(4), PipelineConfig(), True, (2160, 3840)),
        "vs_gain": video(sharded(4), PipelineConfig(), False, (2160, 3840)),
        "vs_hybrid": video(sharded(2), hybrid, True, (1080, 1920)),
        "ve_k4": video(single, PipelineConfig(), True, (2160, 3840)),
        "nccl": process_group("nccl", True),
        "nccl_kept": process_group("nccl", False),
        "gloo": process_group("gloo", True),
        "empty_cache": torch.cuda.empty_cache,
        "sleep": lambda: __import__("time").sleep(2.0),
    }


def _check(torch, case, after):
    from low_light_image_enhancement_tpu_torch.config import PipelineConfig
    from low_light_image_enhancement_tpu_torch.pipeline import (
        EnhancePipeline,
    )
    from low_light_image_enhancement_tpu_torch.utils import profile_trace

    dev = torch.device("cuda", 0)
    x = torch.randint(0, 80, (8, 400, 600, 3), dtype=torch.uint8,
                      device=dev,
                      generator=torch.Generator(device=dev).manual_seed(22))
    pipe = EnhancePipeline(PipelineConfig(), device="cuda")
    pipe.enhance_batch_device(x)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pipe.enhance_batch_device(x)
        torch.cuda.synchronize()
    cuda = [e.name for e in prof.events()
            if str(e.device_type).endswith("CUDA")]
    launches = sum(1 for e in prof.events() if "LaunchKernel" in e.name)
    k1 = any("retinex_tile_kernel" in n for n in cuda)
    free, total = torch.cuda.mem_get_info()
    line = (f"{case} after {after}: profiler {len(cuda)} CUDA events "
            f"(K1 {'yes' if k1 else 'no'}), {launches} launch calls, "
            f"{len(list(prof.events()))} events; reserved "
            f"{torch.cuda.memory_reserved() / 2**30:.2f} GiB, free "
            f"{free / 2**30:.2f} of {total / 2**30:.2f}; ")
    with tempfile.TemporaryDirectory() as tmp:
        try:
            with profile_trace(tmp):
                pipe.enhance_batch_device(x)
                torch.cuda.synchronize()
            ev = json.loads(next(Path(tmp).glob("*.json")).read_text())[
                "traceEvents"]
            kern = [e for e in ev if e.get("cat") == "kernel"]
            k1t = any("retinex_tile_kernel" in e.get("name", "")
                      for e in kern)
            line += (f"profile_trace {len(kern)} kernel events (K1 "
                     f"{'yes' if k1t else 'no'})")
        except RuntimeError as e:
            line += f"profile_trace raised: {str(e)[:160]}"
    print(line, flush=True)


BURSTS = (0, 10_000, 100_000, 300_000)


def torch_repro(prior: bool) -> None:
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    x = torch.zeros(1024, device="cuda")
    if prior:
        with torch.profiler.profile(activities=acts):
            for _ in range(100):
                x.add_(1.0)
            torch.cuda.synchronize()
    for n in BURSTS:
        missed = []
        for trial in range(5):
            for _ in range(n):
                x.add_(1.0)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                y = x * 2.0
                torch.cuda.synchronize()
            ev = list(prof.events())
            kern = sum(1 for e in ev if str(e.device_type).endswith("CUDA"))
            calls = sum(1 for e in ev if "LaunchKernel" in e.name)
            if calls and not kern:
                missed.append(trial)
            del y
        print(f"torch_{'prior' if prior else 'fresh'} burst {n}: "
              f"{len(missed)} of 5 sessions held the launch and no kernel "
              f"{missed}", flush=True)


def child(case: str) -> None:
    import torch

    if case.startswith("torch_"):
        torch_repro(case == "torch_prior")
        return
    steps = _steps(torch)
    done = "nothing"
    for step in CASES[case]:
        if step == "check":
            _check(torch, case, done)
            continue
        note = steps[step]()
        done = step if done == "nothing" else f"{done}, {step}"
        if note:
            print(f"{case} {step}: {note}", flush=True)
    _check(torch, case, done)


def main(argv) -> int:
    if argv[:1] == ["--child"]:
        child(argv[1])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_profiler: no CUDA card", file=sys.stderr)
        return 1
    from low_light_image_enhancement_tpu_torch.kernels import _build

    cases = argv or list(CASES)
    if any(not c.startswith("torch_") for c in cases):
        _build.load_library()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,driver_version",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"kineto {torch.autograd.kineto_available()}; {smi.strip()}",
          flush=True)
    rc = 0
    for case in cases:
        proc = subprocess.run([sys.executable, __file__, "--child", case],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=400, env=dict(os.environ))
        print(proc.stdout, end="", flush=True)
        notes = [ln for ln in proc.stderr.splitlines()
                 if any(w in ln for w in ("CUPTI", "kineto", "Kineto",
                                          "WARNING", "Warning"))]
        for ln in notes[:12]:
            print(f"  {case} stderr: {ln[:200]}", flush=True)
        if proc.returncode:
            rc = 1
            print(f"{case}: rc {proc.returncode}: {proc.stderr[-1500:]}",
                  flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
