#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (low_light_image_enhancement_tpu_torch) on
one NVIDIA Hopper card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Phases (each raises on failure, so the script exits non-zero):
  1. the card: CUDA present, compute capability 9.0, name and power limit;
  2. the kernel build from the sources in the checkout (nvcc, sm_90a);
  3. each kernel (K1 fused_retinex, K3 fused_curve_enhance) against its
     plain PyTorch version on the card, on synthetic images: max |du8|,
     changed share and a histogram of du8; bar: max |du8| <= 1 and changed
     share < 1e-3;
  4. the main path through EnhancePipeline(device="cuda") for the default
     retinex config and the shipped-weight hybrid: agreement with the CPU
     pipeline on a small input, img/s at 600x400 batch 48 from CUDA
     events, and each kernel's time beside its plain version's there;
  5. an EnhanceServer per config, 16 requests of two shapes from 4 threads
     per round, each answer equal to pipeline.enhance, p50/p99 latency;
  6. both kernels' launch counts over phases 4-5 are above 0.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their measured numbers.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

BAR_MAX, BAR_SHARE = 1, 1e-3


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def delta_stats(got: np.ndarray, want: np.ndarray) -> dict:
    d = got.astype(np.int32) - want.astype(np.int32)
    vals, counts = np.unique(d, return_counts=True)
    return {"max_abs": int(np.abs(d).max()),
            "changed_share": float((d != 0).mean()),
            "hist": {int(v): int(c) for v, c in zip(vals, counts)}}


def check_bar(what: str, st: dict) -> None:
    print(f"  {what}: max|du8|={st['max_abs']} "
          f"changed={st['changed_share']:.3e} hist={st['hist']}")
    if st["max_abs"] > BAR_MAX or st["changed_share"] >= BAR_SHARE:
        raise AssertionError(f"{what} outside max|du8|<={BAR_MAX}, "
                             f"share<{BAR_SHARE}: {st}")


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float("inf") if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)


def cuda_ms(torch, fn, iters: int) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(torch, plain, kernel, iters: int):
    """(kernel ms, plain ms), timed in turns plain, kernel, kernel, plain."""
    p0 = cuda_ms(torch, plain, iters)
    k0 = cuda_ms(torch, kernel, iters)
    k1 = cuda_ms(torch, kernel, iters)
    p1 = cuda_ms(torch, plain, iters)
    return (k0 + k1) / 2, (p0 + p1) / 2


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        print(f"chip_smoke: needs compute capability 9.0, got {cap}",
              file=sys.stderr)
        return 1

    import low_light_image_enhancement_tpu_torch as llt
    from low_light_image_enhancement_tpu_torch.blocks import block_curve_maps
    from low_light_image_enhancement_tpu_torch.config import canvas_margin
    from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
    from low_light_image_enhancement_tpu_torch.kernels import _build
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )
    from low_light_image_enhancement_tpu_torch.pipeline import pad_block

    # float32 convs in full float32 (cuDNN would use TF32 by default); the
    # default bf16 compute dtype is unaffected
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[1] card: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | capability {cap} | TF32 off (cudnn, "
          "matmul)")

    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    print(f"[2] kernel build: {time.perf_counter() - t0:.2f} s -> "
          f"{lib_path.name}")

    dev = torch.device("cuda")
    hybrid, curve = (llt.PipelineConfig(method="hybrid"),
                     llt.PipelineConfig(method="curve"))
    params = {c.method: llt.EnhancePipeline(c, device="cuda").model_params
              for c in (hybrid, curve)}
    err = {"k1": 0, "k3": 0}

    print("[3] kernels against their plain versions on the card")
    k1_cases = [
        ("default 600x400 b8", llt.PipelineConfig(), (8, 400, 600)),
        ("default 1080p b1", llt.PipelineConfig(), (1, 1080, 1920)),
        ("default 33x47 b2", llt.PipelineConfig(), (2, 33, 47)),
        ("perchannel/full 600x400 b8",
         llt.PipelineConfig(denoise_guide="perchannel", denoise_taps="full"),
         (8, 400, 600)),
        ("perchannel/sep/epan 600x400 b2",
         llt.PipelineConfig(denoise_guide="perchannel",
                            denoise_kernel="epan"), (2, 400, 600)),
        ("luma/full strength 0.5 600x400 b2",
         llt.PipelineConfig(denoise_taps="full", denoise_strength=0.5),
         (2, 400, 600)),
        ("strength 0 600x400 b2", llt.PipelineConfig(denoise_strength=0.0),
         (2, 400, 600)),
        # edges of the tiling: images smaller than one tile, and the
        # smallest and largest blur radius the kernel's halo takes
        ("1x1 b1", llt.PipelineConfig(), (1, 1, 1)),
        ("17x5 b3", llt.PipelineConfig(), (3, 5, 17)),
        ("blur r1 101x67 b2", llt.PipelineConfig(blur_radius=1),
         (2, 67, 101)),
        ("blur r8 101x67 b2",
         llt.PipelineConfig(blur_radius=8, blur_sigma=3.0), (2, 67, 101)),
    ]
    for name, cfg, (b, h, w) in k1_cases:
        x = torch.from_numpy(synth_batch(b, h, w, seed=3)[0]).to(dev)
        got = fe.fused_retinex(x, cfg).cpu().numpy()
        want = fe.fused_retinex_plain(x, cfg).cpu().numpy()
        st = delta_stats(got, want)
        check_bar(f"K1 {name}", st)
        err["k1"] = max(err["k1"], st["max_abs"])

    def curve_case(cfg, lows_np):
        """u8 block, maps, halo, rows and the consumed columns of a batch."""
        x = torch.from_numpy(lows_np).to(dev)
        _, h, w, _ = lows_np.shape
        xb, halo = pad_block(x, cfg)
        with torch.inference_mode():
            maps = block_curve_maps(xb, cfg, params[cfg.method], -halo, h, w)
        m = canvas_margin(cfg)
        return xb, maps, halo, xb.shape[-2] - 2 * halo, w, m

    k3_cases = [(f"{c.method} {w}x{h} b{b}", c, (b, h, w))
                for c in (hybrid, curve)
                for b, h, w in ((8, 400, 600), (1, 1080, 1920), (2, 33, 47))]
    k3_cases += [
        ("hybrid perchannel/full 600x400 b2",
         hybrid.replace(denoise_guide="perchannel", denoise_taps="full"),
         (2, 400, 600)),
        ("hybrid blur r8 101x67 b2",
         hybrid.replace(blur_radius=8, blur_sigma=3.0), (2, 67, 101)),
    ]
    for name, cfg, (b, h, w) in k3_cases:
        xb, maps, halo, rows, iw, m = curve_case(
            cfg, synth_batch(b, h, w, seed=4)[0])
        got = fe.fused_curve_enhance(xb, maps, cfg, halo, rows, iw)
        want = fe.fused_curve_enhance_plain(xb, maps, cfg, halo, rows, iw)
        st = delta_stats(got[..., :h, m:m + iw].cpu().numpy(),
                         want[..., :h, m:m + iw].cpu().numpy())
        check_bar(f"K3 {name}", st)
        err["k3"] = max(err["k3"], st["max_abs"])
    torch.cuda.synchronize()

    # kernel-only time beside the plain version's at the main-path shape
    lows48 = synth_batch(48, 400, 600, seed=5)[0]
    x48 = torch.from_numpy(lows48).to(dev)
    cfg0 = llt.PipelineConfig()
    k1_ms, k1_plain_ms = paired_ms(
        torch, lambda: fe.fused_retinex_plain(x48, cfg0),
        lambda: fe.fused_retinex(x48, cfg0), 10)
    xb, maps, halo, rows, iw, _ = curve_case(hybrid, lows48)
    k3_ms, k3_plain_ms = paired_ms(
        torch,
        lambda: fe.fused_curve_enhance_plain(xb, maps, hybrid, halo, rows,
                                             iw),
        lambda: fe.fused_curve_enhance(xb, maps, hybrid, halo, rows, iw), 5)
    del xb, maps
    print(f"  600x400 b48 on {card}: K1 {k1_ms:.3f} ms (plain "
          f"{k1_plain_ms:.3f} ms); K3 hybrid {k3_ms:.3f} ms (plain "
          f"{k3_plain_ms:.3f} ms)")

    # the main path: launch counts from here on
    fe.fused_retinex.launches = 0
    fe.fused_curve_enhance.launches = 0

    print("[4] EnhancePipeline(device='cuda')")
    small = synth_batch(2, 64, 96, seed=6)[0]
    for cfg in (llt.PipelineConfig(), hybrid):
        pipe = llt.EnhancePipeline(cfg, device="cuda")
        cpu = llt.EnhancePipeline(cfg, device="cpu",
                                  model_params=pipe.model_params)
        got, want = pipe.enhance_batch(small), cpu.enhance_batch(small)
        if got.shape != small.shape or got.dtype != np.uint8:
            raise AssertionError(f"{cfg.method}: output {got.shape} "
                                 f"{got.dtype}")
        if cfg.method == "retinex":
            check_bar("retinex cuda vs cpu 96x64 b2", delta_stats(got, want))
        else:
            # bf16 convs round at other places in cuDNN and on the CPU
            p = psnr(got, want)
            print(f"  hybrid (bf16) cuda vs cpu 96x64 b2: PSNR {p:.2f} dB")
            if p < 40.0:
                raise AssertionError(f"hybrid PSNR {p:.2f} < 40 dB")
            f32 = cfg.replace(compute_dtype="float32")
            got = llt.EnhancePipeline(f32, device="cuda").enhance_batch(small)
            want = llt.EnhancePipeline(f32, device="cpu").enhance_batch(small)
            check_bar("hybrid (f32) cuda vs cpu 96x64 b2",
                      delta_stats(got, want))
        pipe.enhance_batch(lows48)  # warm-up
        dev_ms = cuda_ms(torch, lambda: pipe.enhance_batch_device(x48), 5)
        host_ms = cuda_ms(torch, lambda: pipe.enhance_batch(lows48), 5)
        print(f"  {cfg.method} 600x400 b48 on {card}: "
              f"{48e3 / host_ms:.1f} img/s enhance_batch (host u8 in/out, "
              f"{host_ms:.2f} ms), {48e3 / dev_ms:.1f} img/s "
              f"enhance_batch_device ({dev_ms:.2f} ms)")

    print("[5] EnhanceServer(device='cuda'), 4 threads x 4 requests")
    reqs = [synth_batch(1, 400, 600, seed=7, start=i)[0][0] for i in range(8)]
    reqs += [synth_batch(1, 480, 640, seed=7, start=i)[0][0]
             for i in range(8)]
    for cfg in (llt.PipelineConfig(), hybrid):
        ref = llt.EnhancePipeline(cfg, device="cuda", bucket=64)
        want = [ref.enhance(img) for img in reqs]
        with llt.EnhanceServer(cfg, device="cuda") as server:
            for rnd in ("warm-up", "measured"):
                lat = [0.0] * len(reqs)
                got = [None] * len(reqs)

                def client(ids):
                    for i in ids:
                        t = time.perf_counter()
                        got[i] = server.submit(reqs[i]).result(timeout=300)
                        lat[i] = (time.perf_counter() - t) * 1e3

                threads = [threading.Thread(target=client,
                                            args=(range(k, 16, 4),))
                           for k in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                    if t.is_alive():
                        raise AssertionError("server client thread hung")
                bad = [i for i in range(16) if got[i] is None
                       or not np.array_equal(got[i], want[i])]
                if bad:
                    raise AssertionError(
                        f"{cfg.method} server: requests {bad} differ from "
                        "pipeline.enhance")
                print(f"  {cfg.method} {rnd}: 16/16 answered, equal to "
                      f"pipeline.enhance; latency p50 "
                      f"{np.percentile(lat, 50):.2f} ms p99 "
                      f"{np.percentile(lat, 99):.2f} ms on {card}")

    launches = {"k1": fe.fused_retinex.launches,
                "k3": fe.fused_curve_enhance.launches}
    print(f"[6] launches on the main path (phases 4-5): {launches}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never ran: "
                             f"{launches}")

    src = "low_light_image_enhancement_tpu_torch/kernels/csrc/fused_enhance.cu"
    tpu = "low_light_image_enhancement_tpu/kernels/fused_enhance.py"
    print(json.dumps({"kernels": [
        {"name": "fused_retinex (K1)", "route": "cuda", "source": src,
         "replaces": f"{tpu}:476", "launches": launches["k1"],
         "max_abs_err": err["k1"], "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "fused_curve_enhance (K3)", "route": "cuda", "source": src,
         "replaces": f"{tpu}:257", "launches": launches["k3"],
         "max_abs_err": err["k3"], "ms": k3_ms, "plain_ms": k3_plain_ms},
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
