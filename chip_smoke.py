#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (low_light_image_enhancement_tpu_torch) on
one NVIDIA Hopper card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Paths driven: the default retinex config (K1), the shipped-weight hybrid
(the curve CNN and K3), and the two quality presets, ``quality`` (decom,
guided tail r=4) and ``quality_fast`` (fcn, bilateral tail), both through
the fcn/decom net and K5.

Phases (each raises on failure, so the script exits non-zero):
  1. the card: CUDA present, compute capability 9.0, name and power limit;
  2. the kernel build from the sources in the checkout (nvcc, sm_90a);
  3. each kernel (K1 fused_retinex, K3 fused_curve_enhance, K5
     tiled_denoise) against its plain PyTorch version on the card, on
     synthetic images: max |du8|, changed share and a histogram of du8;
     bar: max |du8| <= 1 and changed share < 1e-3; then each kernel's
     time beside its plain version's at 600x400 batch 48;
  4. each path through EnhancePipeline(device="cuda"): agreement with the
     CPU pipeline on a small input (float32 max |du8| bar, bf16 PSNR >= 40
     dB) and img/s at 600x400 batch 48 from CUDA events;
  4b. the two presets' PSNR/SSIM/dE76 means over the 15 synthetic eval
     pairs on the card, against the JAX package's numbers for the same
     pairs (tools/jax_eval15_reference.py): bar 0.1 dB and 0.005 SSIM;
  5. an EnhanceServer per path (retinex, hybrid, quality), 16 requests of
     two shapes from 4 threads per round, each answer equal to
     pipeline.enhance, p50/p99 latency;
  6. each path's launch counts, reset to 0 just before it runs (phases
     4-5) and read just after: every path launched its kernels.

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that lists the kernels
with their measured numbers and their bounds.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np

BAR_MAX, BAR_SHARE = 1, 1e-3

# The JAX package's quality numbers for the synthetic eval-15 set (15 pairs
# synth_pair(i, 400, 600, seed=0)), from its own evaluation on the CPU:
# tools/jax_eval15_reference.py, i.e. eval_lol(EnhancePipeline(PRESETS[name],
# force_jnp=True), max_images=15, parity=False).
JAX_EVAL15 = {
    "quality": {"psnr": 20.13423360188802, "ssim": 0.921144445737203,
                "delta_e76": 17.885644912719727},
    "quality_fast": {"psnr": 18.797438430786134, "ssim": 0.8913289864857992,
                     "delta_e76": 17.871696535746256},
}
EVAL_BAR_DB, EVAL_BAR_SSIM = 0.1, 0.005

# H100 SXM data sheet: HBM rate and the float32 rate outside the tensor
# cores. Every kernel here computes in float32 on the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


# ------------------------------------------------------------- bounds --- #
# The least time the card could take for a kernel's work: the larger of
# its bytes (each input read once, each output written once) over the HBM
# rate and its float operations over the f32 rate. Operations are counted
# per output pixel (all 3 channels) from the kernel's arithmetic, each add,
# multiply, divide, compare, min/max, exp, log and rint as one.

def _range_weight_ops(cfg) -> int:
    return 2 if cfg.denoise_kernel == "exp" else 4  # exp(-d2*k) | max(1-.)^2


def tail_ops(cfg) -> int:
    """The denoise tail and its blend by strength."""
    if cfg.denoise_strength <= 0.0:
        return 0
    wt = _range_weight_ops(cfg)
    if cfg.denoise_taps == "guided":
        box = 2 * (2 * cfg.guided_radius + 1)   # 2 passes: 2r adds, 1 mul
        if cfg.denoise_guide == "luma":
            # guide 3, box(g), box(g*g) +1, var 2, 1/(var+eps) 2; per
            # channel box(p), box(g*p) +1, cov 2, a 1, b 2, box(a), box(b),
            # q 2, blend 3
            return 3 + 2 * box + 5 + 3 * (4 * box + 11)
        # per channel: box(x), box(x*x) +1, var 2, a 2, b 2, box(a),
        # box(b), q 2, blend 3
        return 3 * (4 * box + 12)
    joint = cfg.denoise_guide == "luma"
    if cfg.denoise_taps == "sep":
        if joint:   # centre luma 3; per tap: luma 3, d 2, w, spatial 1,
            #          wacc 1, 3 channels 6; 1/wacc, 3 multiplies
            per_pass = 3 + 3 * (13 + wt) + 4
        else:       # per channel and tap: d 2, w, spatial 1, acc 2, wacc 1
            per_pass = 3 * (3 * (6 + wt) + 1)
        ops = 2 * per_pass
    elif joint:
        ops = 3 + 9 * (14 + wt) + 4
    else:
        ops = 3 * (9 * (7 + wt) + 1)
    return ops + 9


def boost_ops(cfg) -> int:
    """max RGB 2, the two blur passes, clip 2, exp((g-1)*log L) 3,
    x * gain 3 and its clip 6."""
    taps = 2 * cfg.blur_radius + 1
    return 2 + 2 * (2 * taps - 1) + 2 + 3 + 3 + 6


QUANTIZE_OPS = 18   # per channel: clip 2, *255, rint, clip 2
NORMALIZE_OPS = 3   # u8 -> f32, * 1/255


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(cfg, b, h, w):
    px = b * h * w
    ops = NORMALIZE_OPS + boost_ops(cfg) + tail_ops(cfg) + QUANTIZE_OPS
    return bound_ms(6 * px, ops * px)


def k3_bound(cfg, xb, maps, halo, rows, m):
    b, _, _, wb = xb.shape
    win = b * (rows + 2 * m) * wb
    n_iter = maps.shape[1]
    nbytes = win * (3 + n_iter * 3 * 4) + b * rows * wb * 3
    ops = (NORMALIZE_OPS + (boost_ops(cfg) if cfg.method == "hybrid" else 0)
           + n_iter * 3 * 4 + 6 + tail_ops(cfg) + QUANTIZE_OPS)
    return bound_ms(nbytes, ops * b * rows * wb)


def k5_bound(cfg, y, rows, m):
    b, _, _, wb = y.shape
    nbytes = b * (rows + 2 * m) * wb * 12 + b * rows * wb * 12
    return bound_ms(nbytes, (tail_ops(cfg) + 6) * b * rows * wb)


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
    from low_light_image_enhancement_tpu_torch.blocks import (
        block_curve_maps,
        block_net_image,
    )
    from low_light_image_enhancement_tpu_torch.config import canvas_margin
    from low_light_image_enhancement_tpu_torch.data.synth import (
        synth_batch,
        synth_pair,
    )
    from low_light_image_enhancement_tpu_torch.eval import metrics
    from low_light_image_enhancement_tpu_torch.kernels import _build
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )
    from low_light_image_enhancement_tpu_torch.kernels import (
        tiled_denoise as td,
    )
    from low_light_image_enhancement_tpu_torch.ops.colorspace import (
        quantize_u8,
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
    quality, quality_fast = llt.PRESETS["quality"], llt.PRESETS["quality_fast"]
    params = {name: llt.EnhancePipeline(c, device="cuda").model_params
              for name, c in (("hybrid", hybrid), ("curve", curve),
                              ("decom", quality), ("fcn", quality_fast))}
    wrappers = {"k1": fe.fused_retinex, "k3": fe.fused_curve_enhance,
                "k5": td.tiled_denoise}
    err = {"k1": 0, "k3": 0, "k5": 0.0}

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

    def net_case(cfg, lows_np):
        """The fcn/decom net's f32 block, halo, rows and the image size."""
        x = torch.from_numpy(lows_np).to(dev)
        _, h, w, _ = lows_np.shape
        xb, halo = pad_block(x, cfg)
        with torch.inference_mode():
            y = block_net_image(xb, cfg, params[cfg.method], -halo, h, w)
        return y, halo, xb.shape[-2] - 2 * halo, h, w

    # K5: the fcn and decom blocks under every arm of the tail; the quality
    # preset is decom with the guided tail, quality_fast fcn with luma/sep
    tails = [
        ("luma/sep/exp", dict(denoise_taps="sep", denoise_guide="luma",
                              denoise_kernel="exp")),
        ("perchannel/full/epan", dict(denoise_taps="full",
                                      denoise_guide="perchannel",
                                      denoise_kernel="epan")),
    ] + [(f"luma/guided r{r}", dict(denoise_taps="guided", guided_radius=r,
                                     denoise_guide="luma"))
         for r in (1, 2, 4, 8)] + [
        ("perchannel/guided r2", dict(denoise_taps="guided", guided_radius=2,
                                      denoise_guide="perchannel")),
    ]
    k5_cases = [(f"{base.method} {tn} {w}x{h} b{b}", base.replace(**tk),
                 (b, h, w))
                for base in (quality_fast, quality) for tn, tk in tails
                for b, h, w in ((8, 400, 600), (1, 1080, 1920))]
    k5_cases += [(f"{name} 47x33 b2", c, (2, 33, 47))
                 for name, c in (("quality_fast", quality_fast),
                                 ("quality", quality))]
    for name, cfg, (b, h, w) in k5_cases:
        y, halo, rows, h, w = net_case(cfg, synth_batch(b, h, w, seed=5)[0])
        m = canvas_margin(cfg)
        got = td.tiled_denoise(y, cfg, halo, rows)[..., :h, m:m + w]
        want = td.tiled_denoise_plain(y, cfg, halo, rows)[..., :h, m:m + w]
        err["k5"] = max(err["k5"], float((got - want).abs().max()))
        check_bar(f"K5 {name}", delta_stats(quantize_u8(got).cpu().numpy(),
                                            quantize_u8(want).cpu().numpy()))
        del y, got, want
    print(f"  K5 max |f32 delta| over the cases: {err['k5']:.3e}")
    torch.cuda.synchronize()

    # kernel-only time beside the plain version's at the main-path shape
    lows48 = synth_batch(48, 400, 600, seed=5)[0]
    x48 = torch.from_numpy(lows48).to(dev)
    cfg0 = llt.PipelineConfig()
    k1_ms, k1_plain_ms = paired_ms(
        torch, lambda: fe.fused_retinex_plain(x48, cfg0),
        lambda: fe.fused_retinex(x48, cfg0), 10)
    k1_b = k1_bound(cfg0, 48, 400, 600)
    xb, maps, halo, rows, iw, m = curve_case(hybrid, lows48)
    k3_ms, k3_plain_ms = paired_ms(
        torch,
        lambda: fe.fused_curve_enhance_plain(xb, maps, hybrid, halo, rows,
                                             iw),
        lambda: fe.fused_curve_enhance(xb, maps, hybrid, halo, rows, iw), 5)
    k3_b = k3_bound(hybrid, xb, maps, halo, rows, m)
    del xb, maps
    k5_ms = {}
    for name, cfg in (("quality", quality), ("quality_fast", quality_fast)):
        y, halo, rows, _, _ = net_case(cfg, lows48)
        k5_ms[name] = paired_ms(
            torch, lambda: td.tiled_denoise_plain(y, cfg, halo, rows),
            lambda: td.tiled_denoise(y, cfg, halo, rows), 3) + \
            (k5_bound(cfg, y, rows, canvas_margin(cfg)),)
        del y
    (k5_t, k5_plain_ms, k5_b) = k5_ms["quality"]
    print(f"  600x400 b48 on {card}: K1 {k1_ms:.3f} ms (plain "
          f"{k1_plain_ms:.3f} ms, bound {k1_b[0]:.4f} ms by {k1_b[1]}); "
          f"K3 hybrid {k3_ms:.3f} ms (plain {k3_plain_ms:.3f} ms, bound "
          f"{k3_b[0]:.4f} ms by {k3_b[1]})")
    for name, (t, tp, bd) in k5_ms.items():
        print(f"  600x400 b48 on {card}: K5 {name} block {t:.3f} ms (plain "
              f"{tp:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]})")

    # the main path: each path's launch counts, reset to 0 just before it
    # runs and read just after
    paths = [("retinex", cfg0, ("k1",)), ("hybrid", hybrid, ("k3",)),
             ("quality", quality, ("k5",)),
             ("quality_fast", quality_fast, ("k5",))]
    launches = {name: {k: 0 for k in wrappers} for name, _, _ in paths}

    def counted(name, run):
        for wr in wrappers.values():
            wr.launches = 0
        out = run()
        for k, wr in wrappers.items():
            launches[name][k] += wr.launches
        return out

    print("[4] EnhancePipeline(device='cuda')")
    small = synth_batch(2, 64, 96, seed=6)[0]

    def phase4(name, cfg):
        pipe = llt.EnhancePipeline(cfg, device="cuda")
        cpu = llt.EnhancePipeline(cfg, device="cpu",
                                  model_params=pipe.model_params)
        got, want = pipe.enhance_batch(small), cpu.enhance_batch(small)
        if got.shape != small.shape or got.dtype != np.uint8:
            raise AssertionError(f"{name}: output {got.shape} {got.dtype}")
        if cfg.method == "retinex":
            check_bar("retinex cuda vs cpu 96x64 b2", delta_stats(got, want))
        else:
            # bf16 convs round at other places in cuDNN and on the CPU
            p = psnr(got, want)
            print(f"  {name} (bf16) cuda vs cpu 96x64 b2: PSNR {p:.2f} dB")
            if p < 40.0:
                raise AssertionError(f"{name} PSNR {p:.2f} < 40 dB")
            f32 = cfg.replace(compute_dtype="float32")
            got = llt.EnhancePipeline(f32, device="cuda").enhance_batch(small)
            want = llt.EnhancePipeline(f32, device="cpu").enhance_batch(small)
            check_bar(f"{name} (f32) cuda vs cpu 96x64 b2",
                      delta_stats(got, want))
        pipe.enhance_batch(lows48)  # warm-up
        dev_ms = cuda_ms(torch, lambda: pipe.enhance_batch_device(x48), 5)
        host_ms = cuda_ms(torch, lambda: pipe.enhance_batch(lows48), 5)
        print(f"  {name} 600x400 b48 on {card}: "
              f"{48e3 / host_ms:.1f} img/s enhance_batch (host u8 in/out, "
              f"{host_ms:.2f} ms), {48e3 / dev_ms:.1f} img/s "
              f"enhance_batch_device ({dev_ms:.2f} ms)")

    for name, cfg, _ in paths:
        counted(name, lambda: phase4(name, cfg))

    print("[4b] synthetic eval-15 on the card against the JAX package's "
          "numbers (tools/jax_eval15_reference.py, CPU)")
    pairs = [synth_pair(i, 400, 600, seed=0) for i in range(15)]

    def eval15(cfg):
        pipe = llt.EnhancePipeline(cfg, device="cuda")
        vals = {"psnr": [], "ssim": [], "delta_e76": []}
        for start in range(0, 15, 5):
            lows = np.stack([lo for lo, _ in pairs[start:start + 5]])
            highs = torch.from_numpy(
                np.stack([hi for _, hi in pairs[start:start + 5]])).to(dev)
            out = torch.from_numpy(pipe.enhance_batch(lows)).to(dev)
            for key, fn in (("psnr", metrics.psnr_u8),
                            ("ssim", metrics.ssim_u8),
                            ("delta_e76", metrics.delta_e76_u8)):
                vals[key] += fn(out, highs).cpu().tolist()
        return {k: float(np.mean(v)) for k, v in vals.items()}

    for name in ("quality", "quality_fast"):
        got = counted(name, lambda: eval15(llt.PRESETS[name]))
        want = JAX_EVAL15[name]
        print(f"  {name} on {card}: PSNR {got['psnr']:.4f} dB (JAX CPU "
              f"{want['psnr']:.4f}), SSIM {got['ssim']:.5f} "
              f"({want['ssim']:.5f}), dE76 {got['delta_e76']:.4f} "
              f"({want['delta_e76']:.4f})")
        if (abs(got["psnr"] - want["psnr"]) > EVAL_BAR_DB
                or abs(got["ssim"] - want["ssim"]) > EVAL_BAR_SSIM):
            raise AssertionError(
                f"{name} eval-15 outside {EVAL_BAR_DB} dB / "
                f"{EVAL_BAR_SSIM} SSIM of the JAX package: {got} vs {want}")

    print("[5] EnhanceServer(device='cuda'), 4 threads x 4 requests")
    reqs = [synth_batch(1, 400, 600, seed=7, start=i)[0][0] for i in range(8)]
    reqs += [synth_batch(1, 480, 640, seed=7, start=i)[0][0]
             for i in range(8)]

    def phase5(name, cfg):
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
                        f"{name} server: requests {bad} differ from "
                        "pipeline.enhance")
                print(f"  {name} {rnd}: 16/16 answered, equal to "
                      f"pipeline.enhance; latency p50 "
                      f"{np.percentile(lat, 50):.2f} ms p99 "
                      f"{np.percentile(lat, 99):.2f} ms on {card}")

    for name, cfg, _ in paths[:3]:
        counted(name, lambda: phase5(name, cfg))

    print(f"[6] launches per path (phases 4-5): {launches}")
    for name, _, kernels in paths:
        if min(launches[name][k] for k in kernels) < 1:
            raise AssertionError(f"path {name} never launched one of "
                                 f"{kernels}: {launches[name]}")
    total = {k: sum(launches[name][k] for name, _, kernels in paths
                    if k in kernels) for k in wrappers}

    src = "low_light_image_enhancement_tpu_torch/kernels/csrc/"
    tpu = "low_light_image_enhancement_tpu/kernels/"

    def row(name, k, source, replaces, t, plain, bnd):
        # no single PyTorch call computes any of these functions
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": tpu + replaces, "launches": total[k],
                "max_abs_err": err[k], "ms": t, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    print(json.dumps({"kernels": [
        row("fused_retinex (K1)", "k1", "fused_enhance.cu",
            "fused_enhance.py:476", k1_ms, k1_plain_ms, k1_b),
        row("fused_curve_enhance (K3)", "k3", "fused_enhance.cu",
            "fused_enhance.py:257", k3_ms, k3_plain_ms, k3_b),
        row("tiled_denoise (K5)", "k5", "tiled_denoise.cu",
            "tiled_denoise.py:42", k5_t, k5_plain_ms, k5_b),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
