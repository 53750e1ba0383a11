#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (low_light_image_enhancement_tpu_torch) on
one NVIDIA Hopper card and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.

Paths driven: the default retinex config (K1), the shipped-weight hybrid
(the curve CNN and K3), the two quality presets, ``quality`` (decom,
guided tail r=4) and ``quality_fast`` (fcn, bilateral tail), both through
the fcn/decom net and K5, and the four arms of the 1080p video benchmark
(the JAX package's bench config 7): retinex as K4, retinex through K1's
gain form, curve and hybrid at curve_downsample 4 through K3 with low-res
maps (hybrid also with the gain plane).

Phases (each raises on failure, so the script exits non-zero):
  1. the card: CUDA present, compute capability 9.0, name and power limit;
  2. the kernel build from the sources in the checkout (nvcc, sm_90a);
  3. each kernel (K1 fused_retinex and its gain form, K3
     fused_curve_enhance with maps at 1/1, 1/2, 1/4 and with the gain
     plane, K4 fused_retinex_ema over chained frames, K5 tiled_denoise)
     against its plain PyTorch version on the card, on synthetic images:
     max |du8|, changed share and a histogram of du8; bar: max |du8| <= 1
     and changed share < 1e-3 (K4's new carry: max |df32| <= 1e-6 on the
     image's columns; K3 also on the video step's blocks, 1080p b8 among
     them); then each kernel's time beside its plain version's at 600x400
     batch 48, and the video forms' at 1080p b1 and 600x400 b8, twice;
     times are of the device alone, the calls queued behind a spin;
  4. each path through EnhancePipeline(device="cuda"), and stateless curve
     ds 2 and hybrid ds 4 and 8: agreement with the CPU pipeline on a small
     input (float32 max |du8| bar, bf16 PSNR >= 40 dB) and img/s at
     600x400 batch 48 from CUDA events;
  4b. the two presets' PSNR/SSIM/dE76 means over the 15 synthetic eval
     pairs on the card, against the JAX package's numbers for the same
     pairs (tools/jax_eval15_reference.py): bar 0.1 dB and 0.005 SSIM;
  4c. each video arm through VideoEnhancer(device="cuda"): agreement with
     device="cpu" over 4 frames at 96x64 with a reset (float32 max |du8|
     bar, bf16 PSNR >= 40 dB), the 1080p frame rate of the step chained on
     the card with its state fed forward (CUDA events), and for curve and
     hybrid MultiStreamVideoEnhancer(8)'s summed rate and whether a
     stream's output equals its lone output on the card;
  5. an EnhanceServer per path (retinex, hybrid, quality), 16 requests of
     two shapes from 4 threads per round, each answer equal to
     pipeline.enhance, p50/p99 latency;
  6. each path's launch counts, reset to 0 just before it runs (phases
     4-5, 4c) and read just after: every path launched its kernels, and
     the retinex video path launched K4 and no K1.

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


# ~25 ms of spinning at the H100's clock: long enough for the host to
# queue every timed call of a kernel behind it
PREFILL_CYCLES = 50_000_000


def cuda_ms(torch, fn, iters: int, prefill: bool = False) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, CUDA events. With
    ``prefill`` the card spins first, so that the host has queued all the
    calls before the first one runs and the events time the device alone:
    a kernel shorter than the wrapper's host path (about a tenth of a ms)
    is timed otherwise by the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(PREFILL_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def paired_ms(torch, plain, kernel, iters: int):
    """(kernel ms, plain ms) of the device alone, timed in turns plain,
    kernel, kernel, plain."""
    p0 = cuda_ms(torch, plain, iters, prefill=True)
    k0 = cuda_ms(torch, kernel, iters, prefill=True)
    k1 = cuda_ms(torch, kernel, iters, prefill=True)
    p1 = cuda_ms(torch, plain, iters, prefill=True)
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


GAIN_OPS = 9        # x * gain 3 and its clip 6


def upsample_ops(ds: int) -> float:
    """Operations per full-resolution map value of the upsample of record:
    the column blend lo * (1 - f) + hi * f (2 multiplies, 1 add) at the
    low-res rows, shared by the ds full-res rows under each, then the row
    blend (3): 3 / ds + 3. ds 1 has no upsample."""
    return 0.0 if ds == 1 else 3.0 / ds + 3.0


def k3_bound(cfg, xb, maps, halo, rows, m, ds=1, gain=False):
    """Maps at 1/ds are read once (n_iter * 3 * 4 / ds^2 bytes a pixel);
    each full-resolution map value then costs the upsample's operations
    (``upsample_ops``) besides the curve step's 4."""
    b, _, _, wb = xb.shape
    win = b * (rows + 2 * m) * wb
    n_iter = maps.shape[1]
    nbytes = (win * (3 + n_iter * 3 * 4 / (ds * ds) + (4 if gain else 0))
              + b * rows * wb * 3)
    pre = GAIN_OPS if gain else (
        boost_ops(cfg) if cfg.method == "hybrid" else 0)
    ops = (NORMALIZE_OPS + pre + n_iter * 3 * (4 + upsample_ops(ds)) + 6
           + tail_ops(cfg) + QUANTIZE_OPS)
    return bound_ms(nbytes, ops * b * rows * wb)


def k1_gain_bound(cfg, b, rows, m, wb):
    """K1's gain form: the u8 window and its gain plane in, u8 rows out."""
    win = b * (rows + 2 * m) * wb
    ops = NORMALIZE_OPS + GAIN_OPS + tail_ops(cfg) + QUANTIZE_OPS
    return bound_ms(win * 7 + b * rows * wb * 3, ops * b * rows * wb)


def k4_bound(cfg, b, hb, wb, rows, m):
    """K4: over the band [m, HB - m) it reads u8 RGB and the carry (7 bytes
    a pixel) and computes max RGB 2, the blur, the EMA 4 (compare, two
    multiplies, add) and the gain 9 (two clips, two logs, multiply,
    subtract, exp); it writes the new carry over the block (4 bytes) and
    the u8 rows (3 bytes) with their x * gain, tail and quantize."""
    band = b * (hb - 2 * m) * wb
    taps = 2 * cfg.blur_radius + 1
    per_band = NORMALIZE_OPS + 2 + 2 * (2 * taps - 1) + 4 + 9
    per_out = GAIN_OPS + tail_ops(cfg) + QUANTIZE_OPS
    nbytes = band * 7 + b * hb * wb * 4 + b * rows * wb * 3
    return bound_ms(nbytes, band * per_band + b * rows * wb * per_out)


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
    from low_light_image_enhancement_tpu_torch import video as tvideo
    from low_light_image_enhancement_tpu_torch.blocks import (
        _mask_extent,
        block_curve_maps,
        block_net_image,
        curve_maps_for_kernel,
        kernel_maps_ds,
        learned_halo,
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
        normalize_u8,
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
    cfg0 = llt.PipelineConfig()
    hybrid, curve = (llt.PipelineConfig(method="hybrid"),
                     llt.PipelineConfig(method="curve"))
    quality, quality_fast = llt.PRESETS["quality"], llt.PRESETS["quality_fast"]
    params = {name: llt.EnhancePipeline(c, device="cuda").model_params
              for name, c in (("hybrid", hybrid), ("curve", curve),
                              ("decom", quality), ("fcn", quality_fast))}
    wrappers = {"k1": fe.fused_retinex, "k3": fe.fused_curve_enhance,
                "k4": fe.fused_retinex_ema, "k5": td.tiled_denoise}
    err = {"k1": 0, "k3": 0, "k4": 0, "k5": 0.0}

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

    # K3 with maps at 1/2 and 1/4 (upsampled in the kernel)
    k3_ds_cases = [(f"{c.method} ds{ds} {w}x{h} b{b}",
                    c.replace(curve_downsample=ds), (b, h, w))
                   for c in (curve, hybrid) for ds in (2, 4)
                   for b, h, w in ((8, 400, 600), (1, 1080, 1920))]
    for name, cfg, (b, h, w) in k3_ds_cases:
        xb, maps, halo, rows, iw, m = curve_case(
            cfg, synth_batch(b, h, w, seed=4)[0])
        ds = kernel_maps_ds(cfg)
        got = fe.fused_curve_enhance(xb, maps, cfg, halo, rows, iw, ds=ds)
        want = fe.fused_curve_enhance_plain(xb, maps, cfg, halo, rows, iw, ds)
        st = delta_stats(got[..., :h, m:m + iw].cpu().numpy(),
                         want[..., :h, m:m + iw].cpu().numpy())
        check_bar(f"K3 {name}", st)
        err["k3"] = max(err["k3"], st["max_abs"])
        del xb, maps, got, want

    def frames_of(base, t):
        """Frame t of a synthetic clip: the scene under a flickering
        exposure."""
        return np.clip(base.astype(np.int16) * (8 + (t % 3)) // 9, 0,
                       255).astype(np.uint8)

    def video_case(cfg, lows_np):
        """The video step's u8 block (learned_halo rows), the gain plane of
        a first frame, the first frame's maps (curve: on the block; hybrid:
        on the block boosted by that gain), halo, rows, the image width and
        the margin."""
        x = torch.from_numpy(lows_np).to(dev)
        b, h, w, _ = lows_np.shape
        xb = tvideo.pad_video_block(x, cfg)
        halo, m = learned_halo(cfg), canvas_margin(cfg)
        flag = torch.zeros((b,), dtype=torch.bool, device=dev)
        with torch.no_grad():
            xf = normalize_u8(xb)
            gain, _ = tvideo.ema_gain(xf, flag, torch.zeros_like(xf[:, 0]),
                                      cfg, 0.3, w)
            maps = None
            if cfg.method in ("curve", "hybrid"):
                cnn_in = (xf if cfg.method == "curve"
                          else torch.clamp(xf * gain[:, None], 0.0, 1.0))
                maps = curve_maps_for_kernel(
                    _mask_extent(cnn_in, -halo, h, w, m), cfg,
                    params[cfg.method])
        return xb, gain, maps, halo, xb.shape[-2] - 2 * halo, w, m

    # K3 on the video step's blocks, as its curve arm (no gain) and hybrid
    # arm (with the gain plane) call it, ds 1 and 4; 1080p b8 is the
    # x8-stream step's block
    for base, ds, (b, h, w) in (
            (hybrid, 1, (8, 400, 600)), (hybrid, 4, (8, 400, 600)),
            (hybrid, 4, (1, 1080, 1920)), (hybrid, 4, (8, 1080, 1920)),
            (curve, 4, (8, 1080, 1920))):
        cfg = base.replace(curve_downsample=ds)
        xb, gain, maps, halo, rows, iw, m = video_case(
            cfg, synth_batch(b, h, w, seed=8)[0])
        if cfg.method == "curve":
            gain = None
        kds = kernel_maps_ds(cfg)
        got = fe.fused_curve_enhance(xb, maps, cfg, halo, rows, iw, ds=kds,
                                     gain=gain)
        want = fe.fused_curve_enhance_plain(xb, maps, cfg, halo, rows, iw,
                                            kds, gain)
        st = delta_stats(got[..., :h, m:m + iw].cpu().numpy(),
                         want[..., :h, m:m + iw].cpu().numpy())
        check_bar(f"K3 {cfg.method} ds{ds}{'' if gain is None else ' + gain'}"
                  f" video block {w}x{h} b{b}", st)
        err["k3"] = max(err["k3"], st["max_abs"])
        del xb, gain, maps, got, want

    # K1's gain form
    for b, h, w in ((1, 1080, 1920), (8, 400, 600)):
        xb, gain, _, halo, rows, iw, m = video_case(
            cfg0, synth_batch(b, h, w, seed=9)[0])
        got = fe.fused_retinex_gain(xb, gain, cfg0, halo, rows)
        want = fe.fused_retinex_gain_plain(xb, gain, cfg0, halo, rows)
        st = delta_stats(got[..., :h, m:m + iw].cpu().numpy(),
                         want[..., :h, m:m + iw].cpu().numpy())
        check_bar(f"K1 gain form {w}x{h} b{b}", st)
        err["k1"] = max(err["k1"], st["max_abs"])
        del xb, gain, got, want

    # K4 over chained frames, kernel and plain version each fed its own
    # carry: frame 1 starts from the all-sentinel carry; before frame 3
    # stream 1 of a batch is re-seeded (its carry set to the sentinel)
    k4_carry_err = 0.0
    for b, h, w, n in ((1, 1080, 1920, 4), (8, 400, 600, 4), (2, 33, 47, 2)):
        base = synth_batch(b, h, w, seed=10)[0]
        halo, m = learned_halo(cfg0), canvas_margin(cfg0)
        ck = cp = None
        for t in range(n):
            xb = tvideo.pad_video_block(
                torch.from_numpy(frames_of(base, t)).to(dev), cfg0)
            rows = xb.shape[-2] - 2 * halo
            if ck is None:
                ck = torch.full((b,) + xb.shape[-2:], -1.0, device=dev)
                cp = ck.clone()
            if t == 2 and b > 1:
                ck[1] = -1.0
                cp[1] = -1.0
            got, ck = fe.fused_retinex_ema(xb, ck, cfg0, halo, rows, w, 0.3)
            want, cp = fe.fused_retinex_ema_plain(xb, cp, cfg0, halo, rows,
                                                  w, 0.3)
            st = delta_stats(got[..., :h, m:m + w].cpu().numpy(),
                             want[..., :h, m:m + w].cpu().numpy())
            check_bar(f"K4 {w}x{h} b{b} frame {t + 1}", st)
            err["k4"] = max(err["k4"], st["max_abs"])
            dc = float((ck - cp)[..., m:m + w].abs().max())
            k4_carry_err = max(k4_carry_err, dc)
            if dc > 1e-6:
                raise AssertionError(f"K4 carry off by {dc} at {w}x{h}")
        del xb, ck, cp, got, want
    print(f"  K4 new carry max |df32| on the image columns over the cases: "
          f"{k4_carry_err:.3e}")

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

    # the video forms at the video benchmark's 1080p b1 and at 600x400 b8,
    # in two rounds to show the spread of their times within one run
    video_ms = {}
    hybrid4 = hybrid.replace(curve_downsample=4)

    def timed(name, plain, kernel, bnd):
        video_ms.setdefault(name, []).append(
            paired_ms(torch, plain, kernel, 10) + (bnd,))

    for _ in range(2):
        for b, h, w in ((1, 1080, 1920), (8, 400, 600)):
            lows = synth_batch(b, h, w, seed=11)[0]
            shape = f"{w}x{h} b{b}"
            xb, gain, _, halo, rows, iw, m = video_case(cfg0, lows)
            carry = torch.full_like(gain, -1.0)
            timed(f"K4 {shape}",
                  lambda: fe.fused_retinex_ema_plain(xb, carry, cfg0, halo,
                                                     rows, iw, 0.3),
                  lambda: fe.fused_retinex_ema(xb, carry, cfg0, halo, rows,
                                               iw, 0.3),
                  k4_bound(cfg0, b, xb.shape[-2], xb.shape[-1], rows, m))
            timed(f"K1 gain form {shape}",
                  lambda: fe.fused_retinex_gain_plain(xb, gain, cfg0, halo,
                                                      rows),
                  lambda: fe.fused_retinex_gain(xb, gain, cfg0, halo, rows),
                  k1_gain_bound(cfg0, b, rows, m, xb.shape[-1]))
            xb, gain, maps, halo, rows, iw, m = video_case(hybrid4, lows)
            timed(f"K3 hybrid ds4 + gain {shape}",
                  lambda: fe.fused_curve_enhance_plain(xb, maps, hybrid4,
                                                       halo, rows, iw, 4,
                                                       gain),
                  lambda: fe.fused_curve_enhance(xb, maps, hybrid4, halo,
                                                 rows, iw, ds=4, gain=gain),
                  k3_bound(hybrid4, xb, maps, halo, rows, m, ds=4,
                           gain=True))
            xb, maps, halo, rows, iw, m = curve_case(hybrid4, lows)
            timed(f"K3 hybrid ds4 (stateless) {shape}",
                  lambda: fe.fused_curve_enhance_plain(xb, maps, hybrid4,
                                                       halo, rows, iw, 4),
                  lambda: fe.fused_curve_enhance(xb, maps, hybrid4, halo,
                                                 rows, iw, ds=4),
                  k3_bound(hybrid4, xb, maps, halo, rows, m, ds=4))
            del xb, gain, maps, carry
    print(f"  600x400 b48 on {card}: K1 {k1_ms:.3f} ms (plain "
          f"{k1_plain_ms:.3f} ms, bound {k1_b[0]:.4f} ms by {k1_b[1]}); "
          f"K3 hybrid {k3_ms:.3f} ms (plain {k3_plain_ms:.3f} ms, bound "
          f"{k3_b[0]:.4f} ms by {k3_b[1]})")
    for name, (t, tp, bd) in k5_ms.items():
        print(f"  600x400 b48 on {card}: K5 {name} block {t:.3f} ms (plain "
              f"{tp:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]})")
    for name, rounds in video_ms.items():
        t = " / ".join(f"{r[0]:.4f}" for r in rounds)
        tp = " / ".join(f"{r[1]:.3f}" for r in rounds)
        bd = rounds[-1][2]
        print(f"  {name} on {card}: {t} ms in rounds 1 / 2 (plain {tp} ms, "
              f"bound {bd[0]:.4f} ms by {bd[1]})")

    # the main path: each path's launch counts, reset to 0 just before it
    # runs and read just after
    paths = [("retinex", cfg0, ("k1",)), ("hybrid", hybrid, ("k3",)),
             ("quality", quality, ("k5",)),
             ("quality_fast", quality_fast, ("k5",))]
    # stateless curve/hybrid at curve_downsample 2, 4 (maps upsampled in
    # K3) and 8 (upsampled eagerly, then K3 at ds 1)
    paths += [(f"{c.method} ds{ds}", c.replace(curve_downsample=ds), ("k3",))
              for c, ds in ((curve, 2), (hybrid, 4), (hybrid, 8))]
    # the video benchmark's arms: (name, config, ema_in_kernel, kernels it
    # launches, kernels it must not launch)
    video_paths = [
        ("video retinex", cfg0, True, ("k4",), ("k1", "k3")),
        ("video retinex_extgain", cfg0, False, ("k1",), ("k4", "k3")),
        ("video curve_ds4", curve.replace(curve_downsample=4), True,
         ("k3",), ("k1", "k4")),
        ("video hybrid_ds4", hybrid.replace(curve_downsample=4), True,
         ("k3",), ("k1", "k4")),
    ]
    launches = {name: {k: 0 for k in wrappers}
                for name, *_ in paths + video_paths}

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

    print("[4c] VideoEnhancer(device='cuda'): the 1080p video benchmark's "
          "arms, alpha 0.3")
    clip96 = synth_batch(1, 64, 96, seed=12)[0][0]
    frame1080 = synth_batch(1, 1080, 1920, seed=13)[0][0]
    n_chain = 20

    def run_clip(ve, clip):
        """The frames through one enhancer, reset before the third."""
        outs = []
        for t, f in enumerate(clip):
            if t == 2:
                ve.reset()
            outs.append(ve.process(f))
        return np.stack(outs)

    def chained_ms(ve, frames):
        """ms per step of the step chained on the card, the state fed
        forward, alternating the frames and the frames XOR 1."""
        ve.process(frames)  # builds the step and starts the state
        x = torch.from_numpy(frames).to(dev)
        two, state = (x, torch.bitwise_xor(x, 1)), [ve._state]

        def chain():
            st = state[0]
            for k in range(n_chain):
                st, _ = ve._step(st, two[k % 2])
            state[0] = st

        return cuda_ms(torch, chain, 3) / n_chain

    def phase4c(name, cfg, ema_in_kernel):
        clip = np.stack([frames_of(clip96, t) for t in range(4)])

        def pair(c):
            ve = tvideo.VideoEnhancer(c, device="cuda",
                                      ema_in_kernel=ema_in_kernel)
            cpu = tvideo.VideoEnhancer(c, device="cpu",
                                       ema_in_kernel=ema_in_kernel,
                                       model_params=ve.model_params)
            return run_clip(ve, clip), run_clip(cpu, clip)

        got, want = pair(cfg)
        if got.shape != clip.shape or got.dtype != np.uint8:
            raise AssertionError(f"{name}: output {got.shape} {got.dtype}")
        if cfg.method == "retinex":
            check_bar(f"{name} cuda vs cpu 96x64, 4 frames",
                      delta_stats(got, want))
        else:
            p = psnr(got, want)
            print(f"  {name} (bf16) cuda vs cpu 96x64, 4 frames: PSNR "
                  f"{p:.2f} dB")
            if p < 40.0:
                raise AssertionError(f"{name} PSNR {p:.2f} < 40 dB")
            got, want = pair(cfg.replace(compute_dtype="float32"))
            check_bar(f"{name} (f32) cuda vs cpu 96x64, 4 frames",
                      delta_stats(got, want))
        ms = chained_ms(tvideo.VideoEnhancer(cfg, device="cuda",
                                             ema_in_kernel=ema_in_kernel),
                        frame1080)
        print(f"  {name} 1080p on {card}: {1e3 / ms:.1f} frames/s "
              f"({ms:.3f} ms/step, {n_chain} chained steps, CUDA events)")
        if cfg.method == "retinex":
            return
        s8 = np.stack([frames_of(frame1080, i) for i in range(8)])
        mv = tvideo.MultiStreamVideoEnhancer(8, cfg, device="cuda")
        lone = tvideo.VideoEnhancer(cfg, device="cuda",
                                    model_params=mv.model_params)
        for t in range(2):
            frames = np.stack([frames_of(f, t) for f in s8])
            st = delta_stats(mv.process(frames)[0], lone.process(frames[0]))
            print(f"  {name} stream 0 under 8 streams vs alone, frame "
                  f"{t + 1} (bf16, measured, not a bar): max|du8|="
                  f"{st['max_abs']} changed={st['changed_share']:.3e}")
        ms = chained_ms(tvideo.MultiStreamVideoEnhancer(8, cfg, device="cuda"),
                        s8)
        print(f"  {name} x8 streams 1080p on {card}: {8e3 / ms:.1f} "
              f"frames/s summed ({ms:.3f} ms/step)")

    for name, cfg, ema_in_kernel, _, _ in video_paths:
        counted(name, lambda: phase4c(name, cfg, ema_in_kernel))
    del clip96, frame1080

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

    print(f"[6] launches per path (phases 4-5, 4c): {launches}")
    expected = [(name, kernels, ()) for name, _, kernels in paths]
    expected += [(name, kernels, never)
                 for name, _, _, kernels, never in video_paths]
    for name, kernels, never in expected:
        if min(launches[name][k] for k in kernels) < 1:
            raise AssertionError(f"path {name} never launched one of "
                                 f"{kernels}: {launches[name]}")
        if any(launches[name][k] for k in never):
            raise AssertionError(f"path {name} launched one of {never}: "
                                 f"{launches[name]}")
    total = {k: sum(launches[name][k] for name, kernels, _ in expected
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
        row("fused_retinex_ema (K4)", "k4", "fused_enhance.cu",
            "fused_enhance.py:350", *video_ms["K4 1920x1080 b1"][-1]),
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
