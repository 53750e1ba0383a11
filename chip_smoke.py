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
maps (hybrid also with the gain plane). The nets' own conv kernels: hybrid
and ``quality`` under conv_impl="pallas" (K6a), ``quality_fast`` under
"pallas" (K6b) and "cascade" (K7, one launch for c2-c7), hybrid under
"pallas" at the other widths its configs reach (curve_features 64 and
160, curve_iters 4 and 16, random weights from the port's initialiser),
and the HWC entry point enhance_hwc_u8 (K8) on retinex with the
per-channel full-tap tail. The guided tail (denoise_taps="guided") of
retinex (K1), curve and hybrid (K3, hybrid also under "pallas") and of the
video arms (K4, K1's gain form, K3 with the gain), a blur radius past the
kernels' tiles (blur_illumination, then K1), and hybrid "pallas" at
curve_features 640 (K6 streaming its weights by piece group). The host
boundary: the planar and canvas entry points (K1's canvas form,
fused_retinex_canvas), enhance_stream in its three stagings on the pinned
prefetch queue, enhance_file and the golden fixtures through the zlib PNG
codec, the eval runner (eval_lol) and the HTTP front end. Training: the
curve (zero-reference and paired hybrid), fcn and decom trainers' steps,
config 3 at full width, and llie-torch train. Parallel (parallel/): meshes
of cuda:0 repeated, config 5 (K1's canvas form a shard), hybrid sharded
(K3, K6a), the sharded video enhancer (K4, K1's gain form, K3), the
data-parallel pipeline (K1) and training steps, and a process group.
RAW ingest (config 8): RGGB mosaics through enhance_raw_batch (the ISP,
then K1; hybrid: K3), also under spatial_shards and from llie-torch
enhance --raw; and the toolkit ops (ops: colour spaces, filters, retinex,
gamma, Fourier, contrast) on the card. The nets' conv arms gemm, packed and
packed12 (hybrid then K3, the presets then K5), the utils (checked,
profile_trace, the per-source kernel build), a spatial mesh spanning
two processes (config 5, curve) and K8's canvas form fused_retinex_hwc.
The bench (bench.py): each method's chain of enhance_batch_device steps
captured into a CUDA graph (retinex K1, curve and hybrid K3, fcn and
decom K5; retinex's canvas chain K1's canvas form), and its main.

Phases (each raises on failure, so the script exits non-zero):
  1. the card: CUDA present, compute capability 9.0, name and power limit;
  2. the kernel build from the sources in the checkout (nvcc, sm_90a),
     and the tile plan of K1/K4/K3 (llie_retinex_tile_plan) against its
     CPU mirror in tests/test_torch_retinex_tile.py, the guided kernel's
     (llie_fused_guided_plan) against tests/test_torch_guided_tile.py's,
     the blur plane's (llie_blur_plan: its chunks at large radii) against
     tests/test_torch_blur_tile.py's and K5's bilateral shared memory
     against tests/test_torch_denoise_tile.py's;
  3. each kernel (K1 fused_retinex and its gain form, K3
     fused_curve_enhance with maps at 1/1, 1/2, 1/4 and with the gain
     plane, K4 fused_retinex_ema over chained frames, K5 tiled_denoise, K8
     enhance_hwc_u8) against its plain PyTorch version on the card, on
     synthetic images:
     max |du8|, changed share and a histogram of du8; bar: max |du8| <= 1
     and changed share < 1e-3 (K4's new carry: max |df32| <= 1e-6 on the
     image's columns; K3 also on the video step's blocks, 1080p b8 among
     them; K8 also equal to EnhancePipeline's K1); the conv kernels K6a
     (1 and 2 groups, relu and tanh, and the widths other configs reach:
     64->64, 64+64->64, Cout 12 and 48, and 160+160->160, whose halo rows
     the kernel loads in groups of pieces), K6b (each fcn dilation) and K7
     (the fcn stack) on random activations, float32 within 1e-5 (TF32 off)
     and bf16 within one bf16 step (bf16 K6 and K7 run on the tensor
     cores, f32 on the CUDA cores), K7 also launched one layer at a time
     against the plain layer, its six-layer launch equal to the chain of
     its one-layer launches and, in both dtypes, to K6b layer by layer;
     the forms of K1, K3 and K4 beyond the default ones against their plain
     versions (the guided tail at r 2 and 4 in both guides, also at the
     guided kernel's tile edges, f32 I/O, blur radii 9, 16 and 32, K1's
     every stages subset; f32 within 1e-5; K1's canvas form on the
     padded planar canvas, u8 and f32, with no tail, the bilateral, the
     guided tail at r 2 and 4 in both guides and blur r 16, at 1x1, one
     tile and one tile + 1, 600x400 b48 and 1080p b1, bit-equal to its
     plain version and to HWC K1; every guided form, which runs
     the guided kernel fused_guided, and K5 bit-equal: its guided arm, and
     its bilateral arm in every form, also on blocks whose width is off a
     multiple of 4 and of 64 or whose data is off 16-byte alignment),
     the blur plane alone (HWC and planar, u8 and f32, at the tile's edges
     and at radii 9-128, where the plan chunks the tile; within 1e-6, its
     maximum reported), the
     edges of the 32 x 64 tile of K1/K4/K3 (one tile and one tile + 1,
     widths off a multiple of 4 and of 64, 1-pixel-wide and -tall images,
     radii 1, 8 and 9; K4 over 4 chained frames with a stream re-seeded at
     those sizes; K3 at ds 1, 2 and 4, also with curve_iters 4 and 16,
     strength 0, f32, the per-channel full tail, blur r 8 and 16, each with
     and without the gain plane; K3 and K1's gain form bit-equal to their
     plain versions), K6 at 640+640->640,
     1024+1024->24 and 1024->24 at d 64 (streamed weights) against float64
     sums within one bf16 step or the f32 sum's rounding; then
     each kernel's time beside its plain version's, its bound and (K6) one
     F.conv2d's at 600x400 batch 48 (K6a also 32->32, K6b also at d 32),
     and the video forms' at 1080p b1 and
     600x400 b8, twice; times are of the device alone, the calls queued
     behind a spin;
  4. each path through EnhancePipeline(device="cuda"), and stateless curve
     ds 2 and hybrid ds 4 and 8, and the conv_impl="pallas"/"cascade"
     paths (hybrid also at curve_features 64 and 160, curve_iters 4 and
     16):
     agreement with the CPU pipeline on a small input (float32 max
     |du8| bar, bf16 PSNR >= 40 dB) and img/s at 600x400 batch 48 from
     CUDA events; enhance_hwc_u8 likewise;
  4b. the two presets' PSNR/SSIM/dE76 means over the 15 synthetic eval
     pairs on the card, against the JAX package's numbers for the same
     pairs (tools/jax_eval15_reference.py): bar 0.1 dB and 0.005 SSIM;
     also ``quality`` under "pallas", ``quality_fast`` under "cascade",
     retinex and hybrid with the guided tail at r 4, and, through the
     port's eval runner (eval_lol), retinex, curve, hybrid and decom with
     the default bilateral tail;
  4c. each video arm through VideoEnhancer(device="cuda"): agreement with
     device="cpu" over 4 frames at 96x64 with a reset (float32 max |du8|
     bar, bf16 PSNR >= 40 dB), the 1080p frame rate of the step chained on
     the card with its state fed forward (CUDA events), and for curve and
     hybrid MultiStreamVideoEnhancer(8)'s summed rate and whether a
     stream's output equals its lone output on the card;
  4d. the host boundary: enhance_batch_device_planar and
     enhance_batch_device_canvas equal to enhance_batch_device (Δ 0, 600x400
     b48); enhance_stream in the hwc, planar and canvas stagings over 64
     frames of 600x400 (batches of 8) and 16 single 1080p frames, every
     frame byte-equal to enhance's, with frames/s beside enhance_batch's
     host rate; the golden fixtures and enhance_file through the zlib PNG
     codec, within 0.1 dB and 0.005 SSIM of tests/data/expected_metrics.json;
  5. an EnhanceServer per path (retinex, hybrid, quality, quality_fast
     under "cascade", retinex and hybrid guided r 4), 16 requests of
     two shapes (the guided paths also two at 1080p) from 4 threads per
     round, each answer equal to
     pipeline.enhance, p50/p99 latency; then HttpEnhanceServer on a
     loopback port, PNG requests from 4 threads, each answer equal to
     pipeline.enhance, p50/p99;
  6. each path's launch counts, reset to 0 just before it runs (phases
     4-5, 4c) and read just after: every path launched its kernels, and
     the retinex video path launched K4 and no K1; the guided paths the
     guided kernel and none of K1's, K3's and K4's, the others not the
     guided kernel; the conv paths K6a 6
     times (hybrid, at every width) or 3 times (decom) a K3 or K5 launch,
     K6b 6 times, K7 once and no K6b (cascade); enhance_hwc_u8 K8 and no
     K1; the default paths no conv kernel; the wide blur the blur kernel
     once a K1 launch; the planar, canvas and planar/canvas stream paths
     K1's canvas form and no HWC K1, the hwc stream HWC K1 and not the
     canvas form, and no other path the canvas form;
  7. training (train.py), which runs no kernel of the port (cuDNN convs
     and differentiable torch ops, as the JAX package trains with XLA's
     convs and jnp): 7a two steps of each objective (zero-reference curve;
     paired hybrid through the denoise tail; fcn; decom with the relit
     term) at 64x64 b4 in float32, device="cuda" against device="cpu"
     from the same weights and batches, loss and params (the whole
     vector's L2 norm) within 1e-5 relative; 7b config 3 (TrainConfig():
     512x512 b64, 32 features, 8 iterations, remat) zero-reference on
     synth_device batches made on the card, 2 warm-up and 10 timed steps
     (CUDA events) in bf16 and in f32: ms/step, img/s, peak memory,
     every loss finite, the roofline (train_roofline_report: the rate's
     share of the bound) and two steps' device time by kernel
     (torch.profiler); 7c
     microbatch 8 against the full batch of 16 at 256x256 within 1e-2
     (bf16), and a run resumed from its checkpoint bit-equal to a straight
     one under cudnn.deterministic; 7d the config-3 weights through
     save_params into EnhancePipeline(method="curve") on the card: K3
     launched, bf16 PSNR >= 40 dB and the f32 u8 bar against the CPU; 7e
     llie-torch train --steps 2 --batch 4 --crop 64 --save-weights in a
     process of its own, rc 0;
  8. parallel, on meshes whose devices are all cuda:0 (one card shows the
     cost of sharding, not scaling): 8a config 5 (PRESETS
     ["config5_4k_sharded"]) at 2160x3840 through enhance_spatial_sharded
     on 1, 4 and 8 spatial shards and a 2x4 mesh on b2, each Δu8 0 against
     the single-device enhance_batch_device, with frames/s (CUDA events
     around each call, median of 5 after a warm-up) beside the single
     device's and the halo bytes, the f32 frame on 8 shards (K1's canvas
     form on f32 blocks) within 1e-6 of HWC K1 on it, and
     EnhancePipeline(config 5) (one card: clamped to one shard, which runs
     the single-device path, HWC K1); 8b hybrid at 1080p b2 on 4 shards under auto (cuDNN) and
     pallas (K6a, 6 launches a K3 launch), f32 to the u8 bar and bf16 PSNR
     >= 40 dB against the single-device pipeline; 8c
     SpatialShardedVideoEnhancer over 8 frames, 4K retinex on 4 shards
     (K4, then K1's gain form) and hybrid ds 4 at 1080p on 2 shards (K3)
     with f32 nets, each frame to the u8 bar against VideoEnhancer, and
     with the default bf16 nets, each frame PSNR >= 40 dB, with frames/s;
     8d the
     default config at 600x400 b48 through shard_batch_fn on 2x1 and
     data_shards=2, Δ 0; config 3's step (512x512 b16) on 2x1 against
     one device, f32 (loss within 1e-6, params' L2 within 1e-5) and bf16
     (7c's bar); the row-sharded paired step at 512x512 b4 f32 on 1x4;
     and a process group of one on nccl (initialize_distributed) whose
     2x1 step equals the one without it. Each path's launch counts,
     reset just before it runs and read just after: its kernels and no
     other;
  9. RAW and the toolkit ops: 9a config 8 (600x400 b48 RGGB mosaics made
     from 8 seeded synthetic lows by keeping each Bayer site's channel)
     through enhance_raw_batch on the card: one K1 launch a call and no
     canvas form, the 8 distinct mosaics to the u8 bar against
     device="cpu", the ISP's u8 through enhance_batch_device equal to
     enhance_raw_batch_device (Δ 0), a 12-bit u16 mosaic (white_level 4095,
     DNs above it) with explicit gains to the u8 bar, --method hybrid (K3)
     PSNR >= 40 dB against the CPU, spatial_shards=4 (one card: the
     single-device path) Δ 0, llie-torch enhance --raw on a .npy in a
     process of its own (rc 0, equal to enhance_raw); 9b the ISP alone,
     the ISP + K1 and K1 alone on the ISP's u8, device-resident (CUDA
     events around each call, median of 5); 9c each toolkit op at 1080p
     against the CPU port within its CPU bar (FFT ops 1e-4), with its ms,
     and autocontrast on a 2160x3840 frame (past torch.quantile's limit).
     Each path's launch counts as in 8;
  10. the conv_impl arms of ops/patch_conv.py and the utils: 10a hybrid,
     quality_fast (fcn) and quality (decom, guided K5) with the shipped
     weights in bf16 under gemm, packed and packed12, and hybrid packed in
     f32, at 600x400 b48 against the card's xla arm on the same weights
     (f32 the u8 bar, bf16 PSNR >= 40 dB), then at 192x128 b2 against the
     CPU, each one K3 (hybrid) or K5 (the presets) launch a call and no
     other kernel; 10b each arm's ms a call and img/s beside xla and
     pallas (cascade for fcn), CUDA events, median of 5; 10c checked
     raising on a NaN made on the card and passing K1, profile_trace of
     one enhance_batch_device call in stage("enhance"), in this process
     after phases 7b-9 (naming the stage and K1's kernel, or raising
     DeviceEventsLost where torch's profiler dropped the card's activity)
     and in a process of its own (naming both), the kernel library's
     build (objects compiled and reused) and a rebuild with one source
     changed; 10e fused_retinex_hwc (K8 on the edge-padded HWC canvas) at
     600x400 b8, Δu8 0 against its plain version and, cropped, against
     enhance_hwc_u8 on the image, its launches K8's; 10d two processes on
     cuda:0 over gloo, each holding its rows of a spatial mesh spanning
     both (halos crossing the processes): config 5 at 2160x3840 b1 on 2 x
     4 shards, Δ 0 against the same mesh in one process and the
     single-device pipeline, and curve at 1080p on 2 x 2, Δ 0 against the
     mesh in one process and PSNR >= 40 dB against the single device; the
     processes load the library the parent built;
  11. the bench (bench.py) at 600x400 b48: bench_throughput(chain=
     "device") for retinex, curve, hybrid, fcn and decom (8- and 60-step
     chains, each one CUDA graph replay; 3 repeats): the 8-step graph's
     output equal to the eager chain's (Δu8 0), the kernels each capture
     holds (8 launches of K1, K3 or K5 a graph, K1's canvas form for
     retinex's canvas chain, and no other kernel of the port), a positive
     marginal rate in every repeat, the rates, the roofline placement and
     the long capture's peak memory; retinex's Python chain beside it;
     then python -m low_light_image_enhancement_tpu_torch.bench in a
     process of its own, whose last line must name the metric with a
     positive value and the card's power limit. Its launch counts add one
     a launch its wrappers made: the eager steps and each launch captured
     into a graph once (a replay runs the graph without the wrappers).

The last line is {"ok": true, "device": {...}}; the line before it is the
card's name and power limit, and the one before that lists the kernels
with their measured numbers and their bounds.
"""

from __future__ import annotations

import http.client
import json
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

BAR_MAX, BAR_SHARE = 1, 1e-3

# The JAX package's quality numbers for the synthetic eval-15 set (15 pairs
# synth_pair(i, 400, 600, seed=0)), from its own evaluation on the CPU:
# tools/jax_eval15_reference.py, i.e. eval_lol(EnhancePipeline(PRESETS[name],
# force_jnp=True), max_images=15, parity=False).
RETINEX_GUIDED_R4 = {"psnr": 10.656063715616861, "ssim": 0.642203938961029,
                     "delta_e76": 37.17897987365723}
HYBRID_GUIDED_R4 = {"psnr": 19.367358907063803, "ssim": 0.7950365503629049,
                    "delta_e76": 18.524588966369627}
JAX_EVAL15 = {
    "quality": {"psnr": 20.13423360188802, "ssim": 0.921144445737203,
                "delta_e76": 17.885644912719727},
    "quality_fast": {"psnr": 18.797438430786134, "ssim": 0.8913289864857992,
                     "delta_e76": 17.871696535746256},
    "retinex guided r4": RETINEX_GUIDED_R4,
    "hybrid guided r4": HYBRID_GUIDED_R4,
    # the default bilateral tail, through the port's eval_lol
    "retinex": {"psnr": 10.64133456548055, "ssim": 0.5051738977432251,
                "delta_e76": 37.51267115275065},
    "curve": {"psnr": 19.133614540100098, "ssim": 0.7405618369579315,
              "delta_e76": 19.490376663208007},
    "hybrid": {"psnr": 19.267244148254395, "ssim": 0.7283268551031749,
               "delta_e76": 19.357021458943684},
    "decom": {"psnr": 20.036342748006184, "ssim": 0.8975801467895508,
              "delta_e76": 18.050062497456867},
}
EVAL_BAR_DB, EVAL_BAR_SSIM = 0.1, 0.005

# H100 SXM data sheet: HBM rate, the float32 rate outside the tensor cores
# and the dense bf16 tensor-core rate. K1-K5 and K8 compute in float32; a
# conv's least time on bf16 data is set by the tensor cores' rate (bf16 K6
# runs there; K7 runs on the CUDA cores, so it stands far above that
# bound).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12

# the conv kernels against their plain versions: float32 (TF32 off), sums
# in another order
CONV_F32_BAR = 1e-5
FCN_DILATIONS = (2, 4, 8, 16, 32, 1)   # fcn c2-c7


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def delta_stats(got: np.ndarray, want: np.ndarray) -> dict:
    """max |du8|, the changed share and the histogram of du8 of two u8
    arrays (counted in one pass: sorting tens of millions of values for
    np.unique took seconds a case)."""
    d = got.astype(np.int32) - want.astype(np.int32)
    counts = np.bincount((d + 255).ravel(), minlength=511)
    return {"max_abs": int(np.abs(d).max()),
            "changed_share": float((d != 0).mean()),
            "hist": {int(v) - 255: int(counts[v])
                     for v in np.flatnonzero(counts)}}


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


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bound(cfg, b, h, w, itemsize=1):
    """u8 (itemsize 1) or f32 (4: no normalize, a clip in place of the
    quantize) RGB in and out."""
    px = b * h * w
    io = (NORMALIZE_OPS + QUANTIZE_OPS) if itemsize == 1 else 6
    ops = io + boost_ops(cfg) + tail_ops(cfg)
    return bound_ms(6 * itemsize * px, ops * px)


def k1_canvas_bound(cfg, b, h, w, plan, itemsize=1):
    """K1's canvas form: K1's operations on the h x w image, and the bytes
    of the plan's canvas in and of its padded_h - 2 margin rows out."""
    hp, wp, m = plan
    io = (NORMALIZE_OPS + QUANTIZE_OPS) if itemsize == 1 else 6
    ops = io + boost_ops(cfg) + tail_ops(cfg)
    nbytes = 3 * itemsize * b * wp * (hp + hp - 2 * m)
    return bound_ms(nbytes, ops * b * h * w)


def blur_plane_bound(cfg, b, h, w, e):
    """blur_illumination: u8 RGB in, the f32 plane of (h + 2e) x (w + 2e)
    out; max RGB 2 and the two blur passes a position."""
    taps = 2 * cfg.blur_radius + 1
    n = b * (h + 2 * e) * (w + 2 * e)
    return bound_ms(3 * b * h * w + 4 * n, n * (2 + 2 * (2 * taps - 1)))


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
    (``upsample_ops``) besides the curve step's 4. A u8 block reads and
    writes 3 bytes a pixel, an f32 one 12 (no normalize, a clip in place of
    the quantize)."""
    b, _, _, wb = xb.shape
    win = b * (rows + 2 * m) * wb
    n_iter = maps.shape[1]
    io = 3 * xb.element_size()
    nbytes = (win * (io + n_iter * 3 * 4 / (ds * ds) + (4 if gain else 0))
              + b * rows * wb * io)
    pre = GAIN_OPS if gain else (
        boost_ops(cfg) if cfg.method == "hybrid" else 0)
    io_ops = NORMALIZE_OPS + QUANTIZE_OPS if xb.element_size() == 1 else 6
    ops = (io_ops + pre + n_iter * 3 * (4 + upsample_ops(ds)) + 6
           + tail_ops(cfg))
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


def conv_bound(px, cin, cout, itemsize, layers=1):
    """``layers`` 3x3 convs of cin -> cout channels (K7: cin == cout) over
    ``px`` pixels: the input read once and the output written once (what a
    kernel keeping the activations between layers on chip would move), and
    per layer and output value 9 * cin multiply-adds (2 operations each),
    the bias and the activation; bf16 at the tensor cores' rate, float32
    at the CUDA cores'."""
    nbytes = px * (cin + cout) * itemsize
    ops = layers * px * cout * (2 * 9 * cin + 2)
    return bound_ms(nbytes, ops,
                    BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S)


def k5_bound(cfg, y, rows, m):
    b, _, _, wb = y.shape
    nbytes = b * (rows + 2 * m) * wb * 12 + b * rows * wb * 12
    return bound_ms(nbytes, (tail_ops(cfg) + 6) * b * rows * wb)


# ------------------------------------------------------------- phase 7 --- #
# training's bars: the card against the CPU in float32 with TF32 off (sums
# in other orders), and bf16 against itself under another microbatching
TRAIN_F32_REL = 1e-5
TRAIN_BF16_REL = 1e-2
# phase 8: a sharded float32 step against the one-device step on the card
# (sums in another order): the loss relative, the parameters' L2 relative
TRAIN_DP_LOSS_REL = 1e-6
TRAIN_DP_PARAMS_REL = 1e-5


def max_rel(got, want) -> float:
    """max |got - want| over max |want| (a leaf's or a scalar's)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def params_rel(tt, got, want) -> float:
    """||got - want|| over ||want||, the whole parameter vector's L2 norms.
    AdamW sizes each element's step by its own gradient's history, so an
    element whose two gradients nearly cancel moves by a good part of the
    learning rate either way on a rounding: float32 against float64 on the
    CPU parts 2 steps of the curve CNN by 6e-4 of a leaf's largest value,
    and by 6.3e-7 in this norm."""
    flat = lambda ps: np.concatenate([t.detach().cpu().double().numpy()
                                      .ravel() for t in tt._leaves(ps)])
    g, w = flat(got), flat(want)
    return float(np.linalg.norm(g - w) / np.linalg.norm(w))


def profile_steps(torch, what: str, run, calls: int = 2, top: int = 10):
    """Device time by kernel over ``calls`` calls of ``run`` under
    torch.profiler: busy and idle share, then the kernels that take most."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / calls
    dev_us = lambda e: float(getattr(e, "self_device_time_total", 0.0))
    kernels = sorted((e for e in prof.key_averages()
                      if str(e.device_type).endswith("CUDA")),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e3 / calls
    print(f"  {what} profile, {calls} calls: wall {wall:.2f} ms a call, "
          f"device busy {busy:.2f}, idle share "
          f"{max(0.0, 1.0 - busy / wall):.3f}")
    for e in kernels[:top]:
        ms = dev_us(e) / 1e3 / calls
        print(f"    {ms:8.3f} ms {ms / busy:6.1%} x{e.count // calls:<4d} "
              f"{e.key[:100]}")


def phase7_training(torch, card, wrappers, t_start) -> None:
    """Training on the card (train.py): each objective's steps against the
    CPU's, config 3 at full width in bf16 and f32, microbatching and
    resume, the trained weights served through K3, and llie-torch train."""
    import dataclasses

    from low_light_image_enhancement_tpu_torch import train as tt
    from low_light_image_enhancement_tpu_torch.config import PipelineConfig
    from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
    from low_light_image_enhancement_tpu_torch.data.synth_device import (
        synth_batch_iter,
    )
    from low_light_image_enhancement_tpu_torch.models.decom import (
        init_decom_net,
    )
    from low_light_image_enhancement_tpu_torch.models.fcn import init_fcn
    from low_light_image_enhancement_tpu_torch.models.weights import (
        params_from_numpy,
        resolve_weights,
        save_params,
    )
    from low_light_image_enhancement_tpu_torch.pipeline import (
        EnhancePipeline,
    )
    from low_light_image_enhancement_tpu_torch.utils.roofline import (
        train_roofline_report,
    )

    print(f"[7] ({time.perf_counter() - t_start:.0f} s) training "
          "(train.py) on the card")

    # 7a: two steps of each objective, device="cuda" against "cpu" from
    # the same weights and batches, float32 with TF32 off
    small = tt.TrainConfig(batch_size=4, crop=64, compute_dtype="float32")
    lows, highs = synth_batch(4, 64, 64, seed=21)
    gen = lambda: torch.Generator().manual_seed(5)
    objectives = [
        ("zeroref curve", small, tt.make_train_step,
         lambda: tt.init_train_state(small, 5, "cpu")[0], False, False),
        ("paired hybrid, denoise_in_loss",
         dataclasses.replace(small, denoise_in_loss=True),
         tt.make_paired_curve_train_step,
         lambda: tt.init_train_state(small, 5, "cpu")[0], True, True),
        ("fcn", dataclasses.replace(small, features=24),
         tt.make_supervised_train_step,
         lambda: init_fcn(gen(), features=24), True, False),
        ("decom, w_relit 1", dataclasses.replace(small, w_relit=1.0),
         tt.make_decom_train_step, lambda: init_decom_net(gen()), True,
         False),
    ]
    for name, tcfg, make, init, paired, hybrid in objectives:
        runs = {}
        for dev in ("cuda", "cpu"):
            params = {n: {k: t.to(dev) for k, t in layer.items()}
                      for n, layer in init().items()}
            opt = tt.make_optimizer(tcfg).init(params)
            low, high = tt._planar(lows, dev), tt._planar(highs, dev)
            if hybrid:
                from low_light_image_enhancement_tpu_torch.core import (
                    illumination_boost,
                )

                low = illumination_boost(low, PipelineConfig())
            args = (low, high) if paired else (low,)
            step = make(tcfg)
            # a process's first CPU conv may sum in another order than the
            # next ones (7e-6 of the zero-reference loss, whose TV term
            # weighs 1600): one warm-up step on each device first
            step(params, opt, *args)
            losses = []
            for _ in range(2):
                params, opt, m = step(params, opt, *args)
                losses.append(float(m["loss"]))
            runs[dev] = (losses, params)
        loss_rel = max(max_rel(a, b) for a, b in zip(runs["cuda"][0],
                                                      runs["cpu"][0]))
        p_rel = params_rel(tt, runs["cuda"][1], runs["cpu"][1])
        print(f"  7a {name} (64x64 b4, f32): cuda vs cpu over 2 steps, "
              f"loss rel {loss_rel:.2e}, params rel {p_rel:.2e} "
              f"(losses {runs['cuda'][0]})")
        if loss_rel > TRAIN_F32_REL or p_rel > TRAIN_F32_REL:
            raise AssertionError(f"7a {name}: cuda vs cpu loss rel "
                                 f"{loss_rel:.2e}, params rel {p_rel:.2e} "
                                 f"> {TRAIN_F32_REL}")

    # 7b: config 3 (TrainConfig(): 32 features, 8 iterations, batch 64,
    # crop 512, remat on) zero-reference on synth_device batches made on
    # the card; 2 warm-up steps, 10 timed with CUDA events; bf16, then f32
    trained = None
    for dtype in ("bfloat16", "float32"):
        tcfg = tt.TrainConfig(compute_dtype=dtype)
        data = synth_batch_iter(tcfg.batch_size, tcfg.crop, tcfg.crop,
                                seed=3)
        batches = [next(data)[0] for _ in range(4)]
        params, opt = tt.init_train_state(tcfg, seed=0)
        step = tt.make_train_step(tcfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        metrics = []
        for i in range(2):
            params, opt, m = step(params, opt, batches[i % 4])
            metrics.append(m["loss"])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(10):
            params, opt, m = step(params, opt, batches[i % 4])
            metrics.append(m["loss"])
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 10
        peak = torch.cuda.max_memory_allocated()
        losses = [float(v) for v in metrics]
        ips = tcfg.batch_size * 1e3 / ms
        rep = train_roofline_report(tcfg.features, tcfg.n_iter, tcfg.crop,
                                    ips, tcfg.remat, dtype)
        print(f"  7b config 3 {dtype} (512x512 b64, 32 features, 8 "
              f"iterations, remat) on {card}: {ms:.2f} ms/step, "
              f"{ips:.1f} img/s, peak memory {peak / 2**30:.2f} GiB, "
              f"{rep['train_share_of_bound_pct']}% of the "
              f"{rep['train_bound_images_per_sec']} img/s bound "
              f"({rep['train_roofline_bound']}); losses {losses}")
        print(f"  7b roofline {json.dumps(rep)}")
        profile_steps(torch, f"7b config 3 {dtype}",
                      lambda: step(params, opt, batches[0]))
        if not all(np.isfinite(losses)):
            raise AssertionError(f"7b config 3 {dtype}: a loss is not "
                                 f"finite: {losses}")
        if dtype == "bfloat16":
            trained = params
        del batches, params, opt, data

    # 7c: microbatch 8 against the full batch of 16 at crop 256 (bf16);
    # then a resumed run against a straight one, cudnn deterministic
    tcfg = tt.TrainConfig(batch_size=16, crop=256)
    x = next(synth_batch_iter(16, 256, 256, seed=9))[0]
    p0, o0 = tt.init_train_state(tcfg, seed=1)
    full = tt.make_train_step(tcfg)(p0, o0, x)
    mb = tt.make_train_step(dataclasses.replace(tcfg, microbatch=8))(p0, o0,
                                                                     x)
    loss_rel = max_rel(float(mb[2]["loss"]), float(full[2]["loss"]))
    p_rel = params_rel(tt, mb[0], full[0])
    print(f"  7c microbatch 8 vs batch 16 (256x256, bf16): loss rel "
          f"{loss_rel:.2e}, params rel {p_rel:.2e}")
    if loss_rel > TRAIN_BF16_REL or p_rel > TRAIN_BF16_REL:
        raise AssertionError(f"7c microbatch: loss rel {loss_rel:.2e}, "
                             f"params rel {p_rel:.2e} > {TRAIN_BF16_REL}")
    torch.backends.cudnn.deterministic = True
    try:
        rcfg = tt.TrainConfig(batch_size=4, crop=64, steps=4,
                              checkpoint_every=2, ema_decay=0.9)
        straight, _ = tt.train_curve_cnn(rcfg, seed=2)
        with tempfile.TemporaryDirectory() as ck:
            tt.train_curve_cnn(dataclasses.replace(rcfg, steps=2), seed=2,
                               checkpoint_dir=ck)
            resumed, hist = tt.train_curve_cnn(rcfg, seed=2,
                                               checkpoint_dir=ck,
                                               resume=True)
    finally:
        torch.backends.cudnn.deterministic = False
    equal = all(torch.equal(a, b) for a, b in zip(tt._leaves(resumed),
                                                   tt._leaves(straight)))
    print(f"  7c resume at step {hist[0]['step']} to 4 vs a straight 4-step "
          f"run (EMA 0.9, 64x64 b4, cudnn deterministic): "
          f"{'bit-equal' if equal else 'DIFFERENT'}")
    if not equal or hist[0]["step"] != 2:
        raise AssertionError("7c a resumed run differs from a straight one")

    # 7d: the config-3 bf16 weights through save_params into the curve
    # pipeline on the card (K3) against the CPU's
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "curve.npz"
        save_params(trained, path)
        served = params_from_numpy(resolve_weights(path))
    img = synth_batch(2, 64, 96, seed=6)[0]
    for dtype in ("bfloat16", "float32"):
        cfg = PipelineConfig(method="curve", compute_dtype=dtype)
        for wr in wrappers.values():
            wr.launches = 0
        got = EnhancePipeline(cfg, model_params=served,
                              device="cuda").enhance_batch(img)
        k3 = wrappers["k3"].launches
        want = EnhancePipeline(cfg, model_params=served,
                               device="cpu").enhance_batch(img)
        if k3 < 1:
            raise AssertionError(f"7d trained weights ({dtype}): K3 was "
                                 "not launched")
        if dtype == "bfloat16":
            p = psnr(got, want)
            print(f"  7d trained curve weights ({dtype}) served: K3 "
                  f"launches {k3}, cuda vs cpu 96x64 b2 PSNR {p:.2f} dB")
            if p < 40.0:
                raise AssertionError(f"7d PSNR {p:.2f} < 40 dB")
        else:
            print(f"  7d trained curve weights ({dtype}) served: K3 "
                  f"launches {k3}")
            check_bar("7d trained curve weights (f32) cuda vs cpu 96x64 b2",
                      delta_stats(got, want))

    # 7e: the CLI in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        w = Path(tmp) / "w.npz"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "low_light_image_enhancement_tpu_torch.cli",
             "train", "--steps", "2", "--batch", "4", "--crop", "64",
             "--save-weights", str(w)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        print(f"  7e llie-torch train --steps 2 --batch 4 --crop 64 "
              f"--save-weights: rc {proc.returncode} in "
              f"{time.perf_counter() - t0:.1f} s")
        if proc.returncode != 0 or not w.exists():
            raise AssertionError(f"7e llie-torch train failed: "
                                 f"{proc.stderr[-2000:]}")


# ------------------------------------------------------------- phase 8 --- #

def median_ms(torch, fn, reps: int = 5) -> float:
    """Median ms of ``reps`` calls of ``fn`` after a warm-up, each timed by
    CUDA events around the call (the launches' host time included)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def check_launches(expected, launches) -> None:
    """Every path launched each of its kernels and none it must not."""
    for name, kernels, nv in expected:
        if min(launches[name][k] for k in kernels) < 1:
            raise AssertionError(f"path {name} never launched one of "
                                 f"{kernels}: {launches[name]}")
        if any(launches[name][k] for k in nv):
            raise AssertionError(f"path {name} launched one of {nv}: "
                                 f"{launches[name]}")


def phase8_parallel(torch, card, wrappers, t_start):
    """The mesh paths (parallel/) on the card, the mesh's devices repeated
    on cuda:0: config 5 at 4K, the learned methods and the video enhancer
    sharded, the data-parallel pipeline and training steps, and a process
    group. Returns the paths' (name, kernels, never) and their launches."""
    import socket

    import torch.distributed as dist

    from low_light_image_enhancement_tpu_torch import train as tt
    from low_light_image_enhancement_tpu_torch.config import (
        PRESETS,
        PipelineConfig,
        canvas_margin,
    )
    from low_light_image_enhancement_tpu_torch.data.synth_device import (
        synth_pair_batch,
    )
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )
    from low_light_image_enhancement_tpu_torch.ops.colorspace import (
        normalize_u8,
        quantize_u8,
    )
    from low_light_image_enhancement_tpu_torch.parallel import (
        SpatialShardedVideoEnhancer,
        enhance_spatial_sharded,
        make_mesh,
        shard_batch_fn,
    )
    from low_light_image_enhancement_tpu_torch.parallel.distributed import (
        initialize_distributed,
        process_group_size,
    )
    from low_light_image_enhancement_tpu_torch.pipeline import (
        EnhancePipeline,
    )
    from low_light_image_enhancement_tpu_torch.video import VideoEnhancer

    print(f"[8] ({time.perf_counter() - t_start:.0f} s) parallel: meshes "
          "of cuda:0 repeated (one card: the cost of sharding, not scaling)")
    dev = torch.device("cuda", 0)
    mesh = lambda nd, ns: make_mesh(nd, ns, [dev] * (nd * ns))
    gen = torch.Generator(device=dev)
    all_k = tuple(wrappers)
    paths, launches = [], {}

    def frames_u8(b, h, w, seed):
        """Seeded synthetic low-light frames (B, H, W, 3) u8, made on the
        card."""
        low, _ = synth_pair_batch(gen.manual_seed(seed), b, h, w, dev)
        return quantize_u8(low).permute(0, 2, 3, 1).contiguous()

    def counted(name, kernels, run):
        never = tuple(k for k in all_k if k not in kernels)
        paths.append((name, kernels, never))
        for wr in wrappers.values():
            wr.launches = 0
        out = run()
        launches[name] = {k: wr.launches for k, wr in wrappers.items()}
        return out

    def planar(x):
        return x.permute(0, 3, 1, 2)

    # 8a: config 5 at 4K through enhance_spatial_sharded on meshes of 1, 4
    # and 8 spatial shards and a (2, 4) mesh on a batch of 2, each Δ 0
    # against the single-device pipeline (K1 on HWC)
    cfg5 = PRESETS["config5_4k_sharded"]
    h, w = 2160, 3840
    x2 = frames_u8(2, h, w, seed=8)
    single = EnhancePipeline(cfg5.replace(spatial_shards=1), device="cuda")
    m5 = canvas_margin(cfg5)
    wp = -(-(w + 2 * m5) // 128) * 128
    one_ms = median_ms(torch, lambda: single.enhance_batch_device(x2[:1]))
    print(f"  8a config 5 (retinex, 2160x3840) single device "
          f"(enhance_batch_device, K1): {one_ms:.3f} ms, "
          f"{1e3 / one_ms:.1f} frames/s on {card}")
    for nd, ns in ((1, 1), (1, 4), (1, 8), (2, 4)):
        x = x2[:nd]
        want = single.enhance_batch_device(x).cpu().numpy()
        msh = mesh(nd, ns)
        run = lambda: enhance_spatial_sharded(planar(x), cfg5, msh)
        got = counted(f"8a config5 {nd}x{ns}", ("kc",), run)
        got = got.permute(0, 2, 3, 1).cpu().numpy()
        st = delta_stats(got, want)
        ms = median_ms(torch, run)
        halo = (ns - 1) * 2 * m5 * wp * 3 * nd
        print(f"  8a config 5 on a {nd}x{ns} mesh (b{nd}): max|du8|="
              f"{st['max_abs']}, K1 canvas launches "
              f"{launches[f'8a config5 {nd}x{ns}']['kc']}, {ms:.3f} ms, "
              f"{nd * 1e3 / ms:.1f} frames/s (single device "
              f"{1e3 / one_ms:.1f}), halo {halo} B a call, on {card}")
        if st["max_abs"] != 0:
            raise AssertionError(f"8a config 5 {nd}x{ns}: sharded differs "
                                 f"from the single device: {st}")
    # f32 in and out: K1's canvas form on f32 blocks, on 8 shards, against
    # the single-device f32 path (HWC K1 on the f32 frame)
    xf = normalize_u8(x2[:1])
    want = fe.fused_retinex(xf, cfg5).permute(0, 3, 1, 2)
    msh = mesh(1, 8)
    run = lambda: enhance_spatial_sharded(planar(xf), cfg5, msh)
    got = counted("8a config5 f32 1x8", ("kc",), run)
    d = float((got - want).abs().max())
    ms = median_ms(torch, run)
    print(f"  8a config 5 f32 on a 1x8 mesh (b1): max|d|={d!r} against HWC "
          f"K1 on the f32 frame, K1 canvas launches "
          f"{launches['8a config5 f32 1x8']['kc']}, {ms:.3f} ms, "
          f"{1e3 / ms:.1f} frames/s, on {card}")
    if got.dtype != torch.float32 or d > 1e-6:
        raise AssertionError(f"8a config 5 f32 1x8: {got.dtype}, max|d| "
                             f"{d} > 1e-6 against the single device")
    del xf, want, got
    # the pipeline's own dispatch: config 5 on one card is clamped to one
    # shard, which runs the single-device path (HWC K1)
    pipe5 = EnhancePipeline(cfg5, device="cuda")
    run = lambda: pipe5.enhance_batch_device(x2[:1])
    got = counted("8a pipeline config5", ("k1",), run)
    if not torch.equal(got, single.enhance_batch_device(x2[:1])):
        raise AssertionError("8a EnhancePipeline(config 5) differs from "
                             "the single device")
    ms = median_ms(torch, run)
    print(f"  8a EnhancePipeline(config 5) on one card (one shard: the "
          f"single-device path): Δ 0, K1 launches "
          f"{launches['8a pipeline config5']['k1']}, {ms:.3f} ms, "
          f"{1e3 / ms:.1f} frames/s, on {card}")
    del x2

    # 8b: hybrid at 1080p b2 on 4 shards, cuDNN (auto) and K6a (pallas),
    # f32 and bf16, against the single-device pipeline
    x = frames_u8(2, 1080, 1920, seed=9)
    hybrid = PipelineConfig(method="hybrid")
    params = EnhancePipeline(hybrid, device="cuda").model_params
    for conv, kernels in (("auto", ("k3",)), ("pallas", ("k6a", "k3"))):
        for dtype in ("float32", "bfloat16"):
            cfg = hybrid.replace(conv_impl=conv, compute_dtype=dtype)
            want = EnhancePipeline(cfg, model_params=params, device="cuda"
                                   ).enhance_batch_device(x).cpu().numpy()
            name = f"8b hybrid {conv} {dtype}"
            got = counted(name, kernels, lambda: enhance_spatial_sharded(
                planar(x), cfg, mesh(1, 4), params))
            got = got.permute(0, 2, 3, 1).cpu().numpy()
            lc = launches[name]
            if conv == "pallas" and lc["k6a"] != 6 * lc["k3"]:
                raise AssertionError(f"{name}: {lc['k6a']} K6a launches, "
                                     f"not 6 per K3 ({lc['k3']})")
            if dtype == "float32":
                check_bar(f"{name} 1080p b2 on 1x4 vs single device",
                          delta_stats(got, want))
            else:
                p = psnr(got, want)
                print(f"  {name} 1080p b2 on 1x4 vs single device: PSNR "
                      f"{p:.2f} dB")
                if p < 40.0:
                    raise AssertionError(f"{name}: PSNR {p:.2f} < 40 dB")
    del x

    # 8c: SpatialShardedVideoEnhancer against VideoEnhancer, 8 frames: 4K
    # retinex on 4 shards (K4, then K1's gain form), hybrid ds 4 at 1080p
    # on 2 shards (K3); frames/s by the host clock over frames 2-8
    def flicker(h, w, n=8):
        low, high = synth_pair_batch(gen.manual_seed(11), 1, h, w, dev)
        levels = torch.linspace(0.15, 0.25, n, device=dev)
        noise = torch.randn((n, 3, h, w), generator=gen, device=dev) * 0.005
        f = torch.clamp(high * levels[:, None, None, None] + noise, 0, 1)
        return list(quantize_u8(f).permute(0, 2, 3, 1).contiguous().cpu()
                    .numpy())

    video_cases = [
        ("8c video retinex 4K 1x4 K4", PipelineConfig(), True, 4,
         (2160, 3840), ("k4",)),
        ("8c video retinex 4K 1x4 gain form", PipelineConfig(), False, 4,
         (2160, 3840), ("k1",)),
        # f32 nets to the u8 bar; the default bf16 nets to PSNR >= 40 dB a
        # frame, as 8b: bf16 convs sum by other algorithms on a shard's
        # block than on the whole frame's
        ("8c video hybrid ds4 1080p 1x2 f32",
         PipelineConfig(method="hybrid", curve_downsample=4,
                        compute_dtype="float32"), True, 2, (1080, 1920),
         ("k3",)),
        ("8c video hybrid ds4 1080p 1x2 bf16",
         PipelineConfig(method="hybrid", curve_downsample=4), True, 2,
         (1080, 1920), ("k3",)),
    ]
    clips = {}
    for name, cfg, eik, ns, size, kernels in video_cases:
        if size not in clips:
            clips[size] = flicker(*size)
        clip = clips[size]
        sve = SpatialShardedVideoEnhancer(mesh(1, ns), cfg, alpha=0.3,
                                          device="cuda", ema_in_kernel=eik)
        ve = VideoEnhancer(cfg, alpha=0.3, model_params=sve.model_params,
                           device="cuda", ema_in_kernel=eik)

        def run_clip(enh):
            outs, t0 = [], 0.0
            for i, f in enumerate(clip):
                if i == 1:
                    t0 = time.perf_counter()
                outs.append(enh.process(f))
            return outs, (len(clip) - 1) / (time.perf_counter() - t0)

        got, fps = counted(name, kernels, lambda: run_clip(sve))
        want, fps_one = run_clip(ve)
        if cfg.compute_dtype == "float32" or cfg.method == "retinex":
            worst = max((delta_stats(a, b) for a, b in zip(got, want)),
                        key=lambda st: (st["max_abs"], st["changed_share"]))
            check_bar(f"{name} ({len(clip)} frames, worst frame) vs "
                      f"VideoEnhancer", worst)
        else:
            p = min(psnr(a, b) for a, b in zip(got, want))
            print(f"  {name} ({len(clip)} frames) vs VideoEnhancer: worst "
                  f"frame PSNR {p:.2f} dB")
            if p < 40.0:
                raise AssertionError(f"{name}: PSNR {p:.2f} < 40 dB")
        print(f"  {name}: {fps:.1f} frames/s sharded, {fps_one:.1f} "
              f"single device (host clock, frames 2-{len(clip)}), carry "
              f"{sve.carry_bytes} B, on {card}")
    del clips

    # 8d: data parallel. The default pipeline at 600x400 b48 through
    # shard_batch_fn on a (2, 1) mesh, Δ 0; config 3's step on a (2, 1)
    # mesh against one device (f32: TF32 off; bf16, TrainConfig() itself:
    # its convs sum by other algorithms at batch 8 than at 16, held to the
    # microbatch bar of 7c); the row-sharded paired step at 512^2 b4 on a
    # (1, 4) mesh; a process group of one on nccl
    pipe = EnhancePipeline(PipelineConfig(), device="cuda")
    x = frames_u8(48, 400, 600, seed=12)
    want = pipe.enhance_batch_device(x)
    got = counted("8d shard_batch_fn 2x1", ("k1",), lambda: shard_batch_fn(
        pipe.enhance_batch_device, mesh(2, 1))(x))
    dp = EnhancePipeline(PipelineConfig(data_shards=2), device="cuda")
    got_dp = counted("8d pipeline data_shards", ("k1",),
                     lambda: dp.enhance_batch_device(x))
    if not (torch.equal(got, want) and torch.equal(got_dp, want)):
        raise AssertionError("8d data-parallel pipeline differs from the "
                             "single device")
    print("  8d PipelineConfig() 600x400 b48 through shard_batch_fn on 2x1 "
          "and data_shards=2 (one card: 1 shard): Δ 0")
    del x, want, got, got_dp

    def step_check(what, make, tcfg, args, msh, bar, **kw):
        p0, o0 = tt.init_train_state(tcfg, seed=0)
        ref = make(tcfg)(p0, o0, *args)
        got = make(tcfg, msh, **kw)(p0, o0, *args)
        loss_rel = max_rel(float(got[2]["loss"]), float(ref[2]["loss"]))
        p_rel = params_rel(tt, got[0], ref[0])
        print(f"  {what}: loss rel {loss_rel:.2e}, params rel {p_rel:.2e}")
        if loss_rel > bar[0] or p_rel > bar[1]:
            raise AssertionError(f"{what}: loss rel {loss_rel:.2e}, params "
                                 f"rel {p_rel:.2e} > {bar}")
        return p0, o0, got

    low16, _ = synth_pair_batch(gen.manual_seed(13), 16, 512, 512,
                                dev)
    f32_bar = (TRAIN_DP_LOSS_REL, TRAIN_DP_PARAMS_REL)
    f32 = tt.TrainConfig(batch_size=16, compute_dtype="float32")
    p0, o0, got = step_check("8d config 3 (f32, 512x512 b16) on 2x1 vs one "
                             "device", tt.make_train_step, f32, (low16,),
                             mesh(2, 1), f32_bar)
    step_check("8d config 3 (TrainConfig(): bf16, 512x512 b16) on 2x1 vs "
               "one device", tt.make_train_step,
               tt.TrainConfig(batch_size=16), (low16,), mesh(2, 1),
               (TRAIN_BF16_REL, TRAIN_BF16_REL))
    low4, high4 = synth_pair_batch(gen.manual_seed(14), 4, 512, 512,
                                   dev)
    step_check("8d row-sharded paired curve step (f32, 512x512 b4) on 1x4 "
               "vs unsharded", tt.make_paired_curve_train_step,
               tt.TrainConfig(batch_size=4, compute_dtype="float32"),
               (low4, high4), mesh(1, 4), f32_bar, spatial_batch=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    # both steps under cudnn.deterministic: cuDNN's default backward
    # algorithms sum in a varying order (1e-9 of the params between two
    # runs of one step)
    torch.backends.cudnn.deterministic = True
    try:
        got = tt.make_train_step(f32, mesh(2, 1))(p0, o0, low16)
        initialize_distributed(f"localhost:{port}", num_processes=1,
                               process_id=0, device="cuda")
        try:
            size, backend = process_group_size(), dist.get_backend()
            pg = tt.make_train_step(f32, mesh(2, 1))(p0, o0, low16)
        finally:
            dist.destroy_process_group()
    finally:
        torch.backends.cudnn.deterministic = False
    p_rel = params_rel(tt, pg[0], got[0])
    equal = all(torch.equal(a, b) for a, b in
                zip(tt._leaves(pg[0]), tt._leaves(got[0])))
    print(f"  8d process group of {size} on {backend} "
          f"(initialize_distributed): its config-3 step (f32, b16) on 2x1 "
          f"vs the same without it, cudnn deterministic: loss "
          f"{float(pg[2]['loss'])!r} vs {float(got[2]['loss'])!r}, params "
          f"rel {p_rel:.2e}, {'bit-equal' if equal else 'not bit-equal'}")
    if size != 1 or backend != "nccl" or max_rel(float(pg[2]["loss"]), float(got[2]["loss"])) \
            > TRAIN_DP_LOSS_REL or p_rel > TRAIN_DP_PARAMS_REL:
        raise AssertionError("8d the process group's step differs")
    return paths, launches


# ------------------------------------------------------------- phase 9 --- #

# the toolkit ops on the card against the CPU port: each op's CPU bar
# against the JAX package (tests/test_torch_toolkit_ops.py), the FFT ops
# within 1e-4 on cuFFT
TOOLKIT_BARS = {"rgb_to_hsv": 1e-6, "hsv_to_rgb": 1e-6, "rgb_to_ycbcr": 1e-6,
                "ycbcr_to_rgb": 1e-6, "rgb_to_hvi": 1e-5, "hvi_to_rgb": 1e-5,
                "gaussian_blur": 0.0, "bilateral_denoise": 1e-6,
                "illumination_map": 1e-6, "retinex_enhance": 1e-6,
                "gamma_correct": 1e-6, "fourier_amplitude_boost": 1e-4,
                "amplitude_phase_swap": 1e-4, "autocontrast": 1e-6,
                "equalize_hist": 0.0, "clahe": 1e-5}


def mosaic_from_rgb(rgb_u8: np.ndarray) -> np.ndarray:
    """(..., H, W, 3) u8 -> (..., H, W) f32 RGGB mosaics: each Bayer site
    keeps its own channel (the ideal-sensor inverse of a demosaic), as the
    JAX package's bench config 8 makes its mosaics."""
    x = rgb_u8.astype(np.float32) / 255.0
    raw = np.empty(x.shape[:-1], np.float32)
    raw[..., 0::2, 0::2] = x[..., 0::2, 0::2, 0]
    raw[..., 0::2, 1::2] = x[..., 0::2, 1::2, 1]
    raw[..., 1::2, 0::2] = x[..., 1::2, 0::2, 1]
    raw[..., 1::2, 1::2] = x[..., 1::2, 1::2, 2]
    return raw


def phase9_raw(torch, card, wrappers, t_start):
    """RAW ingest (config 8: 600x400 b48 RGGB mosaics through
    enhance_raw_batch, the ISP then K1) and the toolkit ops on the card.
    Every check runs and prints before the first failure raises. Returns
    the paths' (name, kernels, never) and their launches."""
    from low_light_image_enhancement_tpu_torch import ops
    from low_light_image_enhancement_tpu_torch.config import PipelineConfig
    from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
    from low_light_image_enhancement_tpu_torch.io import codec
    from low_light_image_enhancement_tpu_torch.ops.isp import DEFAULT_CCM
    from low_light_image_enhancement_tpu_torch.pipeline import (
        EnhancePipeline,
        _isp_u8_hwc,
    )

    print(f"[9] ({time.perf_counter() - t_start:.0f} s) RAW (config 8) and "
          "the toolkit ops")
    dev = torch.device("cuda", 0)
    all_k = tuple(wrappers)
    paths, launches = [], {}
    failed = []

    def counted(name, kernels, run):
        never = tuple(k for k in all_k if k not in kernels)
        paths.append((name, kernels, never))
        for wr in wrappers.values():
            wr.launches = 0
        out = run()
        launches[name] = {k: wr.launches for k, wr in wrappers.items()}
        return out

    def bar(what, got, want):
        try:
            check_bar(what, delta_stats(got, want))
        except AssertionError as e:
            failed.append(str(e))

    # config 8: 48 mosaics of 600x400 from 8 seeded synthetic lows, tiled
    b, h, w = 48, 400, 600
    lows, _ = synth_batch(8, h, w, seed=0)
    raws = mosaic_from_rgb(np.tile(lows, (b // 8, 1, 1, 1)))
    pipe = EnhancePipeline(PipelineConfig(), device="cuda")
    cpu = EnhancePipeline(PipelineConfig(), device="cpu")
    got = counted("9 raw config8", ("k1",),
                  lambda: pipe.enhance_raw_batch(raws))
    k1 = launches["9 raw config8"]["k1"]
    print(f"  9a config 8 enhance_raw_batch 600x400 b48 on the card: "
          f"{got.shape} {got.dtype}, K1 launches {k1}, K1's canvas form "
          f"{launches['9 raw config8']['kc']}")
    if k1 != 1 or got.shape != (b, h, w, 3) or got.dtype != np.uint8:
        failed.append(f"9a config 8: {k1} K1 launches (not 1), "
                      f"{got.shape} {got.dtype}")
    # the 8 distinct mosaics against the CPU port (each image's ISP and
    # enhance are its own)
    bar("9a config 8 cuda vs cpu (the 8 distinct mosaics)", got[:8],
        cpu.enhance_raw_batch(raws[:8]))
    x = torch.from_numpy(raws).to(dev)
    srgb = _isp_u8_hwc(x, None, DEFAULT_CCM, 1.0 / 2.2)
    staged = pipe.enhance_batch_device(srgb)
    fused = pipe.enhance_raw_batch_device(x)
    same = torch.equal(staged, fused) and np.array_equal(
        fused.cpu().numpy(), got)
    print(f"  9a ISP u8 -> enhance_batch_device vs enhance_raw_batch: "
          f"{'Δ 0' if same else 'DIFFERENT'}")
    if not same:
        failed.append("9a ISP u8 -> enhance_batch_device differs from "
                      "enhance_raw_batch")
    # a 12-bit sensor in u16 with DNs above its white level, explicit gains
    u16 = np.round(raws[:8] * 4095.0).astype(np.uint16)
    u16[:, ::7, ::5] = 5000
    kw = dict(white_level=4095, wb_gains=(1.6, 1.0, 1.4))
    bar("9a white_level 4095, wb_gains (1.6, 1, 1.4), u16 600x400 b8 "
        "cuda vs cpu", pipe.enhance_raw_batch(u16, **kw),
        cpu.enhance_raw_batch(u16, **kw))
    # hybrid (the curve CNN, then K3), bf16 nets, on a small input
    small = mosaic_from_rgb(synth_batch(2, 128, 192, seed=3)[0])
    hyb = EnhancePipeline(PipelineConfig(method="hybrid"), device="cuda")
    got_h = counted("9 raw hybrid", ("k3",),
                    lambda: hyb.enhance_raw_batch(small))
    p = psnr(got_h, EnhancePipeline(PipelineConfig(method="hybrid"),
                                    device="cpu").enhance_raw_batch(small))
    print(f"  9a --method hybrid enhance_raw_batch 192x128 b2 cuda vs cpu: "
          f"PSNR {p:.2f} dB, K3 launches "
          f"{launches['9 raw hybrid']['k3']}")
    if p < 40.0:
        failed.append(f"9a hybrid RAW PSNR {p:.2f} < 40 dB")
    # spatial_shards=4: one card clamps it to the single-device path
    sh = EnhancePipeline(PipelineConfig(spatial_shards=4), device="cuda")
    got_s = counted("9 raw spatial_shards 4", ("k1",),
                    lambda: sh.enhance_raw_batch(raws))
    same = np.array_equal(got_s, got)
    print(f"  9a spatial_shards=4 (one card: the single-device path) vs "
          f"the default: {'Δ 0' if same else 'DIFFERENT'}, K1 launches "
          f"{launches['9 raw spatial_shards 4']['k1']}")
    if not same:
        failed.append("9a spatial_shards=4 RAW differs")
    # the CLI in a process of its own
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = Path(tmp) / "in.npy", Path(tmp) / "out.png"
        np.save(src, np.round(raws[0] * 65535.0).astype(np.uint16))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "low_light_image_enhancement_tpu_torch.cli",
             "enhance", "--raw", str(src), str(dst)],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        ok = proc.returncode == 0 and dst.exists() and np.array_equal(
            codec.decode_image(dst), pipe.enhance_raw(np.load(src)))
        print(f"  9a llie-torch enhance --raw in.npy out.png: rc "
              f"{proc.returncode} in {time.perf_counter() - t0:.1f} s, "
              f"{'equal to' if ok else 'NOT equal to'} enhance_raw")
        if not ok:
            failed.append(f"9a llie-torch enhance --raw: rc "
                          f"{proc.returncode} {proc.stderr[-2000:]}")

    # 9b timings, device-resident: CUDA events around each call, median of
    # 5 after a warm-up (the calls' host launches included)
    isp_ms = median_ms(torch, lambda: _isp_u8_hwc(x, None, DEFAULT_CCM,
                                                  1.0 / 2.2))
    raw_ms = median_ms(torch, lambda: pipe.enhance_raw_batch_device(x))
    k1_ms = median_ms(torch, lambda: pipe.enhance_batch_device(srgb))
    print(f"  9b config 8 (600x400 b48) device-resident on {card}: ISP "
          f"{isp_ms:.3f} ms, ISP + K1 {raw_ms:.3f} ms ({b * 1e3 / raw_ms:.1f}"
          f" img/s), K1 alone on the ISP's u8 {k1_ms:.3f} ms "
          f"({b * 1e3 / k1_ms:.1f} img/s); ISP {isp_ms / raw_ms:.1%}, K1 "
          f"{k1_ms / raw_ms:.1%} of the RAW call")
    del x, srgb, staged, fused

    # 9c the toolkit ops at 1080p on the card against the CPU port
    rng = np.random.default_rng(9)
    a = rng.random((1, 3, 1080, 1920), dtype=np.float32) * 0.6
    a2 = rng.random((1, 3, 1080, 1920), dtype=np.float32)

    def on_cpu(fn, v):
        return fn(torch.from_numpy(v)).numpy()

    cases = [
        ("rgb_to_hsv", ops.rgb_to_hsv, (a,)),
        ("hsv_to_rgb", ops.hsv_to_rgb, (on_cpu(ops.rgb_to_hsv, a),)),
        ("rgb_to_ycbcr", ops.rgb_to_ycbcr, (a,)),
        ("ycbcr_to_rgb", ops.ycbcr_to_rgb, (on_cpu(ops.rgb_to_ycbcr, a),)),
        ("rgb_to_hvi", ops.rgb_to_hvi, (a,)),
        ("hvi_to_rgb", ops.hvi_to_rgb, (on_cpu(ops.rgb_to_hvi, a),)),
        ("gaussian_blur", ops.gaussian_blur, (a,)),
        ("bilateral_denoise", ops.bilateral_denoise, (a,)),
        ("illumination_map", ops.illumination_map, (a,)),
        ("retinex_enhance", ops.retinex_enhance, (a,)),
        ("gamma_correct", lambda t: ops.gamma_correct(t, 0.45), (a,)),
        ("fourier_amplitude_boost",
         lambda t: ops.fourier_amplitude_boost(t, 1.5, preserve_dc=True),
         (a,)),
        ("amplitude_phase_swap", ops.amplitude_phase_swap, (a, a2)),
        ("autocontrast", ops.autocontrast, (a,)),
        ("equalize_hist", ops.equalize_hist, (a,)),
        ("clahe", ops.clahe, (a,)),
    ]
    for name, fn, args in cases:
        want = fn(*(torch.from_numpy(v) for v in args)).numpy()
        dargs = [torch.from_numpy(v).to(dev) for v in args]
        got = fn(*dargs).cpu().numpy()
        err = float(np.abs(got.astype(np.float64) - want).max())
        ms = median_ms(torch, lambda: fn(*dargs))
        ok = got.shape == want.shape and err <= TOOLKIT_BARS[name]
        print(f"  9c {name} 1080p cuda vs cpu: max |d| {err:.3g} (bar "
              f"{TOOLKIT_BARS[name]:g}) {'ok' if ok else 'FAILED'}, "
              f"{ms:.3f} ms on {card}")
        if not ok:
            failed.append(f"9c {name}: max |d| {err:.3g} > "
                          f"{TOOLKIT_BARS[name]:g}")
    # autocontrast on a 4K frame: 24.9M values, past torch.quantile's 2**24
    big = rng.random((1, 3, 2160, 3840), dtype=np.float32)
    want = ops.autocontrast(torch.from_numpy(big)).numpy()
    got = ops.autocontrast(torch.from_numpy(big).to(dev)).cpu().numpy()
    err = float(np.abs(got - want).max())
    print(f"  9c autocontrast 2160x3840 (24.9M values) cuda vs cpu: max |d| "
          f"{err:.3g}")
    if err > TOOLKIT_BARS["autocontrast"]:
        failed.append(f"9c autocontrast 4K: max |d| {err:.3g}")
    if failed:
        raise AssertionError("phase 9 failed: " + "; ".join(failed))
    return paths, launches


# ------------------------------------------------------------ phase 10 --- #

# 10d: one of two processes that share cuda:0 over gloo (NCCL refuses two
# ranks on one device), each holding its rows of a spatial mesh that spans
# both; argv: rank, port. Prints one line "RESULT {json}".
PHASE10D_CHILD = r"""
import json, math, sys, time
import torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
pid, port = int(sys.argv[1]), int(sys.argv[2])
from low_light_image_enhancement_tpu_torch.blocks import block_geometry
from low_light_image_enhancement_tpu_torch.config import (
    PRESETS, PipelineConfig)
from low_light_image_enhancement_tpu_torch.data.synth_device import (
    synth_pair_batch)
from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.ops.colorspace import quantize_u8
from low_light_image_enhancement_tpu_torch.parallel import (
    enhance_spatial_sharded, make_mesh)
from low_light_image_enhancement_tpu_torch.parallel.distributed import (
    initialize_distributed)
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline

initialize_distributed(f"127.0.0.1:{port}", num_processes=2, process_id=pid,
                       device="cuda", backend="gloo")
_build.load_library()
dev = torch.device("cuda", 0)
res = {"pid": pid, "build": dict(_build.LAST_BUILD)}
gen = torch.Generator(device=dev)


def planar_u8(h, w, seed):
    low, _ = synth_pair_batch(gen.manual_seed(seed), 1, h, w, dev)
    return quantize_u8(low)


def cross(name, cfg, params, x, n_sp, hl):
    # this process's rows of the mesh that spans both, against the same
    # mesh in one process and the single-device pipeline
    k = n_sp // 2
    mine = slice(pid * k * hl, min((pid + 1) * k * hl, x.shape[-2]))
    mesh = make_mesh(1, n_sp, [dev] * k)
    part = x[:, :, mine].contiguous()
    got = enhance_spatial_sharded(part, cfg, mesh, params)
    one = enhance_spatial_sharded(x, cfg, make_mesh(1, n_sp, [dev] * n_sp),
                                  params)[:, :, mine]
    single = EnhancePipeline(cfg.replace(spatial_shards=1), device="cuda",
                             model_params=params)
    want = single.enhance_batch_device(
        x.permute(0, 2, 3, 1).contiguous()).permute(0, 3, 1, 2)[:, :, mine]
    d = (got.int() - want.int()).abs()
    mse = ((got.double() - want.double()) ** 2).mean().item()
    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t = time.perf_counter()
        enhance_spatial_sharded(part, cfg, mesh, params)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    res[name] = {
        "rows": [mine.start, mine.stop], "shape": list(got.shape),
        "vs_one_process_max": int((got.int() - one.int()).abs().max()),
        "vs_single_max": int(d.max()),
        "vs_single_share": float((d > 0).float().mean()),
        "vs_single_psnr": (float("inf") if mse == 0
                           else 10 * math.log10(255.0 ** 2 / mse)),
        "ms_median_of_3": sorted(times[1:])[1]}


cfg5 = PRESETS["config5_4k_sharded"]
h, w = 2160, 3840
cross("config5 2160x3840 b1 2x4", cfg5, None, planar_u8(h, w, 10), 8,
      -(-math.ceil(h / 8) // 8) * 8)
curve = PipelineConfig(method="curve")
params = EnhancePipeline(curve, device="cuda").model_params
cross("curve 1080x1920 b1 2x2", curve, params, planar_u8(1080, 1920, 11), 4,
      block_geometry(curve, 1080, 1920, n_shards=4)[0])
print("RESULT " + json.dumps(res), flush=True)
"""


# 10c: one enhance_batch_device call of the default config (K1) inside
# stage("enhance") under profile_trace; argv: the trace's directory
PHASE10C_CHILD = r"""
import sys
import torch
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline
from low_light_image_enhancement_tpu_torch.utils import profile_trace, stage

dev = torch.device("cuda", 0)
x = torch.randint(0, 80, (8, 400, 600, 3), dtype=torch.uint8, device=dev,
                  generator=torch.Generator(device=dev).manual_seed(22))
pipe = EnhancePipeline(PipelineConfig(), device="cuda")
pipe.enhance_batch_device(x)
torch.cuda.synchronize()
with profile_trace(sys.argv[1]):
    with stage("enhance"):
        pipe.enhance_batch_device(x)
    torch.cuda.synchronize()
"""


def phase10_conv_arms_utils(torch, card, wrappers, t_start):
    """The conv_impl arms gemm, packed and packed12 (ops/patch_conv.py) on
    the card at full width, their times beside xla/pallas/cascade, the
    utils (checked, profile_trace, stage, the per-source build) and halos
    across two processes. Every check runs and prints before the first
    failure raises. Returns the paths' (name, kernels, never) and their
    launches."""
    import socket

    from low_light_image_enhancement_tpu_torch.config import (
        MARGIN,
        PRESETS,
        PipelineConfig,
    )
    from low_light_image_enhancement_tpu_torch.data.synth_device import (
        synth_pair_batch,
    )
    from low_light_image_enhancement_tpu_torch.kernels import _build
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance_hwc as hw,
    )
    from low_light_image_enhancement_tpu_torch.kernels.striping import (
        plan_canvas,
    )
    from low_light_image_enhancement_tpu_torch.ops.colorspace import (
        quantize_u8,
    )
    from low_light_image_enhancement_tpu_torch.pipeline import (
        EnhancePipeline,
    )
    from low_light_image_enhancement_tpu_torch.utils import (
        profile_trace,
        stage,
    )
    from low_light_image_enhancement_tpu_torch.utils.debug import checked
    from low_light_image_enhancement_tpu_torch.utils.profiling import (
        DeviceEventsLost,
    )

    print(f"[10] ({time.perf_counter() - t_start:.0f} s) the conv arms "
          "gemm/packed/packed12, the utils, halos across processes")
    dev = torch.device("cuda", 0)
    all_k = tuple(wrappers)
    paths, launches = [], {}
    failed = []
    gen = torch.Generator(device=dev)

    def counted(name, kernels, run):
        never = tuple(k for k in all_k if k not in kernels)
        paths.append((name, kernels, never))
        for wr in wrappers.values():
            wr.launches = 0
        out = run()
        launches[name] = {k: wr.launches for k, wr in wrappers.items()}
        return out

    def frames_u8(b, h, w, seed):
        low, _ = synth_pair_batch(gen.manual_seed(seed), b, h, w, dev)
        return quantize_u8(low).permute(0, 2, 3, 1).contiguous()

    def bar(what, got, want, f32):
        """float32 nets: the u8 bar; bf16 nets: PSNR >= 40 dB."""
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if f32:
            try:
                check_bar(what, delta_stats(got, want))
            except AssertionError as e:
                failed.append(str(e))
            return
        st = delta_stats(got, want)
        p = psnr(got, want)
        print(f"  {what}: PSNR {p:.2f} dB, max|du8|={st['max_abs']} "
              f"changed={st['changed_share']:.3e}")
        if p < 40.0:
            failed.append(f"{what}: PSNR {p:.2f} < 40 dB")

    # 10a: each arm at 600x400 b48 with the shipped weights, against the
    # card's xla arm on the same weights, then on the CPU at 192x128 b2
    x48 = frames_u8(48, 400, 600, seed=20)
    x2 = frames_u8(2, 128, 192, seed=21)
    presets = {"hybrid": (PipelineConfig(method="hybrid"), "k3"),
               "quality_fast": (PRESETS["quality_fast"], "k5"),
               "quality": (PRESETS["quality"], "k5")}
    arms = [(name, impl, "bfloat16") for name in presets
            for impl in ("gemm", "packed", "packed12")]
    arms.append(("hybrid", "packed", "float32"))
    for name, impl, dt in arms:
        base, k = presets[name]
        cfg = base.replace(conv_impl=impl, compute_dtype=dt)
        f32 = dt == "float32"
        what = f"10a {name} {impl} {dt}"
        pipe = EnhancePipeline(cfg, device="cuda")
        got = counted(what, (k,), lambda: pipe.enhance_batch_device(x48))
        n = launches[what][k]
        print(f"  {what} 600x400 b48: {k.upper()} launches {n}")
        if n != 1:
            failed.append(f"{what}: {n} {k} launches, not 1 (one block)")
        ref = EnhancePipeline(cfg.replace(conv_impl="xla"), device="cuda")
        bar(f"{what} vs the card's xla arm", got,
            ref.enhance_batch_device(x48), f32)
        cpu = EnhancePipeline(cfg, device="cpu")
        bar(f"{what} 192x128 b2 cuda vs cpu", pipe.enhance_batch_device(x2),
            cpu.enhance_batch_device(x2.cpu()), f32)
        del pipe, ref, got

    # 10b: each arm's time beside xla and pallas (cascade for fcn), CUDA
    # events around each call, median of 5 after a warm-up
    print(f"  10b ms a call (median of 5) at 600x400 b48 on {card}:")
    for name, (base, _) in presets.items():
        impls = ["xla", "pallas"] + (["cascade"] if name == "quality_fast"
                                     else []) + ["gemm", "packed",
                                                 "packed12"]
        for dt in (("bfloat16", "float32") if name == "hybrid"
                   else ("bfloat16",)):
            row = []
            for impl in impls if dt == "bfloat16" else ["xla", "packed"]:
                pipe = EnhancePipeline(
                    base.replace(conv_impl=impl, compute_dtype=dt),
                    device="cuda")
                ms = median_ms(torch, lambda: pipe.enhance_batch_device(x48))
                row.append(f"{impl} {ms:.3f} ms ({48e3 / ms:.1f} img/s)")
                del pipe
            print(f"    {name} {dt}: " + ", ".join(row))
    del x48
    torch.cuda.empty_cache()

    # 10c: the utils
    try:
        checked(torch.log)(torch.tensor([-1.0], device=dev))
        failed.append("10c checked let a NaN made by a CUDA op pass")
    except FloatingPointError as e:
        print(f"  10c checked on the card raised: {e}")
    cfg0 = PipelineConfig()
    xk = frames_u8(8, 400, 600, seed=22)
    plain = fe.fused_retinex(xk, cfg0)
    clean = checked(fe.fused_retinex)(xk, cfg0)
    print(f"  10c checked K1 (600x400 b8): "
          f"{'passes, equal' if torch.equal(clean, plain) else 'DIFFERS'}")
    if not torch.equal(clean, plain):
        failed.append("10c checked K1 differs from K1")
    # the trace in this process, after phases 7b-9: it names the stage and
    # K1, or, where torch's profiler dropped the card's activity (it does
    # now and then in a process that ran an earlier session, PERF.md §7),
    # profile_trace raises DeviceEventsLost; never an empty trace untold
    pipe0 = EnhancePipeline(cfg0, device="cuda")
    pipe0.enhance_batch_device(xk)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        try:
            with profile_trace(tmp):
                with stage("enhance"):
                    pipe0.enhance_batch_device(xk)
                torch.cuda.synchronize()
            raised = None
        except DeviceEventsLost as e:
            raised = e
        traces = list(Path(tmp).glob("*.json"))
        ev = json.loads(traces[0].read_text())["traceEvents"] if traces \
            else []
    k1 = sorted({e["name"] for e in ev
                 if "retinex_tile_kernel" in e.get("name", "")})
    named = any(e.get("name") == "enhance" for e in ev) and bool(k1)
    kernels = sum(1 for e in ev if e.get("cat") == "kernel")
    print(f"  10c profile_trace of one enhance_batch_device call in "
          f"stage('enhance') in this process, after phases 7b-9: "
          f"{len(ev)} events, {kernels} kernel events; "
          + (f"raised DeviceEventsLost: {raised}" if raised else
             f"the stage and K1's kernel "
             f"{'named' if named else 'NOT both named'}"))
    if not (named or (raised and kernels == 0 and len(traces) == 1)):
        failed.append("10c profile_trace in this process neither named the "
                      "stage and K1 nor raised DeviceEventsLost")
    del pipe0
    # and in a process of its own
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        proc = subprocess.run([sys.executable, "-c", PHASE10C_CHILD, tmp],
                              cwd=ROOT, capture_output=True, text=True,
                              timeout=300)
        traces = list(Path(tmp).glob("*.json"))
        ev = (json.loads(traces[0].read_text())["traceEvents"]
              if proc.returncode == 0 and traces else [])
    k1 = sorted({e["name"] for e in ev
                 if "retinex_tile_kernel" in e.get("name", "")})
    named = any(e.get("name") == "enhance" for e in ev) and bool(k1)
    print(f"  10c profile_trace of one enhance_batch_device call in "
          f"stage('enhance') (a process of its own, rc {proc.returncode}): "
          f"{len(ev)} events, {len(traces)} trace file; the stage and K1's "
          f"kernel {'named' if named else 'NOT both named'} "
          f"({k1[0][:70] if k1 else 'no K1 event'})")
    if not named:
        failed.append(f"10c the trace does not name the stage and K1: "
                      f"{proc.stderr[-2000:]}")
    lb = _build.LAST_BUILD
    print(f"  10c kernel library (phase 2): {lb.get('seconds', 0):.1f} s, "
          f"{lb.get('built')} objects built, {lb.get('reused')} reused, in "
          f"{_build.BUILD_DIR}")
    # one source changed: a copy of csrc with a comment added to
    # fused_enhance.cu, built into the same directory (its other objects
    # are reused); the library this process loaded stays loaded
    import shutil

    saved = _build._CSRC
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        shutil.copytree(saved, Path(tmp) / "csrc")
        src = Path(tmp) / "csrc" / "fused_enhance.cu"
        src.write_text(src.read_text() + "\n// changed\n")
        try:
            _build._CSRC = Path(tmp) / "csrc"
            _build._compile(_build.library_path())
        finally:
            _build._CSRC = saved
    one = dict(_build.LAST_BUILD)
    print(f"  10c the library with one source changed (fused_enhance.cu): "
          f"{one['seconds']:.1f} s, {one['built']} object built, "
          f"{one['reused']} reused")
    if one["built"] != 1:
        failed.append(f"10c one source changed rebuilt {one['built']}")

    # 10e: fused_retinex_hwc, K8 on the edge-padded HWC canvas (the JAX
    # function's contract), 600x400 b8, against its plain version on the
    # same canvas (the whole canvas, Δu8 0) and against enhance_hwc_u8 on
    # the image (the crop, Δu8 0)
    hcfg = PipelineConfig(denoise_guide="perchannel", denoise_taps="full")
    plan = plan_canvas(400, 600, MARGIN)
    imgs = frames_u8(8, 400, 600, seed=23)
    canvas = hw.pad_hwc(imgs, plan, 400, 600)
    what = "10e fused_retinex_hwc 600x400 b8"
    got = counted(what, ("k8",),
                  lambda: hw.fused_retinex_hwc(canvas, hcfg, plan))
    plain = hw.enhance_hwc_u8_plain(canvas, hcfg)[
        :, MARGIN:plan.padded_h - MARGIN]
    crop = got[:, :400, MARGIN:MARGIN + 600]
    for vs, want, have in (("its plain version", plain, got),
                           ("enhance_hwc_u8 on the image",
                            hw.enhance_hwc_u8(imgs, hcfg), crop)):
        st = delta_stats(have.cpu().numpy(), want.cpu().numpy())
        print(f"  {what} {tuple(got.shape)} vs {vs}: max|du8|="
              f"{st['max_abs']} hist={st['hist']}; K8 launches "
              f"{launches[what]['k8']}")
        if st["max_abs"]:
            failed.append(f"{what} differs from {vs}: {st}")
    del imgs, canvas, got, plain, crop

    # 10d: two processes on cuda:0 over gloo, each holding its rows of a
    # spatial mesh that spans both
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", PHASE10D_CHILD,
                               str(pid), str(port)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    except subprocess.TimeoutExpired:
        failed.append("10d a process did not finish in 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
        if p.returncode != 0 or not lines:
            failed.append(f"10d process rc {p.returncode}: {err[-2000:]}")
            continue
        res = json.loads(lines[-1][len("RESULT "):])
        print(f"  10d process {res['pid']} of 2 (gloo, cuda:0; library "
              f"built {res['build']['built']} objects, reused "
              f"{res['build']['reused']}):")
        if res["build"]["built"] != 0:
            failed.append("10d a child process rebuilt the library")
        for name, r in res.items():
            if not isinstance(r, dict) or "rows" not in r:
                continue
            print(f"    {name}: rows {r['rows']} {r['shape']}: vs the mesh "
                  f"in one process max|du8| {r['vs_one_process_max']}; vs "
                  f"the single-device pipeline max|du8| "
                  f"{r['vs_single_max']} changed {r['vs_single_share']:.3e}"
                  f" PSNR {r['vs_single_psnr']:.2f} dB; "
                  f"{r['ms_median_of_3']:.1f} ms a call (host clock)")
            if r["vs_one_process_max"] != 0:
                failed.append(f"10d {name}: differs from one process")
            if name.startswith("config5") and r["vs_single_max"] != 0:
                failed.append(f"10d {name}: differs from the single device")
            if name.startswith("curve") and r["vs_single_psnr"] < 40.0:
                failed.append(f"10d {name}: PSNR < 40 dB vs single device")
    print(f"  10d took {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("phase 10 failed: " + "; ".join(failed))
    return paths, launches


# ------------------------------------------------------------ phase 11 --- #

BENCH_METHODS = {"retinex": ("k1",), "curve": ("k3",), "hybrid": ("k3",),
                 "fcn": ("k5",), "decom": ("k5",)}


def phase11_bench(torch, card, wrappers, t_start, k1_ms=None):
    """The port's throughput bench (bench.py) on the card at 600x400 b48:
    each method's device chain (a CUDA graph a chain), its graph against
    the eager chain (Δu8 0), the kernels each capture holds (one count a
    captured launch: the wrappers count when a launch is captured, and a
    replay runs the graph without them), retinex's Python chain and canvas
    rate, then ``python -m low_light_image_enhancement_tpu_torch.bench``
    in a process of its own. Every check runs and prints before the first
    failure raises. Returns the paths' (name, kernels, never) and their
    launches."""
    from low_light_image_enhancement_tpu_torch import bench as tb

    t0 = time.perf_counter()
    print(f"[11] bench: bench_throughput at 600x400 b48 "
          f"({t0 - t_start:.0f} s)")
    key_of = {wr.__name__: k for k, wr in wrappers.items()}
    all_k = tuple(wrappers)
    paths, launches, failed = [], {}, []
    b, h, w, n_short, n_long, repeats = 48, 400, 600, 8, 60, 3

    def counted(name, kernels, run):
        never = tuple(k for k in all_k if k not in kernels)
        paths.append((name, kernels, never))
        for wr in wrappers.values():
            wr.launches = 0
        out = run()
        launches[name] = {k: wr.launches for k, wr in wrappers.items()}
        return out

    def roof(res):
        return ", ".join(f"{k} {res[k]}" for k in res
                         if k.startswith("achieved_")
                         or k.endswith("_util_pct")
                         or k == "roofline_bound")

    for method, kernels in BENCH_METHODS.items():
        chains = [("device", kernels + (("kc",) if method == "retinex"
                                        else ()))]
        if method == "retinex":
            chains.append(("python", kernels))
        for chain, ks in chains:
            name = f"11 bench {method} {chain}"
            t1 = time.perf_counter()
            res = counted(name, ks, lambda: tb.bench_throughput(
                batch=b, h=h, w=w, repeats=repeats, n_short=n_short,
                n_long=n_long, method=method, chain=chain, device="cuda"))
            rates = res["rates"]
            print(f"  {method} {chain} chain: {res['images_per_sec']:.1f} "
                  f"img/s (median of {len(rates)}; min "
                  f"{res['rate_min']:.1f}, max {res['rate_max']:.1f}, IQR "
                  f"{res['rate_iqr_pct']:.2f}%; rates {rates}; "
                  f"{res['n_fallback']} total-time fallbacks); roofline: "
                  f"{roof(res)}; {time.perf_counter() - t1:.1f} s; on "
                  f"{card}")
            if min(rates) <= 0:
                failed.append(f"{name}: a rate is not positive: {rates}")
            if chain == "python":
                continue
            held = {key_of[k]: n for k, n in res["graph_launches"].items()}
            want = {k: n_short for k in kernels}
            print(f"    the {n_short}-step graph holds {held} (captured "
                  f"launches); its output against the eager chain's: max "
                  f"|du8| {res['graph_max_abs_du8']}; the {n_long}-step "
                  f"capture's peak memory "
                  f"{res['capture_peak_bytes'] / 2**30:.2f} GiB")
            if held != want:
                failed.append(f"{name}: the graph holds {held}, not {want}")
            if res["graph_max_abs_du8"] != 0:
                failed.append(f"{name}: graph differs from the eager chain")
            if res["n_fallback"]:
                failed.append(f"{name}: {res['n_fallback']} repeats had no "
                              "positive marginal time")
            if method == "retinex":
                c_held = {key_of[k]: n for k, n
                          in res["canvas_graph_launches"].items()}
                print(f"    canvas rate (the bottom rows' re-pad, then K1's "
                      f"canvas form): "
                      f"{res['canvas_images_per_sec']} img/s; its graph "
                      f"holds {c_held}; 48 / K1's phase-3 time: "
                      + (f"{b * 1e3 / k1_ms:.1f} img/s" if k1_ms
                         else "not measured"))
                if c_held != {"kc": n_short}:
                    failed.append(f"{name}: the canvas graph holds {c_held}")
                if not res["canvas_images_per_sec"]:
                    failed.append(f"{name}: no canvas rate")

    # the module's main in a process of its own: its last line
    t1 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m",
             "low_light_image_enhancement_tpu_torch.bench",
             "--repeats", "5", "--watchdog", "240"],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        line = json.loads(lines[-1]) if proc.returncode == 0 and lines \
            else {}
        print(f"  python -m ...bench (rc {proc.returncode}, "
              f"{time.perf_counter() - t1:.1f} s): {json.dumps(line)}")
        print(f"    stderr: {proc.stderr.strip().splitlines()[-1:]}")
        if (line.get("metric") != "images_per_sec_per_chip_600x400"
                or not line.get("value", 0) > 0
                or not line.get("power_limit")):
            failed.append(f"bench main: rc {proc.returncode}, last line "
                          f"{lines[-1:]}, stderr {proc.stderr[-2000:]}")
    except subprocess.TimeoutExpired:
        failed.append("bench main did not finish in 300 s")
    print(f"  phase 11 took {time.perf_counter() - t0:.1f} s")
    if failed:
        raise AssertionError("phase 11 failed: " + "; ".join(failed))
    return paths, launches


def main() -> int:
    t_start = time.perf_counter()
    import torch
    import torch.nn.functional as F

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
        fcn_cascade as fc,
    )
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance as fe,
    )
    from low_light_image_enhancement_tpu_torch.kernels import (
        fused_enhance_hwc as hw,
    )
    from low_light_image_enhancement_tpu_torch.kernels import mxu_conv as mx
    from low_light_image_enhancement_tpu_torch.kernels import (
        tiled_denoise as td,
    )
    from low_light_image_enhancement_tpu_torch.ops.colorspace import (
        normalize_u8,
        quantize_u8,
    )
    from low_light_image_enhancement_tpu_torch.core import pad_planar
    from low_light_image_enhancement_tpu_torch.data.lol import LOLDataset
    from low_light_image_enhancement_tpu_torch.eval.runner import eval_lol
    from low_light_image_enhancement_tpu_torch.http_server import (
        HttpEnhanceServer,
    )
    from low_light_image_enhancement_tpu_torch.io import codec
    from low_light_image_enhancement_tpu_torch.kernels.striping import (
        plan_canvas,
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
          f"{lib_path.name} ({_build.LAST_BUILD.get('built')} objects "
          f"compiled, {_build.LAST_BUILD.get('reused')} reused, in "
          f"{_build.BUILD_DIR})")
    # the tile plan of K1/K4/K3 (retinex_tile.cuh) against its CPU mirror
    sys.path.insert(0, str(Path(__file__).resolve().parent / "tests"))
    from test_torch_retinex_tile import tile_plan
    lib = _build.load_library()
    bad = [(f, r, w) for f in (0, 1, 2, 3) for r in range(10)
           for w in range(12)
           if lib.llie_retinex_tile_plan(f, r, w) != tile_plan(f, r, w)]
    if bad:
        raise AssertionError(f"llie_retinex_tile_plan differs from its "
                             f"mirror at {bad}")
    print("  llie_retinex_tile_plan equals its CPU mirror (K1, K4 and K3, "
          "radii 0-8, 11 values each: K3's curve strips and the low-res "
          "rows they blend at ds 2 and 4; out-of-range arguments)")
    # the guided kernel's plan (fused_guided.cuh) against its CPU mirror in
    # tests/test_torch_guided_tile.py: shared memory, blocks an SM, planes
    from test_torch_guided_tile import guided_plan
    bad = [(f, r, j, w) for f in range(5) for r in range(10) for j in (0, 1)
           for w in (2, 4, 5, 6)
           if lib.llie_fused_guided_plan(f, r, j, w)
           != guided_plan(f, r, j, w)]
    if bad:
        raise AssertionError(f"llie_fused_guided_plan differs from its "
                             f"mirror at {bad}")
    print("  llie_fused_guided_plan equals its CPU mirror (the four "
          "families, radii 0-9, both guides: shared memory, blocks an SM, "
          "guided_tile's planes, the staging's scratch)")
    # the blur plane's plan (fused_enhance.cu) and K5's bilateral shared
    # memory (tiled_denoise.cu) against their CPU mirrors in
    # tests/test_torch_blur_tile.py and tests/test_torch_denoise_tile.py
    from test_torch_blur_tile import blur_plan
    from test_torch_denoise_tile import K5_SMEM_BYTES
    radii = list(range(0, 70)) + [100, 127, 128, 129, 500, 2000]
    bad = [(r, f, w) for r in radii for f in (-1, 0, 3, 4)
           for w in list(range(-1, 13)) + [16]
           if lib.llie_blur_plan(r, f, w) != blur_plan(r, f, w)]
    if bad:
        raise AssertionError(f"llie_blur_plan differs from its mirror at "
                             f"{bad[:20]}")
    if lib.llie_tiled_denoise_bilateral_plan(2) != K5_SMEM_BYTES:
        raise AssertionError("K5's bilateral shared memory differs from "
                             "its mirror")
    print(f"  llie_blur_plan equals its CPU mirror (radii 0-69, 100, 127-"
          f"129, 500, 2000: chunks, pitches, shared memory, tap blocks; "
          f"r 16 {lib.llie_blur_plan(16, 1, 0)} B, r 64 "
          f"{lib.llie_blur_plan(64, 1, 3)} x {lib.llie_blur_plan(64, 1, 6)} "
          f"chunks); K5's bilateral {K5_SMEM_BYTES} B")

    dev = torch.device("cuda")
    cfg0 = llt.PipelineConfig()
    hybrid, curve = (llt.PipelineConfig(method="hybrid"),
                     llt.PipelineConfig(method="curve"))
    quality, quality_fast = llt.PRESETS["quality"], llt.PRESETS["quality_fast"]
    params = {name: llt.EnhancePipeline(c, device="cuda").model_params
              for name, c in (("hybrid", hybrid), ("curve", curve),
                              ("decom", quality), ("fcn", quality_fast))}
    wrappers = {"k1": fe.fused_retinex, "k3": fe.fused_curve_enhance,
                "k4": fe.fused_retinex_ema, "k5": td.tiled_denoise,
                "k6a": mx.conv2d_patch_mxu, "k6b": mx.conv2d_dense9_mxu,
                "k7": fc.fcn_cascade_mxu, "k8": hw.enhance_hwc_u8,
                "kb": fe.blur_illumination, "kg": fe.fused_guided,
                "kc": fe.fused_retinex_canvas}
    err = {"k1": 0, "k3": 0, "k4": 0, "k5": 0.0, "k6a": 0.0, "k6b": 0.0,
           "k7": 0.0, "k8": 0, "kb": 0.0, "kg": 0, "kc": 0}
    hwc_cfg = llt.PipelineConfig(denoise_guide="perchannel",
                                 denoise_taps="full")

    print(f"[3] kernels against their plain versions on the card "
          f"({time.perf_counter() - t_start:.0f} s)")
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
    # edges of the 32 x 64 tile of retinex_tile.cu: exactly one tile and
    # one tile + 1 in each direction, widths off a multiple of 4 (HWC rows
    # whose words start at every byte offset) and of 64, 1-pixel-wide and
    # 1-pixel-tall images, at the radii 1, 8 and 9 (its plane); the full
    # 3x3 tails hand their pairs across rows between lanes (lane 31's
    # row below from the whole warp)
    k1_cases += [(f"{n} {w}x{h} b{b}", cfg, (b, h, w))
                 for n, cfg in (("default", llt.PipelineConfig()),
                                ("perchannel/full", llt.PipelineConfig(
                                    denoise_guide="perchannel",
                                    denoise_taps="full")),
                                ("luma/full/epan", llt.PipelineConfig(
                                    denoise_taps="full",
                                    denoise_kernel="epan")))
                 for b, h, w in ((1, 32, 64), (2, 33, 65), (1, 31, 63),
                                 (2, 130, 1), (2, 1, 130), (1, 40, 262),
                                 (2, 35, 263))]
    k1_cases += [(f"blur r{r} {w}x{h} b{b}",
                  llt.PipelineConfig(blur_radius=r, blur_sigma=r / 3),
                  (b, h, w))
                 for r in (1, 8, 9)
                 for b, h, w in ((2, 33, 65), (2, 130, 1), (1, 35, 263))]
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

    # edges of K3's 32 x 64 tile (curve_tile.cu) at every ds: one tile and
    # one tile + 1, widths off a multiple of 4 and of 64 (blocks whose
    # planes are read a value at a time, or as words only where aligned),
    # 1-pixel-tall images; curve_iters 4 and 16 (random maps), strength 0,
    # f32, the per-channel full tail, blur r 8 (on the tile) and r 16 (its
    # plane), and the gain plane with each
    def rand_maps(xb, n_iter, ds, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        b, _, hb, wb = xb.shape
        return torch.rand((b, n_iter, 3, hb // ds, wb // ds), generator=g,
                          device=dev) * 2.0 - 1.0

    k3_tile_cases = [(f"{c.method} ds{ds} {w}x{h} b{b}",
                      c.replace(curve_downsample=ds), (b, h, w), None, False)
                     for c in (hybrid, curve) for ds in (1, 2, 4)
                     for b, h, w in ((1, 32, 64), (2, 33, 65), (1, 35, 263),
                                     (2, 1, 130))]
    k3_tile_cases += [
        (f"{n} ds{ds} 263x35 b2", c.replace(curve_downsample=ds), (2, 35, 263),
         it, f32)
        for ds in (1, 2, 4)
        for n, c, it, f32 in (
            ("curve iters 4", curve, 4, False),
            ("hybrid iters 16", hybrid, 16, False),
            ("hybrid strength 0", hybrid.replace(denoise_strength=0.0), None,
             False),
            ("hybrid f32", hybrid, None, True),
            ("hybrid perchannel/full", hybrid.replace(
                denoise_guide="perchannel", denoise_taps="full"), None,
             False),
            ("hybrid luma/full/epan blur r8", hybrid.replace(
                denoise_taps="full", denoise_kernel="epan", blur_radius=8,
                blur_sigma=3.0), None, False),
            ("hybrid blur r16 f32", hybrid.replace(
                blur_radius=16, blur_sigma=5.0), None, True))]
    for name, cfg, (b, h, w), n_iter, f32 in k3_tile_cases:
        lows = synth_batch(b, h, w, seed=12)[0]
        xb, maps, halo, rows, iw, m = curve_case(cfg, lows)
        ds = kernel_maps_ds(cfg)
        if n_iter:
            maps = rand_maps(xb, n_iter, ds, b * h + w)
        if f32:
            xb = normalize_u8(xb)
        for gain in (None, torch.rand_like(xb[:, 0], dtype=torch.float32)
                     * 2.5 + 0.5):
            got = fe.fused_curve_enhance(xb, maps, cfg, halo, rows, iw, ds=ds,
                                         gain=gain)
            want = fe.fused_curve_enhance_plain(xb, maps, cfg, halo, rows,
                                                iw, ds, gain)
            what = f"K3 {name}{'' if gain is None else ' + gain'}"
            if f32:
                d = float((got - want)[..., :h, m:m + iw].abs().max())
                print(f"  {what}: max|df32|={d:.3e}")
                if d:
                    raise AssertionError(f"{what}: f32 off by {d}")
                continue
            st = delta_stats(got[..., :h, m:m + iw].cpu().numpy(),
                             want[..., :h, m:m + iw].cpu().numpy())
            check_bar(what, st)
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
    gain_err = 0
    for b, h, w in ((1, 1080, 1920), (8, 400, 600)):
        xb, gain, _, halo, rows, iw, m = video_case(
            cfg0, synth_batch(b, h, w, seed=9)[0])
        got = fe.fused_retinex_gain(xb, gain, cfg0, halo, rows)
        want = fe.fused_retinex_gain_plain(xb, gain, cfg0, halo, rows)
        st = delta_stats(got[..., :h, m:m + iw].cpu().numpy(),
                         want[..., :h, m:m + iw].cpu().numpy())
        check_bar(f"K1 gain form {w}x{h} b{b}", st)
        err["k1"] = max(err["k1"], st["max_abs"])
        gain_err = max(gain_err, st["max_abs"])
        del xb, gain, got, want
    # K3 and K1's gain form (curve_tile.cu) equal their plain versions
    if err["k3"] or gain_err:
        raise AssertionError(f"K3 max|du8| {err['k3']}, K1's gain form "
                             f"{gain_err}: not bit-equal")

    # K4 over chained frames, kernel and plain version each fed its own
    # carry: frame 1 starts from the all-sentinel carry; before frame 3
    # stream 1 of a batch is re-seeded (its carry set to the sentinel)
    k4_carry_err = 0.0
    for b, h, w, n in ((1, 1080, 1920, 4), (8, 400, 600, 4), (2, 33, 47, 2),
                       (2, 32, 64, 4), (2, 33, 65, 4), (2, 130, 1, 4),
                       (2, 1, 130, 4), (2, 35, 263, 4)):
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
                 (b, h, w), None)
                for base in (quality_fast, quality) for tn, tk in tails
                for b, h, w in ((8, 400, 600), (1, 1080, 1920))]
    k5_cases += [(f"{name} 47x33 b2", c, (2, 33, 47), None)
                 for name, c in (("quality_fast", quality_fast),
                                 ("quality", quality))]
    # the bilateral arm on the tile engine: every tail on blocks cut to a
    # width off a multiple of 64 and of 4, and on one a multiple of 4 whose
    # data starts 4 bytes off 16-byte alignment (both take the scalar
    # staging and stores), at b 1 and 2; and every bilateral form (sep or
    # full, luma or per channel, exp or epan)
    k5_cases += [(f"{base.method} {tn} {w}x{h} b{b} {cut}",
                  base.replace(**tk), (b, h, w), cut)
                 for base in (quality_fast, quality) for tn, tk in tails
                 for (b, h, w), cut in (((1, 37, 97), (1, 0)),
                                        ((2, 70, 130), (2, 1)))]
    k5_cases += [(f"fcn {t}/{g}/{k} 97x37 b1", quality_fast.replace(
                  denoise_taps=t, denoise_guide=g, denoise_kernel=k),
                  (1, 37, 97), (1, 0))
                 for t in ("sep", "full") for g in ("luma", "perchannel")
                 for k in ("exp", "epan")]
    for name, cfg, (b, h, w), cut in k5_cases:
        y, halo, rows, h, w = net_case(cfg, synth_batch(b, h, w, seed=5)[0])
        m = canvas_margin(cfg)
        if cut is not None:
            # (extra columns past the image's right margin, offset in
            # floats): the block cut to 2m + w + extra columns, copied to
            # that offset from an aligned allocation
            extra, off = cut
            yc = y[..., :2 * m + w + extra]
            buf = torch.empty(yc.numel() + off, device=dev)
            y = buf[off:].view(yc.shape)
            y.copy_(yc)
            del yc, buf
        got = td.tiled_denoise(y, cfg, halo, rows)[..., :h, m:m + w]
        want = td.tiled_denoise_plain(y, cfg, halo, rows)[..., :h, m:m + w]
        d = float((got - want).abs().max())
        err["k5"] = max(err["k5"], d)
        if d:
            # guided.cuh's guided_tile and the tile engine's tail repeat the
            # plain version's sums
            raise AssertionError(f"K5 {name} (block width {y.shape[-1]}) "
                                 f"off by {d}")
        check_bar(f"K5 {name}", delta_stats(quantize_u8(got).cpu().numpy(),
                                            quantize_u8(want).cpu().numpy()))
        del y, got, want
    print(f"  K5 max |f32 delta| over the cases: {err['k5']:.3e}")
    torch.cuda.synchronize()

    # K8: K1's kernel in the per-channel full-tap form, against its plain
    # version and against EnhancePipeline (whose retinex is K1)
    hwc_pipe = llt.EnhancePipeline(hwc_cfg, device="cuda")
    for b, h, w in ((2, 33, 47), (8, 400, 600), (1, 1080, 1920)):
        x = torch.from_numpy(synth_batch(b, h, w, seed=14)[0]).to(dev)
        got = hw.enhance_hwc_u8(x, hwc_cfg).cpu().numpy()
        for what, want in (
                ("plain", hw.enhance_hwc_u8_plain(x, hwc_cfg)),
                ("EnhancePipeline", hwc_pipe.enhance_batch_device(x))):
            st = delta_stats(got, want.cpu().numpy())
            print(f"  K8 {w}x{h} b{b} vs {what}: max|du8|={st['max_abs']} "
                  f"hist={st['hist']}")
            err["k8"] = max(err["k8"], st["max_abs"])
            if st["max_abs"]:
                raise AssertionError(f"K8 differs from {what}: {st}")
        del x

    lows48 = synth_batch(48, 400, 600, seed=5)[0]
    x48 = torch.from_numpy(lows48).to(dev)

    # the forms of K1, K3 and K4 beyond the default ones: the guided tail
    # (r 2 and 4, both guides; the guided kernel, bit-equal to the plain
    # versions), f32 I/O (within 1e-5), blur radii past the tiles (the blur
    # kernel's plane, then the kernel's LPLANE form) and K1's stages
    f32_err = {"k1": 0.0, "k3": 0.0, "k4": 0.0, "kg": 0.0}

    def gkey(cfg, key, stages=None):
        """The guided kernel's key where the guided tail runs."""
        return ("kg" if cfg.denoise_taps == "guided"
                and cfg.denoise_strength > 0
                and (stages is None or "denoise" in stages) else key)

    def form_check(what, got, want, key):
        if got.dtype == torch.uint8:
            st = delta_stats(got.cpu().numpy(), want.cpu().numpy())
            check_bar(what, st)
            err[key] = max(err[key], st["max_abs"])
            if key == "kg" and st["max_abs"]:
                raise AssertionError(f"{what}: the guided kernel is not "
                                     f"bit-equal: {st}")
            return
        d = float((got - want).abs().max())
        print(f"  {what}: max|df32|={d:.3e}")
        if d > 1e-5 or (key == "kg" and d):
            raise AssertionError(f"{what}: f32 off by {d}")
        f32_err[key] = max(f32_err[key], d)

    synth_cache = {}

    def lows_of(b, h, w):
        """The first b synthetic h x w images of seed 15, made once (a
        600x400 image takes a quarter of a second on the host)."""
        if synth_cache.get((h, w), lows48[:0]).shape[0] < b:
            synth_cache[(h, w)] = synth_batch(b, h, w, seed=15)[0]
        return synth_cache[(h, w)][:b]

    guided = dict(denoise_taps="guided")
    gforms = [(f"guided r{r} {g}", dict(guided_radius=r, denoise_guide=g,
                                        **guided))
              for r in (2, 4) for g in ("luma", "perchannel")]
    # the guided kernel's 32 x 32 tiles: one past a tile, one short of two,
    # 1-pixel-wide and -tall images
    k1_forms = [(f"{n} {w}x{h} b{b}", cfg0.replace(**kw), (b, h, w), None,
                 False)
                for n, kw in gforms for b, h, w in ((8, 400, 600),
                                                     (2, 33, 47), (2, 33, 65),
                                                     (1, 63, 31), (2, 1, 130),
                                                     (2, 130, 1))]
    k1_forms += [
        ("f32 600x400 b8", cfg0, (8, 400, 600), None, True),
        ("f32 guided r4 luma 600x400 b2", cfg0.replace(guided_radius=4,
                                                       **guided),
         (2, 400, 600), None, True),
        ("blur r16 guided r4 600x400 b2",
         cfg0.replace(blur_radius=16, blur_sigma=5.0, guided_radius=4,
                      **guided), (2, 400, 600), None, False),
        ("guided r2 stages boost+denoise 600x400 b2", cfg0.replace(**guided),
         (2, 400, 600), ("boost", "denoise"), False)]
    k1_forms += [(f"blur r{r} 101x67 b2", cfg0.replace(blur_radius=r,
                                                       blur_sigma=r / 3),
                  (2, 67, 101), None, False) for r in (9, 16, 32)]
    k1_forms += [(f"stages {'+'.join(st) or 'none'} 600x400 b2", cfg0,
                  (2, 400, 600), st, False)
                 for st in ((), ("blur",), ("boost",), ("denoise",),
                            ("blur", "boost"), ("blur", "denoise"),
                            ("boost", "denoise"),
                            ("blur", "boost", "denoise"))]
    k1_forms += [(f"blur r9 stages {'+'.join(st) or 'none'} 65x33 b2",
                  cfg0.replace(blur_radius=9, blur_sigma=3.0), (2, 33, 65),
                  st, False)
                 for st in (("blur",), ("blur", "boost"),
                            ("blur", "denoise"))]
    for name, cfg, (b, h, w), stages, f32 in k1_forms:
        x = torch.from_numpy(lows_of(b, h, w)).to(dev)
        if f32:
            x = normalize_u8(x)
        form_check(f"K1 {name}", fe.fused_retinex(x, cfg, stages=stages),
                   fe.fused_retinex_plain(x, cfg, stages),
                   gkey(cfg, "k1", stages))

    # K1's canvas form on the padded planar canvas (pad_planar's), u8 and
    # f32: every tail form and blur r 16 (its plane of the canvas), at 1x1,
    # one tile of the tile engine (32 output rows of 64) and one past it,
    # and the main path's shapes; bit-equal on the image to its plain
    # version and to HWC K1 (the margin columns are not defined)
    canvas_forms = [("no tail", cfg0.replace(denoise_strength=0.0)),
                    ("bilateral", cfg0)]
    canvas_forms += [(n, cfg0.replace(**kw)) for n, kw in gforms]
    canvas_forms += [("blur r16", cfg0.replace(blur_radius=16,
                                               blur_sigma=5.0))]

    def canvas_of(x, cfg):
        """The (B, H, W, 3) images' canvas on the card, its plan, rows."""
        _, h, w, _ = x.shape
        plan = plan_canvas(h, w, canvas_margin(cfg))
        c = pad_planar(x.permute(0, 3, 1, 2), plan, h, w).contiguous()
        return c, plan, plan.padded_h - 2 * plan.margin

    n_canvas = 0
    for name, cfg in canvas_forms:
        for b, h, w in ((1, 1, 1), (1, 32, 64), (2, 33, 65), (48, 400, 600),
                        (1, 1080, 1920)):
            x = x48 if b == 48 else torch.from_numpy(
                lows_of(b, h, w)).to(dev)
            c, plan, rows = canvas_of(x, cfg)
            m = plan.margin
            for f32 in (False, True):
                xc, xi = (normalize_u8(c), normalize_u8(x)) if f32 else (c, x)
                got = fe.fused_retinex_canvas(xc, cfg, m, rows)
                got = got[..., :h, m:m + w]
                want = fe.fused_retinex_canvas_plain(xc, cfg, m, rows)
                hwc = fe.fused_retinex(xi, cfg).permute(0, 3, 1, 2)
                for other, what in ((want[..., :h, m:m + w], "plain"),
                                    (hwc, "HWC K1")):
                    d = float((got.float() - other.float()).abs().max())
                    if d:
                        raise AssertionError(
                            f"K1's canvas form {name} {w}x{h} b{b} "
                            f"{'f32' if f32 else 'u8'} differs from {what} "
                            f"by {d}")
                n_canvas += 1
            del c, xc, got, want, hwc
    print(f"  K1's canvas form: {n_canvas} cases ({len(canvas_forms)} forms "
          "x 5 shapes x u8/f32) bit-equal to its plain version and to HWC "
          "K1 on the image")
    # the blur kernel's plane alone: K1's HWC image at e 1 and 8, the tile's
    # edges (65x33, 1x1), K3's and K4's planar blocks (e 0, u8 and f32),
    # and radii whose tiles the plan cuts into row and column chunks (r 64:
    # 3 x 2, r 128: 4 x 3)
    plane_cases = [(16, 1, (2, 400, 600), True, False),
                   (32, 8, (2, 400, 600), True, False),
                   (16, 1, (2, 33, 65), True, False),
                   (16, 1, (1, 1, 1), True, False),
                   (9, 8, (2, 33, 65), True, True),
                   (16, 0, (2, 35, 263), False, False),
                   (16, 0, (2, 35, 263), False, True),
                   (32, 0, (1, 130, 67), False, True),
                   (64, 1, (2, 67, 101), True, False),
                   (64, 0, (1, 67, 101), False, True),
                   (128, 2, (1, 300, 130), True, False)]
    for r, e, (b, h, w), hwc, f32 in plane_cases:
        cfg = cfg0.replace(blur_radius=r, blur_sigma=r / 3)
        x = torch.from_numpy(lows_of(b, h, w)).to(dev)
        if not hwc:
            x = x.permute(0, 3, 1, 2).contiguous()
        if f32:
            x = normalize_u8(x)
        d = float((fe.blur_illumination(x, cfg, e, hwc=hwc)
                   - fe.blur_illumination_plain(x, cfg, e, hwc))
                  .abs().max())
        what = (f"r{r} e{e} {w}x{h} b{b} {'HWC' if hwc else 'planar'} "
                f"{'f32' if f32 else 'u8'}")
        print(f"  blur_illumination {what}: max|df32|={d:.3e}")
        err["kb"] = max(err["kb"], d)
        if d > 1e-6:
            raise AssertionError(f"blur_illumination {what} off by {d}")
    print(f"  blur_illumination max |f32 delta| over the cases: "
          f"{err['kb']:.3e}")
    k3_forms = [
        ("hybrid guided r2 luma 600x400 b8", hybrid.replace(**guided),
         (8, 400, 600), False),
        ("hybrid guided r4 perchannel 600x400 b2",
         hybrid.replace(guided_radius=4, denoise_guide="perchannel",
                        **guided), (2, 400, 600), False),
        ("curve ds2 guided r4 luma 600x400 b2",
         curve.replace(curve_downsample=2, guided_radius=4, **guided),
         (2, 400, 600), False),
        ("hybrid ds4 guided r2 perchannel 1080p b1",
         hybrid.replace(curve_downsample=4, denoise_guide="perchannel",
                        **guided), (1, 1080, 1920), False),
        ("hybrid f32 600x400 b2", hybrid, (2, 400, 600), True),
        ("hybrid guided r4 luma f32 600x400 b2",
         hybrid.replace(guided_radius=4, **guided), (2, 400, 600), True),
        ("hybrid blur r16 600x400 b2",
         hybrid.replace(blur_radius=16, blur_sigma=5.0), (2, 400, 600),
         False),
        ("hybrid blur r9 guided r2 600x400 b2",
         hybrid.replace(blur_radius=9, blur_sigma=3.0, **guided),
         (2, 400, 600), False),
        ("hybrid guided r4 luma 65x33 b2",
         hybrid.replace(guided_radius=4, **guided), (2, 33, 65), False),
        ("hybrid ds4 guided r3 perchannel 263x35 b2",
         hybrid.replace(curve_downsample=4, guided_radius=3,
                        denoise_guide="perchannel", **guided),
         (2, 35, 263), False)]
    for name, cfg, (b, h, w), f32 in k3_forms:
        xb, maps, halo, rows, iw, m = curve_case(cfg, lows_of(b, h, w))
        if f32:
            xb = normalize_u8(xb)
        ds = kernel_maps_ds(cfg)
        got = fe.fused_curve_enhance(xb, maps, cfg, halo, rows, iw, ds=ds)
        want = fe.fused_curve_enhance_plain(xb, maps, cfg, halo, rows, iw, ds)
        form_check(f"K3 {name}", got[..., :h, m:m + iw],
                   want[..., :h, m:m + iw], gkey(cfg, "k3"))
        del xb, maps, got, want
    # the video forms: K1's gain form, K4 over two chained frames from the
    # sentinel, K3 with the gain plane
    for name, cfg, (b, h, w), f32 in (
            ("guided r2 luma 1080p b1", cfg0.replace(**guided),
             (1, 1080, 1920), False),
            ("guided r4 perchannel 600x400 b8",
             cfg0.replace(guided_radius=4, denoise_guide="perchannel",
                          **guided), (8, 400, 600), False),
            ("f32 1080p b1", cfg0, (1, 1080, 1920), True),
            ("guided r4 luma f32 600x400 b2",
             cfg0.replace(guided_radius=4, **guided), (2, 400, 600), True),
            ("blur r16 600x400 b2",
             cfg0.replace(blur_radius=16, blur_sigma=5.0), (2, 400, 600),
             False),
            ("guided r2 luma 65x33 b2", cfg0.replace(**guided), (2, 33, 65),
             False),
            ("guided r4 perchannel 263x35 b2",
             cfg0.replace(guided_radius=4, denoise_guide="perchannel",
                          **guided), (2, 35, 263), False)):
        xb, gain, _, halo, rows, iw, m = video_case(cfg, lows_of(b, h, w))
        if f32:
            xb = normalize_u8(xb)
        form_check(f"K1 gain form {name}",
                   fe.fused_retinex_gain(xb, gain, cfg, halo, rows)
                   [..., :h, m:m + iw],
                   fe.fused_retinex_gain_plain(xb, gain, cfg, halo, rows)
                   [..., :h, m:m + iw], gkey(cfg, "k1"))
        ck = torch.full_like(gain, -1.0)
        cp = ck.clone()
        for t in range(2):
            got, ck = fe.fused_retinex_ema(xb, ck, cfg, halo, rows, iw, 0.3)
            want, cp = fe.fused_retinex_ema_plain(xb, cp, cfg, halo, rows,
                                                  iw, 0.3)
            form_check(f"K4 {name} frame {t + 1}", got[..., :h, m:m + iw],
                       want[..., :h, m:m + iw], gkey(cfg, "k4"))
            dc = float((ck - cp)[..., m:m + iw].abs().max())
            if dc > 1e-6:
                raise AssertionError(f"K4 {name} carry off by {dc}")
        del xb, gain, ck, cp, got, want
    for name, cfg in (("hybrid ds4 + gain guided r2 luma 1080p b1",
                       hybrid.replace(curve_downsample=4, **guided)),
                      ("hybrid ds4 + gain guided r4 perchannel 1080p b1",
                       hybrid.replace(curve_downsample=4, guided_radius=4,
                                      denoise_guide="perchannel", **guided))):
        xb, gain, maps, halo, rows, iw, m = video_case(cfg,
                                                       lows_of(1, 1080, 1920))
        form_check(f"K3 {name}",
                   fe.fused_curve_enhance(xb, maps, cfg, halo, rows, iw,
                                          ds=4, gain=gain)[..., m:m + iw],
                   fe.fused_curve_enhance_plain(xb, maps, cfg, halo, rows, iw,
                                                4, gain)[..., m:m + iw],
                   "kg")
        del xb, gain, maps
    print(f"  f32 forms max |df32| over the cases: {f32_err}")

    # the conv kernels on unit-scale random activations and He-scaled
    # weights, at small odd shapes and on the nets' own blocks
    blk = {name: tuple(pad_block(x48, c)[0].shape[-2:])
           for name, c in (("hybrid", hybrid), ("decom", quality),
                           ("fcn", quality_fast))}
    cgen = torch.Generator(device="cuda").manual_seed(21)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}

    def urand(shape, dtype):
        return torch.rand(shape, generator=cgen, device=dev).to(dtype)

    def conv_params(cin, cout):
        w = torch.randn((cout, cin, 3, 3), generator=cgen, device=dev)
        return (w * (2.0 / (9 * cin)) ** 0.5,
                0.1 * torch.randn((cout,), generator=cgen, device=dev))

    def conv_check(what, got, want):
        """float32: max |d| <= CONV_F32_BAR; bf16: one bf16 step of the
        value, or CONV_F32_BAR where the sum cancels to near 0."""
        g, wv = got.float(), want.float()
        d = (g - wv).abs()
        if got.dtype == torch.float32:
            bar = torch.full_like(d, CONV_F32_BAR)
        else:
            mag = torch.maximum(g.abs(), wv.abs()).clamp_min(1e-30)
            bar = torch.exp2(torch.floor(torch.log2(mag)) - 7) \
                .clamp_min(CONV_F32_BAR)
        dmax = float(d.max())
        over = int((d > bar).sum())
        print(f"  {what}: max|d|={dmax:.3e} differing share="
              f"{float((d > 0).float().mean()):.3e}")
        if over:
            raise AssertionError(f"{what}: {over} values outside the bar")
        return dmax

    f = 32
    for dn, dt in dtypes.items():
        # the curve CNN's c2-c4 (and decom's), c5/c6 and c7
        # and the widths the other configs reach: curve_features 64's
        # c2-c4 and c5/c6 (two 64-channel groups), curve_iters 4's and
        # 16's heads (Cout 12, padded to 16, and 48), curve_features 160's
        # c5/c6 (six pieces: piece groups)
        for lname, groups, cout, act in (
                ("32->32 relu", (f,), f, "relu"),
                ("32+32->32 relu", (f, f), f, "relu"),
                ("32+32->24 tanh", (f, f), 24, "tanh"),
                ("64->64 relu", (64,), 64, "relu"),
                ("64+64->64 relu", (64, 64), 64, "relu"),
                ("32+32->12 tanh", (f, f), 12, "tanh"),
                ("32+32->48 tanh", (f, f), 48, "tanh"),
                ("160+160->160 relu", (160, 160), 160, "relu")):
            if dt == torch.float32 and sum(groups) > 128:
                # piece groups are the bf16 form's; the f32 form sums 2,880
                # products a value at Cin 320, ~1.1e-5 from cuDNN's order
                # (tools/probe_conv.py), past the bar set at the nets' widths
                continue
            w, b = conv_params(sum(groups), cout)
            for shape in ((2, 37, 45), (4,) + blk["hybrid"]):
                xs = [urand(shape + (c,), dt) for c in groups]
                got = mx.conv2d_patch_mxu(xs, w, b, act=act)
                err["k6a"] = max(err["k6a"], conv_check(
                    f"K6a {lname} {dn} {shape}", got,
                    mx.conv3x3_plain(xs, w, b, act)))
        # the fcn stack's c2-c7, one layer at a time as K6b and as K7, then
        # as one K7 launch
        ws, bs = zip(*[conv_params(24, 24) for _ in FCN_DILATIONS])
        for shape in ((2, 70, 72), (4,) + blk["fcn"]):
            x = urand(shape + (24,), dt)
            chain, chain7 = x, x
            for w, b, d in zip(ws, bs, FCN_DILATIONS):
                want = mx.conv3x3_plain((chain,), w, b, "leaky", d)
                chain = mx.conv2d_dense9_mxu(chain, w, b, act="leaky",
                                             dilation=d)
                err["k6b"] = max(err["k6b"], conv_check(
                    f"K6b d{d} {dn} {shape}", chain, want))
                want = mx.conv3x3_plain((chain7,), w, b, "leaky", d)
                chain7 = fc.fcn_cascade_mxu(chain7, (w,), (b,), (d,))
                err["k7"] = max(err["k7"], conv_check(
                    f"K7 one layer d{d} {dn} {shape}", chain7, want))
            got = fc.fcn_cascade_mxu(x, ws, bs, FCN_DILATIONS)
            if not torch.equal(got, chain7):
                raise AssertionError(f"K7 {dn} {shape}: the six-layer launch "
                                     "differs from its one-layer launches")
            # K6b and K7 run the same layer (bf16: the tensor-core one, f32
            # the CUDA-core one), so the same sums in the same order
            if not torch.equal(got, chain):
                raise AssertionError(f"K7 {dn} {shape} differs from K6b "
                                     "layer by layer")
            same = "equal to its one-layer launches and to K6b layer by layer"
            want = fc.fcn_cascade_plain(x, ws, bs, FCN_DILATIONS)
            if dt == torch.float32:
                err["k7"] = max(err["k7"], conv_check(
                    f"K7 {dn} {shape} ({same})", got, want))
            else:
                # a one-step difference of a layer feeds the next: bf16 is
                # held layer by layer (above) and by the equality
                d = (got.float() - want.float()).abs()
                print(f"  K7 {dn} {shape}: {same}; against the plain stack "
                      f"max|d|={float(d.max()):.3e} differing share="
                      f"{float((d > 0).float().mean()):.3e}")
            del x, chain, chain7, got, want
    torch.cuda.synchronize()

    # K6 past one chunk's weights beside a ring (more than 16 pieces of 64
    # channels, or 14 at dilation 64): the weights streamed by piece group.
    # Against float64 sums of the same bf16 inputs and weights: within one
    # bf16 step of the value or the f32 sum's rounding, sqrt(9 Cin) 2^-24
    # sum |x w| (near 0 the f32 sums of 9,000-18,000 products of the
    # kernel and of cuDNN part by more than 1e-5)
    def wide_check(what, got, xs, w, b, act, dil):
        x = torch.cat(xs, -1).permute(0, 3, 1, 2).double()
        wd = w.to(torch.bfloat16).double()
        z = F.conv2d(x, wd, padding=dil, dilation=dil) \
            + b.double()[:, None, None]
        ref = mx.ACTS[act](z).permute(0, 2, 3, 1)
        mag = F.conv2d(x.abs(), wd.abs(), padding=dil, dilation=dil)
        rounding = ((9 * x.shape[1]) ** 0.5 * 2.0 ** -24
                    * mag.permute(0, 2, 3, 1))
        step = torch.exp2(torch.floor(torch.log2(
            ref.abs().clamp_min(1e-30))) - 7)
        bar = torch.maximum(step, rounding).clamp_min(CONV_F32_BAR)
        d = (got.double() - ref).abs()
        over = int((d > bar).sum())
        print(f"  {what}: max|d| vs float64 {float(d.max()):.3e}, outside "
              f"one bf16 step or the f32 rounding {over}")
        if over or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{what}: {over} values off float64")
        return float(d.max())

    for lname, groups, cout, act, dil, shape in (
            ("640+640->640 relu", (640, 640), 640, "relu", 1, (2, 37, 45)),
            ("1024+1024->24 tanh", (1024, 1024), 24, "tanh", 1,
             (2, 37, 45)),
            ("1024->24 leaky d64", (1024,), 24, "leaky", 64, (1, 140, 200)),
            ("1024->24 leaky d128", (1024,), 24, "leaky", 128,
             (1, 140, 300))):
        w, b = conv_params(sum(groups), cout)
        xs = [urand(shape + (c,), torch.bfloat16) for c in groups]
        if dil == 1:
            got, k = mx.conv2d_patch_mxu(xs, w, b, act=act), "k6a"
        else:
            got, k = mx.conv2d_dense9_mxu(xs[0], w, b, act=act,
                                          dilation=dil), "k6b"
        wide_check(f"{k.upper()} {lname} bf16 {shape} (streamed weights)",
                   got, xs, w, b, act, dil)
        del xs, got

    # kernel-only time beside the plain version's at the main-path shape
    k1_ms, k1_plain_ms = paired_ms(
        torch, lambda: fe.fused_retinex_plain(x48, cfg0),
        lambda: fe.fused_retinex(x48, cfg0), 10)
    k1_b = k1_bound(cfg0, 48, 400, 600)
    # K1's canvas form on the main path's canvas (408x640), beside HWC K1
    c48, plan48, rows48 = canvas_of(x48, cfg0)
    kc_ms, kc_plain_ms = paired_ms(
        torch, lambda: fe.fused_retinex_canvas_plain(c48, cfg0,
                                                     plan48.margin, rows48),
        lambda: fe.fused_retinex_canvas(c48, cfg0, plan48.margin, rows48),
        10)
    kc_b = k1_canvas_bound(cfg0, 48, 400, 600, plan48)
    c1080, plan1080, rows1080 = canvas_of(
        torch.from_numpy(lows_of(1, 1080, 1920)).to(dev), cfg0)
    kc1080 = paired_ms(
        torch, lambda: fe.fused_retinex_canvas_plain(
            c1080, cfg0, plan1080.margin, rows1080),
        lambda: fe.fused_retinex_canvas(c1080, cfg0, plan1080.margin,
                                        rows1080), 10) + (
        k1_canvas_bound(cfg0, 1, 1080, 1920, plan1080),)
    del c1080
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

    # the conv kernels at the 600x400 b48 blocks, bf16 (the compute dtype):
    # K6a as the curve CNN's c5 on hybrid's block, K6b as fcn's c2 and K7
    # as its c2-c7 on fcn's block; the yardstick is one cuDNN call
    bf = torch.bfloat16
    hbh, wbh = blk["hybrid"]
    xs = [urand((48, hbh, wbh, f), bf) for _ in range(2)]
    w, b = conv_params(2 * f, f)
    xcat = torch.cat(xs, -1).permute(0, 3, 1, 2)   # channels_last NCHW
    wl = w.to(bf).contiguous(memory_format=torch.channels_last)
    k6a_ms, k6a_plain_ms = paired_ms(
        torch, lambda: mx.conv3x3_plain(xs, w, b, "relu"),
        lambda: mx.conv2d_patch_mxu(xs, w, b, act="relu"), 3)
    k6a_lib_ms = cuda_ms(torch, lambda: F.conv2d(xcat, wl, b.to(bf),
                                                 padding=1), 5, prefill=True)
    k6a_b = conv_bound(48 * hbh * wbh, 2 * f, f, 2)
    # K6a as the curve CNN's c2-c4 (and decom's), its most frequent layer
    x = xs[0]
    w, b = conv_params(f, f)
    wl = w.to(bf).contiguous(memory_format=torch.channels_last)
    xn = x.permute(0, 3, 1, 2)
    k6a32 = (cuda_ms(torch, lambda: mx.conv2d_patch_mxu((x,), w, b,
                                                        act="relu"), 3,
                     prefill=True),
             cuda_ms(torch, lambda: F.conv2d(xn, wl, b.to(bf), padding=1),
                     3, prefill=True),
             conv_bound(48 * hbh * wbh, f, f, 2))
    del xs, xcat, x, xn
    hbf, wbf = blk["fcn"]
    x = urand((48, hbf, wbf, 24), bf)
    ws, bs = zip(*[conv_params(24, 24) for _ in FCN_DILATIONS])
    k6b_ms, k6b_plain_ms = paired_ms(
        torch, lambda: mx.conv3x3_plain((x,), ws[0], bs[0], "leaky", 2),
        lambda: mx.conv2d_dense9_mxu(x, ws[0], bs[0], act="leaky",
                                     dilation=2), 3)
    xn = x.permute(0, 3, 1, 2)
    wl = ws[0].to(bf).contiguous(memory_format=torch.channels_last)
    k6b_lib_ms = cuda_ms(torch, lambda: F.conv2d(xn, wl, bs[0].to(bf),
                                                 padding=2, dilation=2), 5,
                         prefill=True)
    k6b_b = conv_bound(48 * hbf * wbf, 24, 24, 2)
    # K6b as fcn's c6, at d 32
    wl = ws[4].to(bf).contiguous(memory_format=torch.channels_last)
    k6b32 = (cuda_ms(torch, lambda: mx.conv2d_dense9_mxu(
                 x, ws[4], bs[4], act="leaky", dilation=32), 3,
                 prefill=True),
             cuda_ms(torch, lambda: F.conv2d(xn, wl, bs[4].to(bf),
                                             padding=32, dilation=32), 3,
                     prefill=True),
             k6b_b)
    k7_ms, k7_plain_ms = paired_ms(
        torch, lambda: fc.fcn_cascade_plain(x, ws, bs, FCN_DILATIONS),
        lambda: fc.fcn_cascade_mxu(x, ws, bs, FCN_DILATIONS), 2)
    k7_b = conv_bound(48 * hbf * wbf, 24, 24, 2, layers=len(FCN_DILATIONS))
    del x, xn
    k8_ms, k8_plain_ms = paired_ms(
        torch, lambda: hw.enhance_hwc_u8_plain(x48, hwc_cfg),
        lambda: hw.enhance_hwc_u8(x48, hwc_cfg), 10)
    k8_b = k1_bound(hwc_cfg, 48, 400, 600)

    # the new forms' times beside their plain versions and bounds: K1 guided
    # and f32 at 600x400 b48 and 1080p b1, K3 hybrid guided at 600x400 b48,
    # the video forms guided at 1080p b1, the blur kernel's plane
    form_ms = {}

    def form_timed(name, plain, kernel, bnd, iters=3):
        form_ms[name] = paired_ms(torch, plain, kernel, iters) + (bnd,)

    x1080 = torch.from_numpy(lows_of(1, 1080, 1920)).to(dev)
    for n, kw in (gforms[0], gforms[2], gforms[3]):
        cfg = cfg0.replace(**kw)
        for shape, x in (("600x400 b48", x48), ("1080p b1", x1080)):
            b, h, w = x.shape[:3]
            form_timed(f"K1 {n} {shape}",
                       lambda: fe.fused_retinex_plain(x, cfg),
                       lambda: fe.fused_retinex(x, cfg), k1_bound(cfg, b, h, w),
                       3 if b > 1 else 10)
    x48f = normalize_u8(x48)
    form_timed("K1 f32 600x400 b48", lambda: fe.fused_retinex_plain(x48f, cfg0),
               lambda: fe.fused_retinex(x48f, cfg0),
               k1_bound(cfg0, 48, 400, 600, 4))
    del x48f
    cfg = cfg0.replace(blur_radius=16, blur_sigma=5.0)
    kb_ms, kb_plain_ms = paired_ms(
        torch, lambda: fe.blur_illumination_plain(x48, cfg, 1, True),
        lambda: fe.blur_illumination(x48, cfg, 1, hwc=True), 3)
    kb_b = blur_plane_bound(cfg, 48, 400, 600, 1)
    cfg32 = cfg0.replace(blur_radius=32, blur_sigma=32 / 3)
    kb32 = paired_ms(
        torch, lambda: fe.blur_illumination_plain(x48, cfg32, 8, True),
        lambda: fe.blur_illumination(x48, cfg32, 8, hwc=True), 3) + (
        blur_plane_bound(cfg32, 48, 400, 600, 8),)
    form_timed("K1 blur r16 (plane and K1) 600x400 b48",
               lambda: fe.fused_retinex_plain(x48, cfg),
               lambda: fe.fused_retinex(x48, cfg), k1_bound(cfg, 48, 400, 600))
    # K3 hybrid on f32 data, maps at 1/1
    xb, maps, halo, rows, iw, m = curve_case(hybrid, lows48)
    xb = normalize_u8(xb)
    form_timed("K3 hybrid f32 ds1 600x400 b48",
               lambda: fe.fused_curve_enhance_plain(xb, maps, hybrid, halo,
                                                    rows, iw),
               lambda: fe.fused_curve_enhance(xb, maps, hybrid, halo, rows,
                                              iw),
               k3_bound(hybrid, xb, maps, halo, rows, m))
    del xb, maps
    for n, kw in (gforms[2],):
        cfg = hybrid.replace(**kw)
        xb, maps, halo, rows, iw, m = curve_case(cfg, lows48)
        form_timed(f"K3 hybrid {n} 600x400 b48",
                   lambda: fe.fused_curve_enhance_plain(xb, maps, cfg, halo,
                                                        rows, iw),
                   lambda: fe.fused_curve_enhance(xb, maps, cfg, halo, rows,
                                                  iw),
                   k3_bound(cfg, xb, maps, halo, rows, m))
        del xb, maps
    lows1080 = lows_of(1, 1080, 1920)
    for n, kw in (gforms[0], gforms[2]):
        cfg = cfg0.replace(**kw)
        xb, gain, _, halo, rows, iw, m = video_case(cfg, lows1080)
        carry = torch.full_like(gain, -1.0)
        form_timed(f"K4 {n} 1080p b1",
                   lambda: fe.fused_retinex_ema_plain(xb, carry, cfg, halo,
                                                      rows, iw, 0.3),
                   lambda: fe.fused_retinex_ema(xb, carry, cfg, halo, rows,
                                                iw, 0.3),
                   k4_bound(cfg, 1, xb.shape[-2], xb.shape[-1], rows, m), 10)
        form_timed(f"K1 gain form {n} 1080p b1",
                   lambda: fe.fused_retinex_gain_plain(xb, gain, cfg, halo,
                                                       rows),
                   lambda: fe.fused_retinex_gain(xb, gain, cfg, halo, rows),
                   k1_gain_bound(cfg, 1, rows, m, xb.shape[-1]), 10)
        cfg = hybrid.replace(curve_downsample=4, **kw)
        xb, gain, maps, halo, rows, iw, m = video_case(cfg, lows1080)
        form_timed(f"K3 hybrid ds4 + gain {n} 1080p b1",
                   lambda: fe.fused_curve_enhance_plain(xb, maps, cfg, halo,
                                                        rows, iw, 4, gain),
                   lambda: fe.fused_curve_enhance(xb, maps, cfg, halo, rows,
                                                  iw, ds=4, gain=gain),
                   k3_bound(cfg, xb, maps, halo, rows, m, ds=4, gain=True),
                   10)
        del xb, gain, maps, carry

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
    print(f"  600x400 b48 on {card}: K1's canvas form {kc_ms:.4f} ms on "
          f"the {plan48.padded_h}x{plan48.padded_w} canvas (HWC K1 "
          f"{k1_ms:.4f} ms; plain {kc_plain_ms:.3f} ms, bound "
          f"{kc_b[0]:.4f} ms by {kc_b[1]}, {kc_ms / kc_b[0]:.1f}x); 1080p "
          f"b1 {kc1080[0]:.4f} ms (plain {kc1080[1]:.3f} ms, bound "
          f"{kc1080[2][0]:.4f} ms by {kc1080[2][1]})")
    print(f"  600x400 b48 on {card}: K1 {k1_ms:.3f} ms (plain "
          f"{k1_plain_ms:.3f} ms, bound {k1_b[0]:.4f} ms by {k1_b[1]}); "
          f"K3 hybrid {k3_ms:.3f} ms (plain {k3_plain_ms:.3f} ms, bound "
          f"{k3_b[0]:.4f} ms by {k3_b[1]})")
    for name, (t, tp, bd) in k5_ms.items():
        print(f"  600x400 b48 on {card}: K5 {name} block {t:.4f} ms (plain "
              f"{tp:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]}, "
              f"{t / bd[0]:.1f}x)")
    for name, (t, tl, bd) in (
            (f"K6a 32->32 relu bf16 on hybrid's block {hbh}x{wbh}", k6a32),
            (f"K6b 24->24 d32 leaky bf16 on fcn's block {hbf}x{wbf}",
             k6b32)):
        print(f"  600x400 b48 on {card}: {name} {t:.3f} ms (one F.conv2d "
              f"{tl:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]})")
    for name, t, tp, tl, bd in (
            (f"K6a c5 64->32 relu bf16 on hybrid's block {hbh}x{wbh}",
             k6a_ms, k6a_plain_ms, k6a_lib_ms, k6a_b),
            (f"K6b c2 24->24 d2 leaky bf16 on fcn's block {hbf}x{wbf}",
             k6b_ms, k6b_plain_ms, k6b_lib_ms, k6b_b),
            (f"K7 c2-c7 bf16 on fcn's block {hbf}x{wbf}", k7_ms, k7_plain_ms,
             None, k7_b),
            ("K8 perchannel/full", k8_ms, k8_plain_ms, None, k8_b)):
        lib = "" if tl is None else f", one F.conv2d {tl:.3f} ms"
        print(f"  600x400 b48 on {card}: {name} {t:.3f} ms (plain {tp:.3f} "
              f"ms{lib}, bound {bd[0]:.4f} ms by {bd[1]})")
    for name, (t, tp, bd) in form_ms.items():
        print(f"  {name} on {card}: {t:.4f} ms (plain {tp:.3f} ms, bound "
              f"{bd[0]:.4f} ms by {bd[1]}, {t / bd[0]:.1f}x)")
    for name, (t, tp, bd) in (("r16 e1", (kb_ms, kb_plain_ms, kb_b)),
                              ("r32 e8", kb32)):
        print(f"  blur_illumination {name} 600x400 b48 on {card}: {t:.4f} "
              f"ms (plain {tp:.3f} ms, bound {bd[0]:.4f} ms by {bd[1]}, "
              f"{t / bd[0]:.1f}x)")
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
    # the guided tails (timed at 1080p b1 too): the guided kernel, which
    # counts its own launches, and not K1's or K3's; and a blur past the
    # tiles
    guided_paths = [
        ("retinex guided r2", cfg0.replace(**guided), ("kg",)),
        ("retinex guided r4", cfg0.replace(guided_radius=4, **guided),
         ("kg",)),
        ("retinex guided r4 perchannel",
         cfg0.replace(guided_radius=4, denoise_guide="perchannel", **guided),
         ("kg",)),
        ("hybrid guided r4", hybrid.replace(guided_radius=4, **guided),
         ("kg",)),
        ("curve ds2 guided r2", curve.replace(curve_downsample=2, **guided),
         ("kg",)),
    ]
    paths += guided_paths
    paths += [("retinex blur r16", cfg0.replace(blur_radius=16,
                                                blur_sigma=5.0),
               ("k1", "kb"))]
    # the nets' own conv kernels: (name, config, kernels it launches)
    conv_paths = [
        ("hybrid pallas", hybrid.replace(conv_impl="pallas"), ("k6a", "k3")),
        ("quality pallas", quality.replace(conv_impl="pallas"),
         ("k6a", "k5")),
        ("quality_fast pallas", quality_fast.replace(conv_impl="pallas"),
         ("k6b", "k5")),
        ("quality_fast cascade", quality_fast.replace(conv_impl="cascade"),
         ("k7", "k5")),
        # the widths of the other configs, random weights
        ("hybrid pallas f64",
         hybrid.replace(conv_impl="pallas", curve_features=64),
         ("k6a", "k3")),
        ("hybrid pallas f160",
         hybrid.replace(conv_impl="pallas", curve_features=160),
         ("k6a", "k3")),
        ("hybrid pallas i4", hybrid.replace(conv_impl="pallas",
                                            curve_iters=4), ("k6a", "k3")),
        ("hybrid pallas i16", hybrid.replace(conv_impl="pallas",
                                             curve_iters=16), ("k6a", "k3")),
        ("hybrid pallas guided r4",
         hybrid.replace(conv_impl="pallas", guided_radius=4, **guided),
         ("k6a", "kg")),
        # past 16 pieces: K6 streams its weights (a small block only)
        ("hybrid pallas f640",
         hybrid.replace(conv_impl="pallas", curve_features=640),
         ("k6a", "k3")),
    ]
    paths += conv_paths
    conv_kernels = ("k6a", "k6b", "k7", "k8")
    # kernels a path must not launch: the default arms no conv kernel, the
    # conv arms none of the others', the HWC entry point no K1, a guided
    # path none of K1's, K3's and K4's own kernels and a bilateral path not
    # the guided one
    never = {name: tuple(k for k in conv_kernels if k not in kernels)
             + (("k1", "k3", "k4") if "kg" in kernels else ("kg",))
             + ("kc",) for name, _, kernels in paths}
    never["hwc"] = ("k1", "kg", "kc") + tuple(k for k in conv_kernels
                                              if k != "k8")
    # launches per block: K6a 6 (hybrid's c2-c7) or 3 (decom's c2-c4) per
    # K3 / K5 launch, K6b 6 (fcn's c2-c7), K7 1 (all six)
    per_block = {"hybrid pallas": ("k6a", 6, "k3"),
                 "hybrid pallas f64": ("k6a", 6, "k3"),
                 "hybrid pallas f160": ("k6a", 6, "k3"),
                 "hybrid pallas i4": ("k6a", 6, "k3"),
                 "hybrid pallas i16": ("k6a", 6, "k3"),
                 "hybrid pallas guided r4": ("k6a", 6, "kg"),
                 "hybrid pallas f640": ("k6a", 6, "k3"),
                 "retinex blur r16": ("kb", 1, "k1"),
                 "quality pallas": ("k6a", 3, "k5"),
                 "quality_fast pallas": ("k6b", 6, "k5"),
                 "quality_fast cascade": ("k7", 1, "k5")}
    # the video benchmark's arms: (name, config, ema_in_kernel, kernels it
    # launches, kernels it must not launch)
    video_paths = [
        ("video retinex", cfg0, True, ("k4",), ("k1", "k3", "kg")),
        ("video retinex_extgain", cfg0, False, ("k1",), ("k4", "k3", "kg")),
        ("video curve_ds4", curve.replace(curve_downsample=4), True,
         ("k3",), ("k1", "k4", "kg")),
        ("video hybrid_ds4", hybrid.replace(curve_downsample=4), True,
         ("k3",), ("k1", "k4", "kg")),
        ("video retinex guided", cfg0.replace(**guided), True, ("kg",),
         ("k1", "k3", "k4")),
        ("video retinex_extgain guided", cfg0.replace(**guided), False,
         ("kg",), ("k1", "k4", "k3")),
        ("video hybrid_ds4 guided",
         hybrid.replace(curve_downsample=4, **guided), True, ("kg",),
         ("k1", "k3", "k4")),
    ]
    # the host boundary's paths (phases 4b, 4d, 5): (name, kernels it
    # launches, kernels it must not launch); the planar and canvas entry
    # points run K1's canvas form in place of HWC K1
    host_paths = [
        ("planar", ("kc",), ("k1", "kg")),
        ("canvas", ("kc",), ("k1", "kg")),
        ("planar guided r4", ("kg",), ("k1", "kc")),
        ("canvas guided r4", ("kg",), ("k1", "kc")),
        ("stream hwc", ("k1",), ("kc", "kg")),
        ("stream planar", ("kc",), ("k1", "kg")),
        ("stream canvas", ("kc",), ("k1", "kg")),
        ("golden and enhance_file", ("k1",), ("kc", "kg")),
        ("eval retinex", ("k1",), ("kc", "kg")),
        ("eval curve", ("k3",), ("k1", "kc", "kg")),
        ("eval hybrid", ("k3",), ("k1", "kc", "kg")),
        ("eval decom", ("k5",), ("k1", "k3", "kc", "kg")),
        ("http", ("k1",), ("kc", "kg")),
    ]
    launches = {name: {k: 0 for k in wrappers}
                for name, *_ in paths + video_paths + host_paths + [("hwc",)]}

    def counted(name, run):
        for wr in wrappers.values():
            wr.launches = 0
        out = run()
        for k, wr in wrappers.items():
            launches[name][k] += wr.launches
        return out

    print(f"[4] EnhancePipeline(device='cuda') "
          f"({time.perf_counter() - t_start:.0f} s)")
    small = synth_batch(2, 64, 96, seed=6)[0]

    def phase4(name, cfg):
        pipe = llt.EnhancePipeline(cfg, device="cuda")
        cpu = llt.EnhancePipeline(cfg, device="cpu",
                                  model_params=pipe.model_params)
        if cfg.curve_features > 512:
            # K6 streaming its weights: a small block, bf16 against the CPU
            tiny = synth_batch(1, 32, 48, seed=6)[0]
            p = psnr(pipe.enhance_batch(tiny), cpu.enhance_batch(tiny))
            print(f"  {name} (bf16) cuda vs cpu 48x32 b1: PSNR {p:.2f} dB")
            if p < 40.0:
                raise AssertionError(f"{name} PSNR {p:.2f} < 40 dB")
            return
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
        if "guided" in name:
            hd_ms = cuda_ms(torch, lambda: pipe.enhance_batch_device(x1080),
                            10)
            print(f"  {name} 1080p b1 on {card}: {1e3 / hd_ms:.1f} img/s "
                  f"enhance_batch_device ({hd_ms:.3f} ms)")

    for name, cfg, _ in paths:
        counted(name, lambda: phase4(name, cfg))

    def phase4_hwc():
        """enhance_hwc_u8 on a CUDA tensor against the CPU, and its rate."""
        got = hw.enhance_hwc_u8(torch.from_numpy(small).to(dev), hwc_cfg)
        want = hw.enhance_hwc_u8(torch.from_numpy(small), hwc_cfg)
        check_bar("enhance_hwc_u8 cuda vs cpu 96x64 b2",
                  delta_stats(got.cpu().numpy(), want.numpy()))
        dev_ms = cuda_ms(torch, lambda: hw.enhance_hwc_u8(x48, hwc_cfg), 5)
        host_ms = cuda_ms(torch, lambda: hw.enhance_hwc_u8(
            torch.from_numpy(lows48).to(dev), hwc_cfg).cpu().numpy(), 5)
        print(f"  enhance_hwc_u8 600x400 b48 on {card}: {48e3 / host_ms:.1f}"
              f" img/s host u8 in/out ({host_ms:.2f} ms), "
              f"{48e3 / dev_ms:.1f} img/s on the card ({dev_ms:.2f} ms)")

    counted("hwc", phase4_hwc)

    print(f"[4b] ({time.perf_counter() - t_start:.0f} s) synthetic eval-15 "
          "on the card against the JAX package's "
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

    eval_paths = [("quality", "quality", quality),
                  ("quality_fast", "quality_fast", quality_fast),
                  ("quality pallas", "quality",
                   quality.replace(conv_impl="pallas")),
                  ("quality_fast cascade", "quality_fast",
                   quality_fast.replace(conv_impl="cascade")),
                  ("retinex guided r4", "retinex guided r4",
                   cfg0.replace(guided_radius=4, **guided)),
                  ("hybrid guided r4", "hybrid guided r4",
                   hybrid.replace(guided_radius=4, **guided))]
    for name, preset, cfg in eval_paths:
        got = counted(name, lambda: eval15(cfg))
        want = JAX_EVAL15[preset]
        print(f"  {name} on {card}: PSNR {got['psnr']:.4f} dB (JAX CPU "
              f"{want['psnr']:.4f}), SSIM {got['ssim']:.5f} "
              f"({want['ssim']:.5f}), dE76 {got['delta_e76']:.4f} "
              f"({want['delta_e76']:.4f})")
        if (abs(got["psnr"] - want["psnr"]) > EVAL_BAR_DB
                or abs(got["ssim"] - want["ssim"]) > EVAL_BAR_SSIM):
            raise AssertionError(
                f"{name} eval-15 outside {EVAL_BAR_DB} dB / "
                f"{EVAL_BAR_SSIM} SSIM of the JAX package: {got} vs {want}")

    # the default bilateral tail of retinex, curve, hybrid and decom through
    # the port's eval runner, on LOLDataset's synthetic eval15 split (its
    # pairs made once above)
    class Eval15(LOLDataset):
        def __getitem__(self, i):
            return (*pairs[i], f"synth_eval15_{i:04d}")

    ds15 = Eval15(split="eval15")
    if not ds15.is_synthetic:
        raise AssertionError("LOL data found on disk: JAX_EVAL15 holds the "
                             "synthetic eval15 set's numbers")
    for method in ("retinex", "curve", "hybrid", "decom"):
        pipe = llt.EnhancePipeline(llt.PipelineConfig(method=method),
                                   device="cuda")
        report = counted(f"eval {method}", lambda: eval_lol(
            pipe, ds15, max_images=15, parity=False, batch_size=5))
        want = JAX_EVAL15[method]
        print(f"  eval_lol {method} on {card}: {report['n_images']:.0f} "
              f"images, PSNR {report['psnr_mean']:.4f} dB (JAX CPU "
              f"{want['psnr']:.4f}), SSIM {report['ssim_mean']:.5f} "
              f"({want['ssim']:.5f}), dE76 {report['delta_e76_mean']:.4f} "
              f"({want['delta_e76']:.4f})")
        if (report["n_images"] != 15 or report["n_skipped"]
                or abs(report["psnr_mean"] - want["psnr"]) > EVAL_BAR_DB
                or abs(report["ssim_mean"] - want["ssim"]) > EVAL_BAR_SSIM):
            raise AssertionError(
                f"eval_lol {method} outside {EVAL_BAR_DB} dB / "
                f"{EVAL_BAR_SSIM} SSIM of the JAX package: {report} vs {want}")

    print(f"[4c] ({time.perf_counter() - t_start:.0f} s) "
          "VideoEnhancer(device='cuda'): the 1080p video benchmark's "
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
        if cfg.method == "retinex" or "guided" in name:
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

    print(f"[4d] ({time.perf_counter() - t_start:.0f} s) the host boundary: "
          "the planar and canvas entry points, enhance_stream on the pinned "
          "prefetch queue, the zlib PNG codec")
    host_pipe = llt.EnhancePipeline(cfg0, device="cuda")

    def planar_and_canvas(pipe, suffix=""):
        """Both entry points, each counted as its own path, against
        enhance_batch_device at 600x400 b48, Δ 0; the three device rates."""
        want = pipe.enhance_batch_device(x48).cpu().numpy()
        xp = x48.permute(0, 3, 1, 2).contiguous()
        cv = torch.from_numpy(pipe.stage_canvas(lows48)).to(dev)
        check = [("planar", counted(
            "planar" + suffix, lambda: pipe.enhance_batch_device_planar(xp)
            .permute(0, 2, 3, 1).cpu().numpy()))]
        check.append(("canvas", counted(
            "canvas" + suffix, lambda: pipe.crop_canvas(
                pipe.enhance_batch_device_canvas(cv, 400, 600), 400, 600))))
        for what, out in check:
            st = delta_stats(out, want)
            if st["max_abs"]:
                raise AssertionError(f"{what}{suffix} differs from "
                                     f"enhance_batch_device: {st}")
        ms = [cuda_ms(torch, fn, 10) for fn in (
            lambda: pipe.enhance_batch_device(x48),
            lambda: pipe.enhance_batch_device_planar(xp),
            lambda: pipe.enhance_batch_device_canvas(cv, 400, 600))]
        print(f"  planar and canvas{suffix} equal enhance_batch_device (Δ 0, "
              f"600x400 b48, canvas {tuple(cv.shape[-2:])}); on {card}: "
              + ", ".join(f"{n} {48e3 / t:.1f} img/s ({t:.3f} ms)"
                          for n, t in zip(("hwc", "planar", "canvas"), ms)))

    planar_and_canvas(host_pipe)
    planar_and_canvas(llt.EnhancePipeline(
        cfg0.replace(guided_radius=4, **guided), device="cuda"),
        " guided r4")

    # 64 distinct 600x400 frames in batches of 8, and 16 single 1080p frames
    frames600 = [lows48[i % 48] ^ np.uint8(i // 48) for i in range(64)]
    batches600 = [np.stack(frames600[i:i + 8]) for i in range(0, 64, 8)]
    f1080 = lows_of(1, 1080, 1920)[0]
    frames1080 = [f1080 ^ np.uint8(t) for t in range(16)]
    want600 = [host_pipe.enhance(f) for f in frames600]
    want1080 = [host_pipe.enhance(f) for f in frames1080]
    hb8_ms = cuda_ms(torch, lambda: host_pipe.enhance_batch(batches600[0]),
                     5)
    h1080_ms = cuda_ms(torch, lambda: host_pipe.enhance(f1080), 5)

    def stream(staging):
        """Two rounds of each stream, every frame byte-equal to enhance's;
        frames/s of the second round on the host's clock."""
        rates = []
        for src, want in ((batches600, want600), (frames1080, want1080)):
            for _ in range(2):
                t = time.perf_counter()
                outs = list(host_pipe.enhance_stream(iter(src),
                                                     staging=staging,
                                                     workers=2))
                dt = time.perf_counter() - t
                got = [f for o in outs for f in (o if o.ndim == 4 else [o])]
                bad = [i for i, (a, b) in enumerate(zip(got, want))
                       if not np.array_equal(a, b)]
                if len(got) != len(want) or bad:
                    raise AssertionError(
                        f"stream {staging}: {len(got)} frames of "
                        f"{len(want)}, frames {bad} differ from enhance")
            rates.append(len(want) / dt)
        print(f"  enhance_stream {staging} on {card}: 64 frames 600x400 "
              f"(batches of 8) {rates[0]:.1f} frames/s, 16 frames 1080p "
              f"{rates[1]:.1f} frames/s, each byte-equal to enhance "
              f"(enhance_batch host u8 in/out: b8 {8e3 / hb8_ms:.1f}, "
              f"1080p {1e3 / h1080_ms:.1f} frames/s)")

    for staging in ("hwc", "planar", "canvas"):
        counted(f"stream {staging}", lambda: stream(staging))
    del frames600, batches600, want600, frames1080, want1080

    def golden_and_file():
        """The golden fixtures and enhance_file through the zlib codec (the
        card host has no PIL; the module's handle is cleared where it
        does)."""
        saved, codec.Image = codec.Image, None
        try:
            data = ROOT / "tests" / "data"
            expected = json.loads((data / "expected_metrics.json")
                                  .read_text())
            for name, exp in expected.items():
                low = codec.decode_image(data / f"{name}_low.png")
                high = torch.from_numpy(
                    codec.decode_image(data / f"{name}_high.png")).to(dev)
                out = torch.from_numpy(host_pipe.enhance(low)).to(dev)
                ps = float(metrics.psnr_u8(out, high))
                ss = float(metrics.ssim_u8(out[None], high[None])[0])
                print(f"  golden {name} (zlib codec): PSNR {ps:.4f} dB "
                      f"(stored {exp['psnr_db']}), SSIM {ss:.5f} (stored "
                      f"{exp['ssim']})")
                if abs(ps - exp["psnr_db"]) > EVAL_BAR_DB or \
                        abs(ss - exp["ssim"]) > EVAL_BAR_SSIM:
                    raise AssertionError(f"golden {name} outside the bars")
            with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
                src, dst = Path(tmp) / "dark.png", Path(tmp) / "bright.png"
                codec.encode_image(lows48[0], src)
                host_pipe.enhance_file(src, dst)
                if not np.array_equal(codec.decode_image(dst),
                                      host_pipe.enhance(lows48[0])):
                    raise AssertionError("enhance_file differs from enhance")
            print("  enhance_file 600x400 through the zlib codec equals "
                  "enhance")
        finally:
            codec.Image = saved

    counted("golden and enhance_file", golden_and_file)

    print(f"[5] ({time.perf_counter() - t_start:.0f} s) "
          "EnhanceServer(device='cuda'), 4 threads x 4 requests")
    reqs = [synth_batch(1, 400, 600, seed=7, start=i)[0][0] for i in range(8)]
    reqs += [synth_batch(1, 480, 640, seed=7, start=i)[0][0]
             for i in range(8)]

    def phase5(name, cfg):
        # the guided paths also serve two 1080p requests
        rq = reqs + (list(lows_of(2, 1080, 1920)) if "guided" in name
                     else [])
        n = len(rq)
        ref = llt.EnhancePipeline(cfg, device="cuda", bucket=64)
        want = [ref.enhance(img) for img in rq]
        with llt.EnhanceServer(cfg, device="cuda") as server:
            for rnd in ("warm-up", "measured"):
                lat = [0.0] * n
                got = [None] * n

                def client(ids):
                    for i in ids:
                        t = time.perf_counter()
                        got[i] = server.submit(rq[i]).result(timeout=300)
                        lat[i] = (time.perf_counter() - t) * 1e3

                threads = [threading.Thread(target=client,
                                            args=(range(k, n, 4),))
                           for k in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                    if t.is_alive():
                        raise AssertionError("server client thread hung")
                bad = [i for i in range(n) if got[i] is None
                       or not np.array_equal(got[i], want[i])]
                if bad:
                    raise AssertionError(
                        f"{name} server: requests {bad} differ from "
                        "pipeline.enhance")
                print(f"  {name} {rnd}: {n}/{n} answered, equal to "
                      f"pipeline.enhance; latency p50 "
                      f"{np.percentile(lat, 50):.2f} ms p99 "
                      f"{np.percentile(lat, 99):.2f} ms on {card}")

    for name, cfg, _ in paths[:3] + conv_paths[3:4] + guided_paths[1:4:2]:
        counted(name, lambda: phase5(name, cfg))

    def phase5_http():
        """HttpEnhanceServer on a loopback port: PNG requests of two shapes
        from 4 threads (a connection each), each answer equal to
        pipeline.enhance; p50/p99 on the host's clock."""
        ref = llt.EnhancePipeline(cfg0, device="cuda", bucket=64)
        want = [ref.enhance(img) for img in reqs]
        bodies = [codec.encode_image(img, format="PNG") for img in reqs]
        n = len(reqs)
        srv = HttpEnhanceServer(cfg0, host="127.0.0.1", port=0,
                                device="cuda").start()
        try:
            for rnd in ("warm-up", "measured"):
                lat, got = [0.0] * n, [None] * n

                def client(ids):
                    conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                                      timeout=300)
                    try:
                        for i in ids:
                            t = time.perf_counter()
                            conn.request("POST", "/enhance", body=bodies[i],
                                         headers={"Content-Length":
                                                  str(len(bodies[i]))})
                            r = conn.getresponse()
                            body = r.read()
                            lat[i] = (time.perf_counter() - t) * 1e3
                            if r.status == 200:
                                got[i] = codec.decode_image(body)
                    finally:
                        conn.close()

                threads = [threading.Thread(target=client,
                                            args=(range(k, n, 4),))
                           for k in range(4)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
                    if t.is_alive():
                        raise AssertionError("HTTP client thread hung")
                bad = [i for i in range(n) if got[i] is None
                       or not np.array_equal(got[i], want[i])]
                if bad:
                    raise AssertionError(f"HTTP answers {bad} differ from "
                                         "pipeline.enhance")
                print(f"  HTTP POST /enhance {rnd}: {n}/{n} answered, equal "
                      f"to pipeline.enhance; latency p50 "
                      f"{np.percentile(lat, 50):.2f} ms p99 "
                      f"{np.percentile(lat, 99):.2f} ms on {card} (PNG in "
                      "and out, zlib codec)")
            conn = http.client.HTTPConnection("127.0.0.1", srv.port,
                                              timeout=60)
            conn.request("GET", "/stats")
            print(f"  /stats: {conn.getresponse().read().decode()}")
            conn.close()
        finally:
            srv.close()

    counted("http", phase5_http)

    print(f"[6] ({time.perf_counter() - t_start:.0f} s) launches per path "
          f"(phases 4-5, 4c): {launches}")
    expected = [(name, kernels, never[name]) for name, _, kernels in paths]
    expected += [(name, kernels, nv + ("kc",))
                 for name, _, _, kernels, nv in video_paths]
    expected += [("hwc", ("k8",), never["hwc"])]
    expected += host_paths
    check_launches(expected, launches)
    for name, (k, n, ref) in per_block.items():
        if launches[name][k] != n * launches[name][ref]:
            raise AssertionError(f"path {name}: {launches[name][k]} {k} "
                                 f"launches, not {n} per {ref} launch "
                                 f"({launches[name][ref]})")
    print("  the conv paths launched their kernel per block as expected: "
          + ", ".join(f"{name} {n} {k} per {ref}"
                      for name, (k, n, ref) in per_block.items()))
    total = {k: sum(launches[name][k] for name, kernels, _ in expected
                    if k in kernels) for k in wrappers}
    # K5's two arms: the launches of the paths whose tail is guided
    # (guided.cuh) and of those whose tail is the bilateral (the tile
    # engine)
    k5_guided = {name for name, cfg, kernels in paths
                 if "k5" in kernels and cfg.denoise_taps == "guided"}
    total["k5g"] = sum(launches[name]["k5"] for name in k5_guided)
    total["k5b"] = total["k5"] - total["k5g"]
    err["k5g"] = err["k5b"] = err["k5"]
    print(f"  K5 launches: bilateral arm {total['k5b']}, guided arm "
          f"{total['k5g']}")

    phase7_training(torch, card, wrappers, t_start)
    par_paths, par_launches = phase8_parallel(torch, card, wrappers,
                                              t_start)
    print(f"  phase 8 launches per path: {par_launches}")
    check_launches(par_paths, par_launches)
    for name, kernels, _ in par_paths:
        for k in kernels:
            total[k] += par_launches[name][k]
    raw_paths, raw_launches = phase9_raw(torch, card, wrappers, t_start)
    print(f"  phase 9 launches per path: {raw_launches}")
    check_launches(raw_paths, raw_launches)
    for name, kernels, _ in raw_paths:
        for k in kernels:
            total[k] += raw_launches[name][k]
    arm_paths, arm_launches = phase10_conv_arms_utils(torch, card, wrappers,
                                                      t_start)
    print(f"  phase 10 launches per path: {arm_launches}")
    check_launches(arm_paths, arm_launches)
    for name, kernels, _ in arm_paths:
        for k in kernels:
            total[k] += arm_launches[name][k]
            if k == "k5":
                arm = "k5g" if "quality " in name else "k5b"
                total[arm] += arm_launches[name][k]
    # phase 11 adds a count a launch its wrapper made: the eager steps and
    # one a launch captured into a graph, not a replay's
    bench_paths, bench_launches = phase11_bench(torch, card, wrappers,
                                                t_start, k1_ms)
    print(f"  phase 11 launches per path: {bench_launches}")
    check_launches(bench_paths, bench_launches)
    for name, kernels, _ in bench_paths:
        for k in kernels:
            total[k] += bench_launches[name][k]
            if k == "k5":
                total["k5b"] += bench_launches[name][k]

    src = "low_light_image_enhancement_tpu_torch/kernels/csrc/"
    tpu = "low_light_image_enhancement_tpu/kernels/"

    def row(name, k, source, replaces, t, plain, bnd, library=None):
        # library: one PyTorch call computing the same function, where one
        # exists (F.conv2d for K6); none does for the others
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": tpu + replaces, "launches": total[k],
                "max_abs_err": err[k], "ms": t, "plain_ms": plain,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library}

    print(json.dumps({"kernels": [
        row("fused_retinex (K1)", "k1", "retinex_tile.cu",
            "fused_enhance.py:476", k1_ms, k1_plain_ms, k1_b),
        dict(row("fused_retinex_canvas (K1's canvas form)", "kc",
                 "curve_tile.cu", "fused_enhance.py:476", kc_ms, kc_plain_ms,
                 kc_b),
             forms=[{"form": "1080p b1", "ms": kc1080[0],
                     "plain_ms": kc1080[1], "bound_ms": kc1080[2][0],
                     "bound_by": kc1080[2][1]}]),
        row("fused_curve_enhance (K3)", "k3", "curve_tile.cu",
            "fused_enhance.py:257", k3_ms, k3_plain_ms, k3_b),
        row("fused_retinex_ema (K4)", "k4", "retinex_tile.cu",
            "fused_enhance.py:350", *video_ms["K4 1920x1080 b1"][-1]),
        row("tiled_denoise (K5, bilateral arm: quality_fast)", "k5b",
            "tiled_denoise.cu", "tiled_denoise.py:42",
            *k5_ms["quality_fast"]),
        row("tiled_denoise (K5, guided arm: quality)", "k5g",
            "tiled_denoise.cu", "tiled_denoise.py:42", k5_t, k5_plain_ms,
            k5_b),
        row("conv2d_patch_mxu (K6a)", "k6a", "mxu_conv.cu",
            "mxu_conv.py:205", k6a_ms, k6a_plain_ms, k6a_b, k6a_lib_ms),
        row("conv2d_dense9_mxu (K6b)", "k6b", "mxu_conv.cu",
            "mxu_conv.py:288", k6b_ms, k6b_plain_ms, k6b_b, k6b_lib_ms),
        row("fcn_cascade_mxu (K7)", "k7", "fcn_cascade.cu",
            "fcn_cascade.py:169", k7_ms, k7_plain_ms, k7_b),
        row("enhance_hwc_u8 / fused_retinex_hwc (K8)", "k8",
            "retinex_tile.cu", "fused_enhance_hwc.py:99", k8_ms, k8_plain_ms,
            k8_b),
        dict(row("blur_illumination (K1/K3/K4 blur past the tiles)", "kb",
                 "fused_enhance.cu", "fused_enhance.py:146", kb_ms,
                 kb_plain_ms, kb_b),
             forms=[{"form": "r32 e8 600x400 b48", "ms": kb32[0],
                     "plain_ms": kb32[1], "bound_ms": kb32[2][0],
                     "bound_by": kb32[2][1]}]),
        # the guided tails of K1 (and its gain form), K3 and K4: the default
        # form's numbers (K1 r 2, luma), then every timed form's
        dict(row("fused_guided (the guided tails of K1, K3, K4)", "kg",
                 "fused_guided.cu",
                 "fused_enhance.py:69",
                 *form_ms["K1 guided r2 luma 600x400 b48"]),
             forms=[{"form": name, "ms": t, "plain_ms": tp,
                     "bound_ms": bd[0], "bound_by": bd[1]}
                    for name, (t, tp, bd) in form_ms.items()
                    if "guided" in name]),
    ]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
