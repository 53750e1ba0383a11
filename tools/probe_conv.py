#!/usr/bin/env python3
"""K6 and K7 on the card in about a minute: what the compiler made of the
conv kernels, whether each form agrees with its plain version, and the
layer times beside one cuDNN call and the bound.

1. the kernel library built from the sources (``kernels/_build.py``);
   ``ptxas -v`` of ``csrc/mxu_conv.cu`` and ``csrc/fcn_cascade.cu``
   (registers, spills, shared memory of each kernel, and any warning:
   C7520 "wgmma serialized" must not appear) and, from ``cuobjdump
   -sass`` of the library, the count of HGMMA (wgmma) instructions in
   each conv and cascade kernel function; the library's chunk widths
   (``llie_conv_plan``) against the CPU mirror of the kernel's plan in
   ``tests/test_torch_conv_wgmma.py`` over the widths the configs reach;
2. bf16 K6a/K6b (the tensor-core kernel) against ``conv3x3_plain`` on
   random activations: 1 and 2 groups, Cout 8-64 (12 and 15 padded),
   groups of 20 channels (padded), the curve CNN at 64 features (64 -> 64,
   128 -> 64 in two groups, 128 -> 48), one group of 320 channels, and the
   widths past whole halo rows (piece groups: 160 + 160 -> 160, 384 -> 8,
   512 + 512 -> 24) and past one chunk's weights (streamed: 640 + 640
   -> 640, 1024 + 1024 -> 24, 1024 -> 24 at d 64 and 128), relu/tanh/leaky,
   every fcn dilation and one
   past the contiguous halo row (d 66), at small odd shapes and on the
   nets' blocks; f32 (the CUDA cores) on one shape each, but for the
   piece-group widths; bar: one bf16 step (or 1e-5 where the sum
   cancels), f32 1e-5; the piece-group widths against float64 sums
   instead, within one bf16 step or the f32 sum's rounding
   (``exact_check``); then K7 (bf16 and f32) equal to K6b layer by
   layer, bit for bit;
3. CUDA-event times of the device alone at the 600x400 b48 blocks: K6a
   64->32 (the curve CNN's c5) and 32->32 on hybrid's block, K6b 24->24 at
   d 2 and d 32 on fcn's block, each beside one F.conv2d (bf16,
   channels_last) and the bound (bytes over 3.35 TB/s, operations over 989
   TFLOP/s); the curve CNN's c2 and c5 at 64 features and c5 at 160;
   K7's six layers beside six K6b launches; the streamed form at
   curve_features 1024's c7 (2048 -> 24, b2).

Needs a CUDA card and nvcc; run from the repository root:
``python3 tools/probe_conv.py``; ``--times`` runs the build and part 3
alone (copied into an unpacked older tree and run there and here in
turns, it compares two versions on one card).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    _build,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    fcn_cascade as fc,
)
from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    mxu_conv as mx,
)

HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12
F32_BAR = 1e-5
FCN_DILATIONS = (2, 4, 8, 16, 32, 1)
# the 600x400 b48 blocks (pad_block): hybrid 416x640, fcn 528x640
HYBRID_BLOCK, FCN_BLOCK = (416, 640), (528, 640)
# layers past whole halo rows: the kernel loads them in groups of pieces
PIECE_GROUP_CASES = (((160, 160), 160), ((384,), 8), ((512, 512), 24))
# past one chunk's weights beside a ring (16 pieces of 64 channels, 14 at
# dilation 64 and more): the weights streamed by piece group
STREAM_CASES = (((640, 640), 640, "relu", 1), ((1024, 1024), 24, "tanh", 1),
                ((1024,), 24, "leaky", 64), ((1024,), 24, "leaky", 128))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def compiler_report(lib_path: Path) -> None:
    for name in ("mxu_conv.cu", "fcn_cascade.cu"):
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                                "-Xptxas", "-v", "-c", "-o",
                                str(Path(tmp) / "m.o"),
                                str(_build._CSRC / name)],
                               capture_output=True, text=True, timeout=900)
        fn = None
        for line in r.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif "C75" in line or "arning" in line:
                print(f"  ptxas {name}: {line.strip()}")
                if "C7520" in line:
                    raise AssertionError(f"serialized wgmma in {name}")
            elif fn and ("registers" in line or "spill" in line):
                print(f"  ptxas {fn}: {line.split('info    :')[-1].strip()}")
    dump = Path(_build.find_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(dump), "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=600).stdout
    counts, sample, fn = {}, {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
        elif fn and ("conv3x3" in fn or "cascade" in fn) and "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
            sample.setdefault(fn, " ".join(line.split()))
    for fn in sorted(counts):
        print(f"  sass {fn}: {counts[fn]} HGMMA, e.g. {sample[fn]}")
    if not counts:
        raise AssertionError("no HGMMA in any conv kernel of the library")
    if not any("cascade" in fn for fn in counts):
        raise AssertionError("no HGMMA in the cascade kernel")


def plan_report(lib) -> None:
    """The library's chunk width of each layer the curve CNN reaches (and
    fcn's at each dilation) against the CPU mirror of the kernel's plan
    in the tests: the two must not drift apart."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tests"))
    from test_torch_conv_wgmma import wgmma_plan

    layers = [((24,), 24, d) for d in FCN_DILATIONS + (64, 66)]
    layers += [((c,), 24, d) for c in (1024, 2048) for d in (64, 128)]
    for f in (8, 16, 20, 24, 32, 40, 48, 64, 96, 128, 160, 192, 256, 384,
              512, 520, 640, 1024):
        fp = mx.padded(f)
        for n_iter in (4, 8, 16):
            layers += [((fp,), fp, 1), ((fp, fp), fp, 1),
                       ((fp, fp), 3 * n_iter, 1)]
    for groups, cout, d in sorted(set(layers)):
        g = wgmma_plan(groups, cout, d)
        want = 0 if g is None else g["nc"]
        got = lib.llie_conv_plan(groups[0], (groups + (0,))[1], cout, d)
        if got != want:
            raise AssertionError(f"llie_conv_plan {groups} -> {cout} d {d}: "
                                 f"{got}, the tests' mirror {want}")
    print(f"  llie_conv_plan equals the tests' mirror on {len(set(layers))} "
          "layers")


def conv_check(what, got, want):
    g, w = got.float(), want.float()
    d = (g - w).abs()
    if got.dtype == torch.float32:
        bar = torch.full_like(d, F32_BAR)
    else:
        mag = torch.maximum(g.abs(), w.abs()).clamp_min(1e-30)
        bar = torch.exp2(torch.floor(torch.log2(mag)) - 7).clamp_min(F32_BAR)
    over = int((d > bar).sum())
    print(f"  {what}: max|d|={float(d.max()):.3e} differing share="
          f"{float((d > 0).float().mean()):.3e} outside the bar {over}")
    if over or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{what}: {over} values outside the bar")


def exact_check(what, got, plain, xs, w, b, act, dil):
    """A piece-group layer against the same function in float64 (the bf16
    inputs and weights, exact sums): within one bf16 step of the value or
    the f32 sum's own rounding, sqrt(9 Cin) 2^-24 sum |x w|; conv3x3_plain
    is read the same way, to tell the kernel's faults from f32 rounding."""
    x = torch.cat(xs, -1).permute(0, 3, 1, 2).double()
    wd = w.to(torch.bfloat16).double()
    z = F.conv2d(x, wd, padding=dil, dilation=dil) + b.double()[:, None, None]
    ref = mx.ACTS[act](z).permute(0, 2, 3, 1)
    mag = F.conv2d(x.abs(), wd.abs(), padding=dil, dilation=dil)
    rounding = (9 * x.shape[1]) ** 0.5 * 2.0 ** -24 * mag.permute(0, 2, 3, 1)
    step = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30)))
                      - 7)
    bar = torch.maximum(step, rounding).clamp_min(F32_BAR)
    overs = {}
    for name, t in (("kernel", got), ("plain", plain)):
        d = (t.double() - ref).abs()
        overs[name] = int((d > bar).sum())
        print(f"  {what} {name} vs float64: max|d|={float(d.max()):.3e} "
              f"outside one step or the f32 rounding {overs[name]}")
    if overs["kernel"] or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: {overs['kernel']} values off float64")


def cuda_ms(fn, iters):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(px, cin, cout):
    return max(px * (cin + cout) * 2 / HBM_BYTES_PER_S,
               px * cout * (2 * 9 * cin + 2) / BF16_OPS_PER_S) * 1e3


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_conv: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[1] {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = _build.library_path()
    _build.load_library()
    print(f"  build {time.perf_counter() - t0:.1f} s -> {lib_path.name}")
    times_only = "--times" in sys.argv[1:]
    if not times_only:
        compiler_report(lib_path)
        plan_report(_build.load_library())

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)

    def urand(shape, dt):
        return torch.rand(shape, generator=gen, device=dev).to(dt)

    def params(cin, cout):
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
        return (w * (2.0 / (9 * cin)) ** 0.5,
                0.1 * torch.randn((cout,), generator=gen, device=dev))

    if not times_only:
        print("[2] against conv3x3_plain")
        cases = [((32,), 32, "relu", 1), ((32, 32), 32, "relu", 1),
                 ((32, 32), 24, "tanh", 1), ((16,), 8, "relu", 1),
                 ((8, 24), 16, "none", 1), ((32, 32), 12, "tanh", 1),
                 ((32, 32), 48, "tanh", 1), ((64,), 64, "relu", 1),
                 ((64, 64), 64, "relu", 1), ((64, 64), 48, "tanh", 1),
                 ((20, 20), 20, "relu", 1), ((32, 12), 15, "tanh", 1),
                 ((320,), 64, "relu", 1)]
        cases += [(g, c, "tanh" if c == 24 else "relu", 1)
                  for g, c in PIECE_GROUP_CASES]
        cases += [((24,), 24, "leaky", d) for d in FCN_DILATIONS + (66,)]
        cases += list(STREAM_CASES)
        for groups, cout, act, d in cases:
            w, b = params(sum(groups), cout)
            shapes = [(2, 37, 45), (1, 70, 150)]
            if (groups, cout, act, d) not in STREAM_CASES:
                shapes.append((2,) + (FCN_BLOCK if d != 1 or groups == (24,)
                                      else HYBRID_BLOCK))
            else:
                shapes.append((1, 140, 200))  # two strips of each phase
            # f32 (the CUDA-core form) on the first shape, but for the piece
            # group widths, a bf16 path: at 320 -> 160 the f32 sums of 2,880
            # products differ from cuDNN's order by ~1.1e-5 (found), past the
            # 1e-5 bar set at the nets' widths
            f32 = ((groups, cout) not in PIECE_GROUP_CASES
                   and (groups, cout, act, d) not in STREAM_CASES)
            for shape in shapes:
                first = shape == shapes[0] and f32
                for dt in ((torch.bfloat16, torch.float32) if first
                           else (torch.bfloat16,)):
                    xs = [urand(shape + (c,), dt) for c in groups]
                    if d == 1 and len(groups) <= 2 and act != "leaky":
                        got = mx.conv2d_patch_mxu(xs, w, b, act=act)
                    else:
                        got = mx.conv2d_dense9_mxu(xs[0], w, b, act=act,
                                                   dilation=d)
                    torch.cuda.synchronize()
                    what = (f"{'+'.join(map(str, groups))}->{cout} {act} d{d} "
                            f"{str(dt)[6:]} {shape}")
                    plain = mx.conv3x3_plain(xs, w, b, act, d)
                    if f32:
                        conv_check(what, got, plain)
                    else:
                        # 9 * Cin up to 9,216 f32 products: near 0 the sums of
                        # the kernel and of cuDNN may part by more than 1e-5
                        exact_check(what, got, plain, xs, w, b, act, d)

        print("[2b] K7 against K6b layer by layer (bit for bit)")
        ws, bs = zip(*[params(24, 24) for _ in FCN_DILATIONS])
        for shape in ((3, 70, 72), (4,) + FCN_BLOCK):
            for dt in (torch.bfloat16, torch.float32):
                x = urand(shape + (24,), dt)
                chain = x
                for w, b, d in zip(ws, bs, FCN_DILATIONS):
                    chain = mx.conv2d_dense9_mxu(chain, w, b, act="leaky",
                                                 dilation=d)
                got = fc.fcn_cascade_mxu(x, ws, bs, FCN_DILATIONS)
                torch.cuda.synchronize()
                same = torch.equal(got, chain)
                print(f"  K7 {str(dt)[6:]} {shape}: equal to K6b layer by "
                      f"layer: {same}")
                if not same:
                    d = (got.float() - chain.float()).abs()
                    share = float((d > 0).float().mean())
                    raise AssertionError(f"K7 differs: max {float(d.max())}"
                                         f" share {share}")

    print(f"[3] 600x400 b48 blocks on {card}, ms")
    bf = torch.bfloat16
    for name, groups, cout, d, (h, wd) in (
            ("K6a c5 64->32 relu", (32, 32), 32, 1, HYBRID_BLOCK),
            ("K6a 32->32 relu", (32,), 32, 1, HYBRID_BLOCK),
            ("K6b c2 24->24 d2 leaky", (24,), 24, 2, FCN_BLOCK),
            ("K6b 24->24 d32 leaky", (24,), 24, 32, FCN_BLOCK),
            ("K6a f64 c2 64->64 relu", (64,), 64, 1, HYBRID_BLOCK),
            ("K6a f64 c5 128->64 relu", (64, 64), 64, 1, HYBRID_BLOCK),
            ("K6a f160 c5 320->160 relu", (160, 160), 160, 1,
             HYBRID_BLOCK),
            ("K6a f1024 c7 2048->24 b2 relu", (1024, 1024), 24, 1,
             HYBRID_BLOCK)):
        bsz = 2 if " b2 " in name else 48
        xs = [urand((bsz, h, wd, c), bf) for c in groups]
        w, b = params(sum(groups), cout)
        act = "leaky" if d != 1 else "relu"
        if name.startswith("K6a"):
            def kern():
                return mx.conv2d_patch_mxu(xs, w, b, act=act)
        else:
            def kern():
                return mx.conv2d_dense9_mxu(xs[0], w, b, act=act, dilation=d)
        xcat = torch.cat(xs, -1).permute(0, 3, 1, 2)
        wl = w.to(bf).contiguous(memory_format=torch.channels_last)
        try:
            t_k = (cuda_ms(kern, 5) + cuda_ms(kern, 5)) / 2
        except ValueError as e:  # a tree whose kernel refuses the width
            print(f"  {name} {h}x{wd}: refused ({e})")
            continue
        t_l = cuda_ms(lambda: F.conv2d(xcat, wl, b.to(bf), padding=d,
                                       dilation=d), 5)
        bd = bound_ms(bsz * h * wd, sum(groups), cout)
        print(f"  {name} {h}x{wd}: kernel {t_k:.4f}, one F.conv2d "
              f"{t_l:.4f}, bound {bd:.4f} ({t_k / bd:.2f}x)")
        del xs, xcat
    x = urand((48,) + FCN_BLOCK + (24,), bf)
    ws, bs = zip(*[params(24, 24) for _ in FCN_DILATIONS])
    bd = max(bound_ms(48 * FCN_BLOCK[0] * FCN_BLOCK[1], 24, 24),
             48 * FCN_BLOCK[0] * FCN_BLOCK[1] * 24 * 6 * (2 * 9 * 24 + 2)
             / BF16_OPS_PER_S * 1e3)
    t = (cuda_ms(lambda: fc.fcn_cascade_mxu(x, ws, bs, FCN_DILATIONS), 3)
         + cuda_ms(lambda: fc.fcn_cascade_mxu(x, ws, bs, FCN_DILATIONS), 3))
    print(f"  K7 c2-c7 bf16 {FCN_BLOCK[0]}x{FCN_BLOCK[1]}: {t / 2:.4f} "
          f"(bound {bd:.4f})")

    def chain():
        h = x
        for w, b, d in zip(ws, bs, FCN_DILATIONS):
            h = mx.conv2d_dense9_mxu(h, w, b, act="leaky", dilation=d)
        return h

    print(f"  K6b c2-c7 bf16, six launches: {cuda_ms(chain, 3):.4f}")

    for w, b, d in zip(ws, bs, FCN_DILATIONS):
        t6 = cuda_ms(lambda: mx.conv2d_dense9_mxu(x, w, b, act="leaky",
                                                  dilation=d), 3)
        t7 = cuda_ms(lambda: fc.fcn_cascade_mxu(x, (w,), (b,), (d,)), 3)
        print(f"  one layer d {d}: K6b {t6:.4f}, K7 {t7:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
