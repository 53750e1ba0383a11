#!/usr/bin/env python3
"""K6 on the card in about a minute: what the compiler made of the conv
kernels, whether each form agrees with its plain version, and the layer
times beside one cuDNN call and the bound.

1. the kernel library built from the sources (``kernels/_build.py``);
   ``ptxas -v`` of ``csrc/mxu_conv.cu`` (registers, spills, shared memory
   of each kernel) and, from ``cuobjdump -sass`` of the library, the count
   of HGMMA (wgmma) instructions in each conv kernel function;
2. bf16 K6a/K6b (the tensor-core kernel) against ``conv3x3_plain`` on
   random activations: 1 and 2 groups, Cout 8-32, relu/tanh/leaky, every
   fcn dilation and one past the contiguous halo row (d 66), at small odd
   shapes and on the nets' blocks; f32 (the CUDA cores) on one shape each;
   bar: one bf16 step (or 1e-5 where the sum cancels), f32 1e-5;
3. CUDA-event times of the device alone at the 600x400 b48 blocks: K6a
   64->32 (the curve CNN's c5) and 32->32 on hybrid's block, K6b 24->24 at
   d 2 and d 32 on fcn's block, each beside one F.conv2d (bf16,
   channels_last) and the bound (bytes over 3.35 TB/s, operations over 989
   TFLOP/s).

Needs a CUDA card and nvcc; run from the repository root:
``python3 tools/probe_conv.py``.
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
    mxu_conv as mx,
)

HBM_BYTES_PER_S, BF16_OPS_PER_S = 3.35e12, 989e12
F32_BAR = 1e-5
FCN_DILATIONS = (2, 4, 8, 16, 32, 1)
# the 600x400 b48 blocks (pad_block): hybrid 416x640, fcn 528x640
HYBRID_BLOCK, FCN_BLOCK = (416, 640), (528, 640)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def compiler_report(lib_path: Path) -> None:
    src = _build._CSRC / "mxu_conv.cu"
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        r = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                            "-Xptxas", "-v", "-c", "-o",
                            str(Path(tmp) / "m.o"), str(src)],
                           capture_output=True, text=True, timeout=600)
    fn = None
    for line in r.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        elif "C75" in line or "arning" in line:
            print(f"  ptxas: {line.strip()}")
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
        elif fn and "conv3x3" in fn and "HGMMA" in line:
            counts[fn] = counts.get(fn, 0) + 1
            sample.setdefault(fn, " ".join(line.split()))
    for fn in sorted(counts):
        print(f"  sass {fn}: {counts[fn]} HGMMA, e.g. {sample[fn]}")
    if not counts:
        raise AssertionError("no HGMMA in any conv kernel of the library")


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
    compiler_report(lib_path)

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(21)

    def urand(shape, dt):
        return torch.rand(shape, generator=gen, device=dev).to(dt)

    def params(cin, cout):
        w = torch.randn((cout, cin, 3, 3), generator=gen, device=dev)
        return (w * (2.0 / (9 * cin)) ** 0.5,
                0.1 * torch.randn((cout,), generator=gen, device=dev))

    print("[2] against conv3x3_plain")
    cases = [((32,), 32, "relu", 1), ((32, 32), 32, "relu", 1),
             ((32, 32), 24, "tanh", 1), ((16,), 8, "relu", 1),
             ((8, 24), 16, "none", 1)]
    cases += [((24,), 24, "leaky", d) for d in FCN_DILATIONS + (66,)]
    for groups, cout, act, d in cases:
        w, b = params(sum(groups), cout)
        shapes = [(2, 37, 45), (1, 70, 150)]
        shapes.append((2,) + (FCN_BLOCK if d != 1 or groups == (24,)
                              else HYBRID_BLOCK))
        for shape in shapes:
            for dt in ((torch.bfloat16, torch.float32)
                       if shape == shapes[0] else (torch.bfloat16,)):
                xs = [urand(shape + (c,), dt) for c in groups]
                if d == 1 and len(groups) <= 2 and act != "leaky":
                    got = mx.conv2d_patch_mxu(xs, w, b, act=act)
                else:
                    got = mx.conv2d_dense9_mxu(xs[0], w, b, act=act,
                                               dilation=d)
                torch.cuda.synchronize()
                conv_check(f"{'+'.join(map(str, groups))}->{cout} {act} d{d}"
                           f" {str(dt)[6:]} {shape}", got,
                           mx.conv3x3_plain(xs, w, b, act, d))

    print(f"[3] 600x400 b48 blocks on {card}, ms")
    bf = torch.bfloat16
    for name, groups, cout, d, (h, wd) in (
            ("K6a c5 64->32 relu", (32, 32), 32, 1, HYBRID_BLOCK),
            ("K6a 32->32 relu", (32,), 32, 1, HYBRID_BLOCK),
            ("K6b c2 24->24 d2 leaky", (24,), 24, 2, FCN_BLOCK),
            ("K6b 24->24 d32 leaky", (24,), 24, 32, FCN_BLOCK)):
        xs = [urand((48, h, wd, c), bf) for c in groups]
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
        t_k = (cuda_ms(kern, 5) + cuda_ms(kern, 5)) / 2
        t_l = cuda_ms(lambda: F.conv2d(xcat, wl, b.to(bf), padding=d,
                                       dilation=d), 5)
        bd = bound_ms(48 * h * wd, sum(groups), cout)
        print(f"  {name} {h}x{wd}: kernel {t_k:.4f}, one F.conv2d "
              f"{t_l:.4f}, bound {bd:.4f} ({t_k / bd:.2f}x)")
        del xs, xcat
    return 0


if __name__ == "__main__":
    sys.exit(main())
