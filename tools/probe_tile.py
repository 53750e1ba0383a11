#!/usr/bin/env python3
"""The tile engine's kernels (K1 and K4 in ``csrc/retinex_tile.cu``, K3 in
``csrc/curve_tile.cu``, K5's bilateral arm in ``csrc/tiled_denoise.cu``),
the blur plane past the tiles (``blur_illumination`` in
``csrc/fused_enhance.cu``) and the guided kernels (the guided tails of K1,
K3 and K4 in ``csrc/fused_guided.cu``, K5's guided arm in
``csrc/tiled_denoise.cu``): what their compiler says.

``nvcc -Xptxas -v`` of the sources that hold them (this tree's
``csrc/retinex_tile.cu``, ``csrc/curve_tile.cu``, ``csrc/fused_guided.cu``,
``csrc/tiled_denoise.cu`` and ``csrc/fused_enhance.cu``; copied into an
older tree, whichever of them it has): registers, stack frame, spills and
shared memory of each kernel. Then, from the built library, each guided
kernel's, K5's bilateral kernel's and each blur form's registers, local
memory, dynamic shared memory and blocks an SM at that shared memory (the
occupancy API: ``llie_fused_guided_plan`` for each family at blur radius
2, ``llie_tiled_denoise_guided_plan``,
``llie_tiled_denoise_bilateral_plan`` and ``llie_blur_plan`` at radii 16,
32, 64 and 128, where the tree has them). A tile, blur, bilateral or
guided kernel with a stack frame or a spill fails the probe. The kernels'
agreement with their plain versions and the plans' with their CPU mirrors
are ``chip_smoke.py``'s; their times are ``tools/time_fused.py``'s.

``--sass FILE`` instead writes the SASS of the built library's tile
kernels (``cuobjdump -sass``) to FILE, for reading off the card.

Needs a CUDA card and nvcc; run from the root of a tree:
``python3 tools/probe_tile.py``.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from low_light_image_enhancement_tpu_torch.kernels import (  # noqa: E402
    _build,
)

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def _demangle(names):
    tool = Path(_build.find_nvcc()).with_name("cu++filt")
    if not tool.exists() and not shutil.which("c++filt"):
        return {n: n for n in names}
    cmd = [str(tool)] if tool.exists() else ["c++filt"]
    out = subprocess.run(cmd, input="\n".join(names), capture_output=True,
                         text=True, timeout=60).stdout.splitlines()
    return dict(zip(names, out)) if len(out) == len(names) else {
        n: n for n in names}


def compiler_report() -> None:
    """ptxas -v of the sources holding K1, K4, K3 and the guided kernels,
    compiled at once."""
    names = [n for n in ("retinex_tile.cu", "curve_tile.cu",
                         "fused_enhance.cu", "fused_guided.cu",
                         "tiled_denoise.cu")
             if (_build._CSRC / n).exists()]
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        procs = [(n, subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             "-o", str(Path(tmp) / f"{n}.o"), str(_build._CSRC / n)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for n in names]
        reports = [(n, p.communicate(timeout=1200)[1]) for n, p in procs]
    bad = []
    for name, err in reports:
        props, fn = {}, None
        for line in err.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                fn = m.group(1)
                props.setdefault(fn, [])
            elif fn and ("stack frame" in line or "registers" in line):
                props[fn].append(line.split("info    :")[-1].strip())
            elif "arning" in line:
                print(f"  ptxas {name}: {line.strip()}")
        pretty = _demangle(list(props))
        for fn, lines in props.items():
            short = pretty[fn]
            if not re.search(r"retinex|ema|curve|guided|blur|bilateral",
                             short):
                continue
            short = short.split(">(")[0].replace("llie::", "") + ">"
            print(f"  ptxas {name} {short}: {' | '.join(lines)}")
            if re.search(r"tile::|guided|blur::|denoise_bilateral",
                         pretty[fn]):
                text = " ".join(lines)
                frame = re.search(r"(\d+) bytes stack frame", text)
                spill = re.findall(r"(\d+) bytes spill", text)
                if (frame and int(frame.group(1))) or any(
                        int(s) for s in spill):
                    bad.append(short)
    if bad:
        raise AssertionError(f"stack or spills in {', '.join(bad)}")


def guided_occupancy() -> None:
    """Each guided kernel, K5's bilateral kernel and each blur form as the
    built library reports it on this card."""
    lib = _build.load_library()
    plans = [(f"fused_guided {fam}", lambda r, j, w, f=f:
              lib.llie_fused_guided_plan(f, r, j, w))
             for f, fam in ((0, "K1"), (2, "K3 (blur r 2)"), (1, "K1 gain"),
                            (3, "K4"))]
    plans.append(("K5 guided", lib.llie_tiled_denoise_guided_plan))
    bad = []
    for what, plan in plans:
        for joint in (1, 0):
            for r in range(1, 9):
                regs, local, smem, blocks = (plan(r, joint, w)
                                             for w in range(4))
                print(f"  {what} r {r} {'luma' if joint else 'perchannel'}:"
                      f" {regs} registers, {local} bytes local, "
                      f"{smem} bytes shared, {blocks} blocks an SM")
                if local:
                    bad.append(f"{what} r {r} joint {joint}")
    if hasattr(lib, "llie_tiled_denoise_bilateral_plan"):
        fn = lib.llie_tiled_denoise_bilateral_plan
        regs, local, smem, blocks = (fn(w) for w in range(4))
        print(f"  K5 bilateral (tile engine): {regs} registers, {local} "
              f"bytes local, {smem} bytes shared, {blocks} blocks an SM")
        if local:
            bad.append("K5 bilateral")
    if hasattr(lib, "llie_blur_plan"):
        fn = lib.llie_blur_plan
        for form, what in enumerate(("u8 planar", "u8 HWC", "f32 planar",
                                     "f32 HWC")):
            for r in (16, 32, 64, 128):
                regs, local, blocks = (fn(r, form, w) for w in (13, 14, 15))
                print(f"  blur_illumination {what} r {r}: {regs} registers, "
                      f"{local} bytes local, {fn(r, form, 0)} bytes shared, "
                      f"{blocks} blocks an SM; chunks {fn(r, form, 3)} x "
                      f"{fn(r, form, 6)} (rows x columns)")
                if local:
                    bad.append(f"blur {what} r {r}")
    if bad:
        raise AssertionError(f"local memory (stack or spills) in "
                             f"{', '.join(bad)}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("probe_tile: CUDA is not available", file=sys.stderr)
        return 1
    print(f"{card_line()} | torch {torch.__version__} | {ROOT}")
    if argv[:1] == ["--sass"]:
        _build.load_library()
        dump = Path(_build.find_nvcc()).with_name("cuobjdump")
        sass = subprocess.run([str(dump), "-sass", str(_build.library_path())],
                              capture_output=True, text=True,
                              timeout=600).stdout
        keep, out = False, []
        for line in sass.splitlines():
            if "Function :" in line:
                keep = "tile" in line
            if keep:
                out.append(line)
        Path(argv[1]).write_text("\n".join(out) + "\n")
        print(f"  {len(out)} lines of tile kernels' SASS -> {argv[1]}")
        return 0
    t0 = time.perf_counter()
    try:
        compiler_report()
    finally:
        print(f"  ptxas report {time.perf_counter() - t0:.1f} s")
        guided_occupancy()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
