"""Build and load the CUDA kernel library.

``nvcc`` compiles each ``csrc/*.cu`` of this package for ``sm_90a`` into an
object, one process per source, all started together, and links the
objects into one shared library with a plain C interface, which is loaded
with ``ctypes``. Each object is named by the hash of its source, of the
headers it includes (transitively), of ``NVCC_FLAGS`` and of the compiler's
version (:func:`source_key`), and is reused while that hash stands: a
change to one source recompiles that source alone, a change to a header
the sources that include it. The library is named by the hash of its
objects. Both land in the build directory, ``<repo>/build/torch_kernels/``
by default (resolved from this file, not from the working directory), or
where ``utils.compile_cache.enable_compile_cache`` points it
(``LLIE_COMPILE_CACHE``). Objects and the library are written under
temporary names and renamed, so that a concurrent process sees either none
or a whole one. Nothing is built or loaded when the module is imported.

``--fmad=false`` keeps every ``a*b+c`` a multiply and an add, as PyTorch's
eager ops compute them, so the kernels agree with their plain versions; no
``--use_fast_math``, so division, ``expf`` and ``logf`` keep full precision.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

_CSRC = Path(__file__).resolve().parent / "csrc"
DEFAULT_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "torch_kernels"
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)
_INCLUDE = re.compile(r'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

# the last build of this process: seconds, objects compiled and reused
LAST_BUILD: Dict[str, float] = {}

_lock = threading.Lock()
_lib = None

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FP = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "llie_fused_retinex": [
        _P, _P, _I, _P,              # in, out, f32, illumination plane
        _I, _I, _I, _I,              # B, H, W, stages
        _I, _FP, _F, _F,             # radius, taps, gamma - 1, eps
        _F, _F, _F, _I, _I, _I,      # strength, inv2s2, inv2s2/3,
        _P,                          # kind, joint, sep; stream
    ],
    "llie_fused_curve": [
        _P, _P, _P, _P, _P, _I,      # in, maps, gain, plane, out, f32
        _I, _I, _I,                  # B, HB, WB
        _I, _I, _I, _I, _I, _I,      # halo, rows, n_iter, boost, margin, img_w
        _I, _FP,                     # ds, the 8 upsample phase weights
        _I, _FP, _F, _F,             # radius, taps, gamma - 1, eps
        _F, _F, _F, _I, _I, _I,      # strength, inv2s2, inv2s2/3,
        _P,                          # kind, joint, sep; stream
    ],
    "llie_fused_retinex_gain": [
        _P, _P, _P, _I, _I, _I, _I,  # in, gain, out, f32, B, HB, WB
        _I, _I,                      # halo, rows
        _F, _F, _F, _I, _I, _I,      # strength, inv2s2, inv2s2/3,
        _P,                          # kind, joint, sep; stream
    ],
    "llie_fused_retinex_canvas": [
        _P, _P, _P, _I,              # in, illumination plane, out, f32
        _I, _I, _I, _I, _I,          # B, HB, WB, halo, rows
        _I, _FP, _F, _F,             # radius, taps, gamma - 1, eps
        _F, _F, _F, _I, _I, _I,      # strength, inv2s2, inv2s2/3,
        _P,                          # kind, joint, sep; stream
    ],
    "llie_fused_retinex_ema": [
        _P, _P, _P, _P, _P, _I,      # in, carry, plane, out, new carry, f32
        _I, _I, _I,                  # B, HB, WB
        _I, _I, _I, _I,              # halo, rows, margin, img_w
        _F, _F, _F,                  # alpha, 1 - alpha, gamma
        _I, _FP, _F,                 # radius, taps, eps
        _F, _F, _F, _I, _I, _I,      # strength, inv2s2, inv2s2/3,
        _P,                          # kind, joint, sep; stream
    ],
    "llie_blur_illumination": [
        _P, _I, _I, _P,              # in, f32, hwc, plane
        _I, _I, _I, _I, _I, _P,      # B, H, W, e, radius, device taps
        _P,                          # stream
    ],
    "llie_blur_plan": [_I, _I, _I],  # radius, form, what
    "llie_tiled_denoise_bilateral_plan": [_I],   # what
    "llie_fused_guided": [_P, _P],   # FusedGuidedArgs*, stream
    "llie_fused_guided_args_size": [],
    "llie_fused_guided_plan": [_I, _I, _I, _I],  # family, radius, joint,
                                                 # what
    "llie_tiled_denoise_guided_plan": [_I, _I, _I],
    "llie_tiled_denoise_f32": [
        _P, _P, _I, _I, _I,          # in, out, B, HB, WB
        _I, _I, _I,                  # halo, rows, margin
        _F, _F, _F, _I, _I, _I,      # strength, inv2s2, inv2s2/3,
                                     # kind, joint, sep
        _I, _I, _F, _F,              # guided, radius, 1/(2r+1), eps
        _P,                          # stream
    ],
    "llie_conv3x3": [
        _P, _I, _P, _I,              # xa, ca, xb (or NULL), cb
        _P, _P, _P, _I, _I,          # packed w, bias, out, cout, chunk
        _I, _I, _I, _I, _I, _I,      # B, H, W, dilation, act, bf16
        _P,                          # stream
    ],
    "llie_conv_plan": [_I, _I, _I, _I],  # ca, cb, cout, dilation
    "llie_retinex_tile_plan": [_I, _I, _I],  # family, radius, what
    "llie_fcn_cascade": [
        _P, _P, _P, _P, _P,          # x, scratch, out, packed w, biases
        ctypes.POINTER(_I), _I, _I,  # dilations, layers, channels
        _I, _I, _I, _I,              # B, H, W, bf16
        _P,                          # stream
    ],
}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``nvcc`` on PATH, then
    ``/usr/local/cuda/bin/nvcc``; raises when none exists."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(Path(on_path))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "CUDA kernels of low_light_image_enhancement_tpu_torch cannot be "
        "built"
    )


def set_build_dir(path) -> None:
    """Build and look for the library in ``path`` from now on (a library
    this process has loaded already stays loaded)."""
    global BUILD_DIR
    BUILD_DIR = Path(path)


def _sources() -> List[Path]:
    return sorted(_CSRC.glob("*.cu"))


def included_headers(src: Path) -> List[Path]:
    """The headers of ``csrc`` that ``src`` includes with ``#include
    "..."``, directly or through other headers, sorted by name."""
    seen: Dict[str, Path] = {}
    todo = [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            path = src.parent / name
            if name not in seen and path.is_file():
                seen[name] = path
                todo.append(path)
    return [seen[n] for n in sorted(seen)]


@functools.lru_cache(maxsize=1)
def toolchain() -> str:
    """``nvcc --version`` of the compiler :func:`find_nvcc` finds: objects
    of another compiler are not reused."""
    return subprocess.run([find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout


def source_key(src: Path, compiler: str) -> str:
    """The hash that names ``src``'s object: the flags, the compiler's
    version, the source and every header it includes."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(compiler.encode())
    for p in [src] + included_headers(src):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def object_paths(compiler: str, build_dir: Path) -> List[Tuple[Path, Path]]:
    """(source, object) for every source, the object named by
    :func:`source_key`."""
    return [(src, build_dir / "obj"
             / f"{src.stem}_{source_key(src, compiler)}.o")
            for src in _sources()]


def compile_commands(nvcc: str, pairs: Sequence[Tuple[Path, Path]],
                     tmp: Path) -> List[Tuple[Path, Path, List[str]]]:
    """(object, temporary object, nvcc command) for each object of
    ``pairs`` that is not built yet."""
    return [(obj, tmp / obj.name,
             [nvcc, *NVCC_FLAGS, "-c", "-o", str(tmp / obj.name), str(src)])
            for src, obj in pairs if not obj.exists()]


def library_path() -> Path:
    """Where the library of the current sources, flags and compiler lives:
    named by the hash of its objects' names."""
    objs = [obj.name for _, obj in object_paths(toolchain(), BUILD_DIR)]
    h = hashlib.sha256(" ".join(objs).encode())
    return BUILD_DIR / f"llie_kernels_{h.hexdigest()[:16]}.so"


def _run_all(cmds) -> None:
    """Run the commands at once; raise with the first failure's output."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def _compile(target: Path) -> None:
    """Compile the objects not built yet, then link the library."""
    nvcc = find_nvcc()
    pairs = object_paths(toolchain(), BUILD_DIR)
    (BUILD_DIR / "obj").mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        todo = compile_commands(nvcc, pairs, Path(tmp))
        _run_all([cmd for _, _, cmd in todo])
        for obj, built, _ in todo:
            os.replace(built, obj)
        lib = str(Path(tmp) / target.name)
        _run_all([[nvcc, *NVCC_FLAGS[:2], "-shared", "-o", lib,
                   *(str(obj) for _, obj in pairs)]])
        os.replace(lib, target)
    LAST_BUILD.update(seconds=time.perf_counter() - t0, built=len(todo),
                      reused=len(pairs) - len(todo))


def load_library() -> ctypes.CDLL:
    """The kernel library, built first if it is not there yet."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if path.exists():
                LAST_BUILD.update(seconds=0.0, built=0,
                                  reused=len(_sources()))
            else:
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.llie_error_string.argtypes = [ctypes.c_int]
            lib.llie_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
