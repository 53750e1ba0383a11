"""The port's utils: ``profile_trace`` and ``stage`` (``utils/
profiling.py``), ``checked`` (``utils/debug.py``) against the JAX
package's ``checked`` case by case, ``enable_compile_cache`` in the four
cases of ``tests/unit/test_compile_cache.py`` against the port's build
directory, and the per-source objects of ``kernels/_build.py``, reused by
their hash (checked on the hashes and on the command list; there is no
``nvcc`` here)."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.utils.debug import checked as jchecked
from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.utils import (
    enable_compile_cache,
    profile_trace,
    stage,
)
from low_light_image_enhancement_tpu_torch.utils.debug import checked


def test_profile_trace_writes_a_trace_naming_the_stage(tmp_path):
    d = tmp_path / "trace"
    with profile_trace(str(d)) as prof:
        with stage("tiny-op"):
            _ = float((torch.ones((64, 64)) * 2).sum())
    files = list(d.iterdir())
    assert len(files) == 1, files
    names = {e.get("name") for e in json.loads(files[0].read_text())
             ["traceEvents"]}
    assert "tiny-op" in names
    assert any(e.key == "tiny-op" for e in prof.key_averages())


def test_stage_is_transparent():
    with stage("noop"):
        x = torch.arange(4.0) + 1
    assert float(x.sum()) == 10.0

    @stage("decorated")
    def f(a, b=1):
        return a + b

    assert f(2, b=3) == 5 and f(1) == 2


# (torch function, jnp function, argument): checked must raise where the
# JAX package's checked raises (checkify's float and div checks) and pass
# where it passes
_CASES = {
    "log 1": (torch.log, jnp.log, [1.0]),
    "log -1": (torch.log, jnp.log, [-1.0]),
    "log 0": (torch.log, jnp.log, [0.0]),
    "0/0": (lambda x: x / x, lambda x: x / x, [0.0]),
    "1/0": (lambda x: 1.0 / x, lambda x: 1.0 / x, [0.0]),
    "int // 0": (lambda x: x // x, lambda x: x // x, np.array([0])),
    "inf - inf": (lambda x: x - x, lambda x: x - x, [np.inf]),
    "nan + 1": (lambda x: x + 1, lambda x: x + 1, [np.nan]),
    "maximum(nan, 0)": (lambda x: torch.maximum(x, torch.zeros(())),
                        lambda x: jnp.maximum(x, 0.0), [np.nan]),
    "exp 1000": (torch.exp, jnp.exp, [1000.0]),
    "where(x > 0, log x, 0) at -1": (
        lambda x: torch.where(x > 0, torch.log(x), 0.0),
        lambda x: jnp.where(x > 0, jnp.log(x), 0.0), [-1.0]),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_checked_raises_where_jax_does(case):
    tfn, jfn, arg = _CASES[case]
    arg = np.asarray(arg if isinstance(arg, np.ndarray)
                     else np.asarray(arg, np.float32))

    def raises(call):
        try:
            call()
        except (FloatingPointError, ZeroDivisionError) as e:
            return str(e)
        except Exception as e:  # JAX's own error type
            if "nan generated" in str(e) or "division by zero" in str(e):
                return str(e)
            raise
        return None

    want = raises(lambda: jchecked(jfn)(jnp.asarray(arg)))
    got = raises(lambda: checked(tfn)(torch.from_numpy(arg)))
    print(f"{case}: JAX {want!r}, port {got!r}")
    assert (got is None) == (want is None)
    if want is not None:
        assert ("division by zero" in got) == ("division by zero" in want)
        assert "test_torch_utils_port.py" in got   # the calling line


def test_checked_returns_the_result():
    x = torch.tensor([1.0, 4.0])
    assert torch.equal(checked(torch.sqrt)(x), torch.tensor([1.0, 2.0]))


@pytest.fixture
def build_dir(monkeypatch):
    """The build directory restored after the test."""
    monkeypatch.setattr(_build, "BUILD_DIR", _build.DEFAULT_BUILD_DIR)
    monkeypatch.delenv("LLIE_COMPILE_CACHE", raising=False)
    return monkeypatch


def test_enable_sets_the_build_dir(tmp_path, build_dir):
    target = tmp_path / "kernels"
    assert enable_compile_cache(target) == str(target)
    assert target.is_dir() and _build.BUILD_DIR == target
    assert enable_compile_cache() == str(_build.DEFAULT_BUILD_DIR)
    assert _build.DEFAULT_BUILD_DIR.parts[-2:] == ("build", "torch_kernels")


def test_env_var_overrides_default(tmp_path, build_dir):
    target = tmp_path / "env-cache"
    build_dir.setenv("LLIE_COMPILE_CACHE", str(target))
    assert enable_compile_cache() == str(target)
    assert target.is_dir() and _build.BUILD_DIR == target


def test_env_var_disables_reuse(build_dir):
    dirs = set()
    for off in ("0", "off", "none", ""):
        build_dir.setenv("LLIE_COMPILE_CACHE", off)
        assert enable_compile_cache() is None
        # a fresh temporary directory: nothing of an earlier build is there
        assert _build.BUILD_DIR != _build.DEFAULT_BUILD_DIR
        assert _build.BUILD_DIR.is_dir() and not os.listdir(_build.BUILD_DIR)
        dirs.add(_build.BUILD_DIR)
    assert len(dirs) == 4


def test_unwritable_path_logs_and_returns_none(tmp_path, build_dir, caplog):
    (tmp_path / "a-file").write_text("")
    assert enable_compile_cache(tmp_path / "a-file" / "cache") is None
    assert _build.BUILD_DIR == _build.DEFAULT_BUILD_DIR
    assert "disabled" in caplog.text


def test_objects_reused_by_their_hash(tmp_path, monkeypatch):
    """Each source compiles into an object named by the hash of its flags,
    compiler, text and included headers; a built object is not compiled
    again; a header's change renames the objects of the sources that
    include it (through another header too), and no other."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "inner.cuh").write_text("// inner\n")
    (csrc / "outer.cuh").write_text('#include "inner.cuh"\n')
    (csrc / "a.cu").write_text('#include "outer.cuh"\n#include <cuda.h>\n')
    (csrc / "b.cu").write_text("// b\n")
    monkeypatch.setattr(_build, "_CSRC", csrc)
    out = tmp_path / "build"
    assert [h.name for h in _build.included_headers(csrc / "a.cu")] == \
        ["inner.cuh", "outer.cuh"]

    pairs = _build.object_paths("nvcc 12.8", out)
    assert [s.name for s, _ in pairs] == ["a.cu", "b.cu"]
    todo = _build.compile_commands("nvcc", pairs, tmp_path)
    assert [o for o, _, _ in todo] == [o for _, o in pairs]
    assert todo[0][2] == ["nvcc", *_build.NVCC_FLAGS, "-c", "-o",
                          str(tmp_path / pairs[0][1].name),
                          str(csrc / "a.cu")]
    pairs[0][1].parent.mkdir(parents=True)
    pairs[0][1].write_bytes(b"built")
    assert [o for o, _, _ in _build.compile_commands(
        "nvcc", pairs, tmp_path)] == [pairs[1][1]]

    (csrc / "inner.cuh").write_text("// inner, changed\n")
    again = _build.object_paths("nvcc 12.8", out)
    assert again[0][1] != pairs[0][1] and again[1][1] == pairs[1][1]
    other = _build.object_paths("nvcc 12.9", out)
    assert all(o != p for (_, o), (_, p) in zip(other, again))

    monkeypatch.setattr(_build, "BUILD_DIR", out)
    monkeypatch.setattr(_build, "toolchain", lambda: "nvcc 12.8")
    lib = _build.library_path()
    assert lib.parent == out and lib.suffix == ".so"
    (csrc / "b.cu").write_text("// b, changed\n")
    assert _build.library_path() != lib


def test_the_sources_headers_are_found():
    """Every kernel source's own headers (the guided family's through
    fused_guided.cuh) key its object."""
    heads = {s.name: [h.name for h in _build.included_headers(s)]
             for s in _build._sources()}
    assert heads["fused_guided.cu"] == ["fused_enhance.cuh",
                                        "fused_guided.cuh", "guided.cuh",
                                        "retinex_tile.cuh"]
    assert heads["mxu_conv.cu"] == ["conv3x3.cuh", "conv3x3_wgmma.cuh"]
    assert all(heads.values())
