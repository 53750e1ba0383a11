"""Numerical-safety instrumentation: ``checked(fn)`` runs ``fn`` and raises
at the first op inside it that makes a NaN or divides by zero, naming the
op and the line that called it (the JAX package's ``utils/debug.py``,
which runs ``fn`` under ``checkify.float_checks | checkify.div_checks``).

It raises where the JAX package's ``checked`` does:

- an op of the kinds that ``checkify``'s float checks watch (arithmetic,
  ``exp``/``log``/``sqrt``/``pow`` and the other transcendentals, sums and
  products, matmuls and convolutions, FFTs, pads, cumulative ops,
  remainders) whose output holds a NaN, whether it made the NaN or passed
  one on: ``log(-1)``, ``0 * inf``, ``inf - inf``, ``nan + 1``;
- a division, float or integer, whose divisor holds a zero: ``x / 0``,
  ``0 / 0``, ``x // 0``; ``1 / x`` is a division too (PyTorch computes it
  as ``reciprocal``).

It lets pass what those checks let pass: an infinity (``log(0)``,
``exp(1000)``, an overflow), a NaN that an op outside those kinds carries
(``maximum``, ``where``, ``clamp``, a copy, a cast), an integer remainder
by zero. The kernels of ``..kernels`` write their outputs outside
PyTorch's ops, as Pallas kernels do outside checkify's, and are not
checked.
"""

from __future__ import annotations

import functools
import traceback
from pathlib import Path
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["checked"]

# aten ops (in-place and out= forms included) whose outputs are checked for
# NaNs: the counterparts of checkify's nan_primitives
_NAN_OPS = frozenset("""
    add sub rsub mul div true_divide floor_divide addcmul addcdiv lerp
    log log2 log10 log1p exp exp2 expm1 sqrt rsqrt pow square
    reciprocal sin cos tan asin acos atan atan2 sinh cosh tanh asinh acosh
    atanh sigmoid erf erfc erfinv lgamma digamma i0 special_i0e special_i1e
    sum prod mean var std var_mean std_mean nansum logsumexp
    cumsum cumprod cummax cummin logcumsumexp
    mm bmm addmm addmv addbmm baddbmm mv dot vdot matmul linear einsum
    convolution _convolution cudnn_convolution _softmax _log_softmax
    remainder fmod constant_pad_nd avg_pool1d avg_pool2d avg_pool3d
    upsample_bilinear2d _upsample_bilinear2d_aa upsample_bicubic2d
    _upsample_bicubic2d_aa upsample_linear1d
    _fft_r2c _fft_c2r _fft_c2c
""".split())
# divisions: the op and the position of its divisor among the arguments
_DIV_OPS = {"div": 1, "true_divide": 1, "floor_divide": 1, "addcdiv": 2,
            "reciprocal": 0}


def _base(func) -> str:
    """The op's name without its in-place underscore: ``add_`` -> add."""
    name = func.overloadpacket.__name__
    return name[:-1] if name.endswith("_") and not name.endswith("__") \
        else name


def _caller() -> str:
    """file:line of the innermost frame outside torch and this module."""
    here = Path(__file__).resolve()
    torch_dir = Path(torch.__file__).resolve().parent
    for fr in reversed(traceback.extract_stack()):
        p = Path(fr.filename).resolve()
        if p != here and torch_dir not in p.parents:
            return f"{fr.filename}:{fr.lineno}"
    return "?"


def _has_nan(out: Any) -> bool:
    if isinstance(out, torch.Tensor):
        return (out.is_floating_point() or out.is_complex()) \
            and bool(torch.isnan(out).any())
    if isinstance(out, (tuple, list)):
        return any(_has_nan(o) for o in out)
    return False


def _has_zero(divisor: Any) -> bool:
    if isinstance(divisor, torch.Tensor):
        return bool((divisor == 0).any())
    return isinstance(divisor, (int, float, complex)) and divisor == 0


class _Checks(TorchDispatchMode):
    """Checks each aten op's divisor before it runs and its output
    after."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = _base(func)
        pos = _DIV_OPS.get(name)
        if pos is not None and len(args) > pos and _has_zero(args[pos]):
            raise ZeroDivisionError(
                f"division by zero in {func} at {_caller()}")
        out = func(*args, **kwargs)
        if name in _NAN_OPS and _has_nan(out):
            raise FloatingPointError(
                f"nan generated by op {func} at {_caller()}")
        return out


def checked(fn: Callable) -> Callable:
    """A wrapper that runs ``fn`` with every PyTorch op inside it checked
    and raises at the first NaN or division by zero that the JAX package's
    ``checked`` raises on: ``FloatingPointError`` or ``ZeroDivisionError``,
    naming the op and the calling line. Each checked op waits for its
    result, so this is for debugging, not for timing."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with _Checks():
            return fn(*args, **kwargs)

    return wrapper
