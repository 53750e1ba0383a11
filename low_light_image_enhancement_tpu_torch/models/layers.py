"""Shared conv primitive: NCHW 3x3 (optionally dilated) SAME conv."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def as_dtype(compute_dtype) -> torch.dtype:
    """The config's ``"bfloat16"``/``"float32"``, or a torch dtype."""
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


def conv2d(x, w, b, compute_dtype, dilation: int = 1):
    """x (B, Cin, H, W), w (Cout, Cin, 3, 3), b (Cout,). As in the JAX
    package, x, w and b are all cast to ``compute_dtype`` and the bias is
    added in that dtype.

    A float32 conv on CUDA goes through cuDNN, which uses TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False: turn it off for float32
    parity with the reference."""
    cd = as_dtype(compute_dtype)
    y = F.conv2d(x.to(cd), w.to(cd), None, padding=dilation,
                 dilation=dilation)
    return y + b.to(cd)[:, None, None]
