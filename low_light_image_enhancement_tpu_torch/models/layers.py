"""Shared primitives of the nets: NCHW (optionally dilated) SAME conv of
any odd kernel size, the NHWC layout of the kernel arms, the sigmoid as
the JAX package computes it, and ``ParamsNet``, the ``nn.Module`` form of
a functional params dict."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn


def as_dtype(compute_dtype) -> torch.dtype:
    """The config's ``"bfloat16"``/``"float32"``, or a torch dtype."""
    if isinstance(compute_dtype, torch.dtype):
        return compute_dtype
    return getattr(torch, str(compute_dtype))


def conv2d(x, w, b, compute_dtype, dilation: int = 1):
    """x (B, Cin, H, W), w (Cout, Cin, k, k) with k odd, b (Cout,). SAME
    padding, ``dilation * (k - 1) // 2`` on each side, so the output keeps
    the input's spatial shape (a 1x1 conv pads nothing). As in the JAX
    package, x, w and b are all cast to ``compute_dtype`` and the bias is
    added in that dtype.

    A float32 conv on CUDA goes through cuDNN, which uses TF32 unless
    ``torch.backends.cudnn.allow_tf32`` is False: turn it off for float32
    parity with the reference."""
    kh, kw = w.shape[-2:]
    if kh != kw or kh % 2 != 1:
        raise ValueError(f"conv2d takes square odd kernels, got {kh}x{kw}")
    cd = as_dtype(compute_dtype)
    y = F.conv2d(x.to(cd), w.to(cd), None, padding=dilation * (kh - 1) // 2,
                 dilation=dilation)
    return y + b.to(cd)[:, None, None]


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """NCHW (B, C, H, W) -> a contiguous NHWC (B, H, W, C) tensor; free
    when ``x`` is already channels_last, as a conv of a channels_last input
    returns."""
    return x.permute(0, 2, 3, 1).contiguous()


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` in x's dtype, each step rounded to it: the
    form JAX's ``logistic`` takes on the CPU. In bfloat16,
    ``torch.sigmoid`` rounds once instead, and a third of its outputs land
    one bf16 step away from the reference's."""
    return 1.0 / (1.0 + torch.exp(-x))


class ParamsNet(nn.Module):
    """An ``nn.Module`` over a functional params dict ``{"c1": {"w": ...,
    "b": ...}, ...}``: each layer a submodule of its name holding its
    tensors as parameters of theirs, so that ``named_parameters()`` gives
    ``c1.w``, ``c1.b``, ... and :attr:`params` gives the dict back (the
    same tensors) for the functional ``apply_*``."""

    def set_params(self, params: Dict[str, Dict[str, torch.Tensor]]) -> None:
        for name, layer in params.items():
            m = nn.Module()
            for k, t in layer.items():
                m.register_parameter(k, nn.Parameter(t))
            self.add_module(name, m)

    @property
    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {name: dict(m.named_parameters())
                for name, m in self.named_children()}
