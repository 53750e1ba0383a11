"""The comparison that decides ``correct``: the program's outputs from the
window, against the plain reference run on the same inputs and weights in
float32 with TF32 off, after the window.

Two numbers over every compared u8 value: ``max_du8``, the largest
absolute difference, and ``mean_du8``, the mean absolute difference. Those
the configuration gives a limit are held to it."""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, Tuple

import torch

from portbench import spec

PIXELS_A_BLOCK = 12_000_000   # the reference runs on blocks of images


@contextlib.contextmanager
def no_tf32():
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


@torch.no_grad()
def reference_outputs(config: dict, x: torch.Tensor, params,
                      control: bool = False) -> torch.Tensor:
    """The reference (or its control) on (B, H, W, 3) u8 ``x``, in blocks
    of images."""
    ref = spec.reference(config["reference"])
    step = max(1, PIXELS_A_BLOCK // (x.shape[1] * x.shape[2]))
    with no_tf32():
        return torch.cat([ref.enhance(x[i:i + step], config["pipeline"],
                                      params, control=control)
                          for i in range(0, x.shape[0], step)])


class Tally:
    """Running ``max_du8`` and ``mean_du8``."""

    def __init__(self):
        self.max, self.sum, self.n = 0, 0, 0

    def add(self, got: torch.Tensor, want: torch.Tensor) -> None:
        d = (got.to(want.device, torch.int16) - want.to(torch.int16)).abs()
        self.max = max(self.max, int(d.max()))
        self.sum += int(d.sum(dtype=torch.int64))
        self.n += d.numel()

    def numbers(self) -> Dict[str, float]:
        return {"max_du8": self.max,
                "mean_du8": self.sum / self.n if self.n else float("nan")}


def tally(pairs: Iterable[Tuple[torch.Tensor, torch.Tensor]]) -> Dict:
    t = Tally()
    for got, want in pairs:
        t.add(got, want)
    return t.numbers()


def compare(record, config: dict, params) -> Dict[str, float]:
    """The numbers for the record's sampled outputs: the reference runs
    once on each input that a sample came from."""
    keys = sorted({k for k, _ in record.samples}, key=repr)
    refs = {}
    for k in keys:
        x, (h, w) = record.inputs[k]
        refs[k] = reference_outputs(config, x, params)[:, :h, :w]

    def pairs():
        for k, out in record.samples:
            want = refs[k]
            got = torch.as_tensor(out).reshape(want.shape)
            yield got, want

    return tally(pairs())


def passes(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit (a NaN, nothing compared, fails)."""
    return all(numbers[k] <= limits[k] for k in limits)
