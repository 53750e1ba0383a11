"""The frozen counts: the DCE-Net's FLOPs at 600x400 and retinex's
FLOPs and bytes a pixel, as the benchmark's metrics read them."""

import json
from pathlib import Path

import pytest

from portbench import counts

ROOT = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def test_dce_net_flops_at_600x400():
    layers = config("zero_dce")["net"]["layers"]
    assert sum(ci * co for _, ci, co in layers) == 8800
    f = counts.net_flops_per_image(layers, 400, 600)
    assert f == 2 * 9 * 400 * 600 * 8800
    assert f / 1e9 == pytest.approx(38.0, abs=0.05)


def test_retinex_counts():
    p = config("retinex")["pipeline"]
    assert counts.retinex_flops_per_px(p) == 171
    assert counts.IO_BYTES_PER_PX == 6
    least = counts.retinex_least_s(p, 48, 400, 600)
    # CUDA-core bound: 171 FLOPs a pixel against 67 TFLOP/s
    assert least == pytest.approx(48 * 400 * 600 * 171 / 67e12)
    assert least * 1e3 == pytest.approx(0.0294, abs=5e-5)
    bytes_s = 48 * 400 * 600 * 6 / counts.PEAK_HBM_BYTES_PER_S
    assert bytes_s < least


def test_peaks():
    assert counts.PEAK_BF16_TENSOR_FLOPS == 989e12
    assert counts.PEAK_F32_CUDA_CORE_FLOPS == 67e12
    assert counts.PEAK_HBM_BYTES_PER_S == 3.35e12
