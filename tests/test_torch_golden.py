"""The golden fixtures through the port (SURVEY.md §4, the North star's
second bar): the committed low/high PNG pairs of tests/data/, decoded
through both codec paths (PIL, and the zlib reader the card host uses),
enhanced by the port's default pipeline on the CPU, must reproduce the
stored PSNR/SSIM within 0.1 dB and 0.005, as
tests/integration/test_golden_fixtures.py holds the JAX package."""

import json
from pathlib import Path

import pytest
import torch

from low_light_image_enhancement_tpu_torch.eval.metrics import (
    psnr_u8,
    ssim_u8,
)
from low_light_image_enhancement_tpu_torch.io import codec
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline

DATA = Path(__file__).parent / "data"
EXPECTED = json.loads((DATA / "expected_metrics.json").read_text())


@pytest.mark.parametrize("path", ["pil", "zlib"])
def test_golden_pairs_within_budget(path, monkeypatch):
    if path == "zlib":
        monkeypatch.setattr(codec, "Image", None)
    pipe = EnhancePipeline(device="cpu")
    for name, exp in EXPECTED.items():
        low = codec.decode_image(DATA / f"{name}_low.png")
        high = torch.from_numpy(codec.decode_image(DATA / f"{name}_high.png"))
        out = torch.from_numpy(pipe.enhance(low))
        psnr = float(psnr_u8(out, high))
        ssim = float(ssim_u8(out[None], high[None])[0])
        assert abs(psnr - exp["psnr_db"]) <= 0.1, (name, psnr, exp)
        assert abs(ssim - exp["ssim"]) <= 0.005, (name, ssim, exp)


def test_enhance_file_through_the_zlib_codec(monkeypatch, tmp_path):
    monkeypatch.setattr(codec, "Image", None)
    pipe = EnhancePipeline(device="cpu")
    out = tmp_path / "bright.png"
    pipe.enhance_file(DATA / "pair0_low.png", out)
    low = codec.decode_image(DATA / "pair0_low.png")
    assert (codec.decode_image(out) == pipe.enhance(low)).all()
