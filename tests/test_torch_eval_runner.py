"""The port's eval_lol against the JAX package's on the same synthetic
LOLDataset: the same report keys, PSNR within 0.1 dB (the budget of the
North star), parity against the port's CPU reference, and the retry
path (a batch that fails twice is skipped)."""

import numpy as np
import pytest

from low_light_image_enhancement_tpu.data.lol import LOLDataset as JLOL
from low_light_image_enhancement_tpu.eval.runner import eval_lol as jeval
from low_light_image_enhancement_tpu.pipeline import EnhancePipeline as JPipe
from low_light_image_enhancement_tpu_torch.data.lol import LOLDataset
from low_light_image_enhancement_tpu_torch.eval.runner import eval_lol
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline


def test_dataset_matches_jax_and_falls_back_to_synthetic(tmp_path):
    ds = LOLDataset(root=str(tmp_path), size=(24, 40))
    ref = JLOL(root=str(tmp_path), size=(24, 40))
    assert ds.is_synthetic and len(ds) == len(ref) == 15
    for i in (0, 14):
        lo, hi, name = ds[i]
        jlo, jhi, jname = ref[i]
        np.testing.assert_array_equal(lo, jlo)
        np.testing.assert_array_equal(hi, jhi)
        assert name == jname
    with pytest.raises(ValueError, match="split"):
        LOLDataset(split="test")


def test_eval_lol_matches_jax():
    kw = dict(root="/nonexistent", split="eval15", size=(48, 64))
    got = eval_lol(EnhancePipeline(device="cpu"), LOLDataset(**kw),
                   max_images=3, batch_size=3)
    want = jeval(JPipe(force_jnp=True), JLOL(**kw), max_images=3,
                 batch_size=3, parity=False)
    parity_keys = {"ref_psnr_mean", "parity_psnr_delta_db",
                   "parity_max_abs_u8", "parity_within_0p1db"}
    assert set(got) == set(want) | parity_keys
    assert got["n_images"] == 3.0 and got["n_skipped"] == 0.0
    assert got["synthetic_data"] == 1.0
    assert got["parity_max_abs_u8"] == 0.0 and \
        got["parity_within_0p1db"] == 1.0
    assert abs(got["psnr_mean"] - want["psnr_mean"]) <= 0.1, (got, want)
    assert abs(got["ssim_mean"] - want["ssim_mean"]) <= 0.005, (got, want)


def test_eval_retry_skips_bad_batches(monkeypatch):
    ds = LOLDataset(root="/nonexistent", split="eval15", size=(32, 48))
    pipe = EnhancePipeline(device="cpu")
    real = pipe.enhance_batch
    calls = {"n": 0}

    def flaky(lows):
        calls["n"] += 1
        if calls["n"] <= 2:  # the first batch fails twice: skipped
            raise RuntimeError("injected device fault")
        return real(lows)

    monkeypatch.setattr(pipe, "enhance_batch", flaky)
    rep = eval_lol(pipe, dataset=ds, max_images=4, batch_size=2,
                   parity=False)
    assert rep["n_skipped"] == 2.0 and rep["n_images"] == 2.0
    assert "parity_max_abs_u8" not in rep

    def broken(lows):
        raise ValueError("bad shape")

    monkeypatch.setattr(pipe, "enhance_batch", broken)
    with pytest.raises(ValueError, match="bad shape"):
        eval_lol(pipe, dataset=ds, max_images=2, parity=False)
