"""LOL eval harness with a parity check against the CPU reference: the
port of the JAX package's ``eval/runner.py``.

The dataset's pairs are read on a host thread through a ``PrefetchQueue``
while the pipeline enhances the previous batch; PSNR, SSIM and CIE76
delta-E are computed per batch. A batch that fails on the device is retried
once and then skipped with a log line, so that one bad input cannot end a
long eval; input and shape errors (``ValueError``, ``TypeError``) are
raised at once.

``parity=True`` runs the same config and weights on ``device="cpu"`` (the
plain versions of the kernels) on the same inputs and reports the largest
u8 difference and the PSNR difference against the ground truth (the 0.1
dB budget).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from low_light_image_enhancement_tpu_torch.data.lol import LOLDataset
from low_light_image_enhancement_tpu_torch.eval.metrics import (
    delta_e76_u8,
    psnr_u8,
    ssim_u8,
)
from low_light_image_enhancement_tpu_torch.io.prefetch import PrefetchQueue
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline
from low_light_image_enhancement_tpu_torch.utils.logging import get_logger

_LOG = get_logger("llie.eval")


def _enhance_with_retry(pipeline, lows, retries: int = 1):
    for attempt in range(retries + 1):
        try:
            return pipeline.enhance_batch(lows)
        except (ValueError, TypeError):
            # input and shape errors: a retry would fail the same way, and
            # skipping would hide them
            raise
        except Exception as e:  # a device or runtime fault: retry, then skip
            _LOG.warning("enhance batch failed (attempt %d/%d): %s",
                         attempt + 1, retries + 1, e)
    return None


def _metric(fn, out: np.ndarray, highs: np.ndarray):
    return fn(torch.from_numpy(out), torch.from_numpy(highs)).tolist()


def eval_lol(
    pipeline: Optional[EnhancePipeline] = None,
    dataset: Optional[LOLDataset] = None,
    max_images: Optional[int] = None,
    parity: bool = True,
    batch_size: int = 15,
    prefetch_depth: int = 2,
) -> Dict[str, float]:
    """Enhance the dataset's lows (the default pipeline on CUDA, the eval15
    split) and score them against the highs; returns the report (means over
    the images, counts, and the parity figures)."""
    pipeline = pipeline or EnhancePipeline()
    dataset = dataset or LOLDataset(split="eval15")
    n = len(dataset) if max_images is None else min(max_images, len(dataset))
    _LOG.warning(
        "evaluating %d images from %s", n,
        "the deterministic SYNTHETIC LOL stand-in (no real LOL data found; "
        "point --data-dir / LLIE_LOL_DIR at a real LOL layout)"
        if dataset.is_synthetic
        else f"real on-disk LOL data ({dataset.split})")

    def batches():
        for start in range(0, n, batch_size):
            pairs = [dataset[i] for i in range(start, min(start + batch_size,
                                                          n))]
            yield (np.stack([lo for lo, _, _ in pairs]),
                   np.stack([hi for _, hi, _ in pairs]))

    psnrs, ssims, delta_es, ref_psnrs = [], [], [], []
    parity_max, skipped = 0, 0
    ref_pipe = None
    if parity:
        ref_pipe = EnhancePipeline(pipeline.config,
                                   model_params=pipeline.model_params,
                                   device="cpu")

    for lows, highs in PrefetchQueue(batches(), depth=prefetch_depth,
                                     device_put=False):
        out = _enhance_with_retry(pipeline, lows)
        if out is None:
            skipped += len(lows)
            continue
        psnrs += _metric(psnr_u8, out, highs)
        ssims += _metric(ssim_u8, out, highs)
        delta_es += _metric(delta_e76_u8, out, highs)
        if ref_pipe is not None:
            ref = _enhance_with_retry(ref_pipe, lows)
            if ref is None:
                _LOG.warning("reference path failed; skipping parity batch")
            else:
                ref_psnrs += _metric(psnr_u8, ref, highs)
                parity_max = max(parity_max, int(np.abs(
                    out.astype(np.int32) - ref.astype(np.int32)).max()))

    if not psnrs:
        raise RuntimeError(f"eval produced no results: all {skipped} images "
                           "failed (see llie.eval warnings above)")
    psnrs_a = np.asarray(psnrs)
    report: Dict[str, float] = {
        "n_images": float(len(psnrs)),
        "n_skipped": float(skipped),
        "synthetic_data": float(dataset.is_synthetic),
        "psnr_mean": float(psnrs_a.mean()),
        "psnr_std": float(psnrs_a.std()),
        "ssim_mean": float(np.mean(ssims)),
        "delta_e76_mean": float(np.mean(delta_es)),
    }
    if parity and ref_psnrs:
        ref_mean = float(np.mean(ref_psnrs))
        report["ref_psnr_mean"] = ref_mean
        report["parity_psnr_delta_db"] = abs(report["psnr_mean"] - ref_mean)
        report["parity_max_abs_u8"] = float(parity_max)
        report["parity_within_0p1db"] = float(
            report["parity_psnr_delta_db"] <= 0.1)
    return report
