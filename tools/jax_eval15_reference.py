#!/usr/bin/env python3
"""The JAX package's quality numbers for the `quality` and `quality_fast`
presets, the guided tail of retinex and hybrid (r 4), and the default
bilateral tail of retinex, curve, hybrid and decom on the synthetic eval-15
set, on the CPU.

These are the reference constants that ``chip_smoke.py`` (phase 4b) holds
the PyTorch/CUDA port's numbers to. They come from the JAX package's own
evaluation, ``eval_lol(EnhancePipeline(PRESETS[name], force_jnp=True),
max_images=15, parity=False)``, which reads ``synth_pair(i, 400, 600,
seed=0)`` for i < 15 when no LOL data is on disk.

Run from the repository root (it takes a few minutes and ~2 GB):

    JAX_PLATFORMS=cpu python tools/jax_eval15_reference.py [name ...]

It prints one JSON object: per configuration (all of ``CONFIGS``, or the
names given), the PSNR, SSIM and CIE76 delta-E means over the 15 pairs.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from low_light_image_enhancement_tpu.config import (  # noqa: E402
    PRESETS,
    PipelineConfig,
)
from low_light_image_enhancement_tpu.data.lol import LOLDataset  # noqa: E402
from low_light_image_enhancement_tpu.eval.runner import eval_lol  # noqa: E402
from low_light_image_enhancement_tpu.pipeline import (  # noqa: E402
    EnhancePipeline,
)


CONFIGS = {
    "quality": PRESETS["quality"],
    "quality_fast": PRESETS["quality_fast"],
    "retinex guided r4": PipelineConfig(denoise_taps="guided",
                                        guided_radius=4),
    "hybrid guided r4": PipelineConfig(method="hybrid", denoise_taps="guided",
                                       guided_radius=4),
    "retinex": PipelineConfig(),
    "curve": PipelineConfig(method="curve"),
    "hybrid": PipelineConfig(method="hybrid"),
    "decom": PipelineConfig(method="decom"),
}


def main() -> int:
    out = {}
    for name in sys.argv[1:] or CONFIGS:
        ds = LOLDataset(split="eval15")
        if not ds.is_synthetic:
            raise SystemExit("found LOL data on disk; these constants are "
                             "for the synthetic eval-15 set")
        rep = eval_lol(EnhancePipeline(CONFIGS[name], force_jnp=True),
                       dataset=ds, max_images=15, parity=False,
                       batch_size=5)
        out[name] = {k: rep[k] for k in ("n_images", "psnr_mean",
                                         "ssim_mean", "delta_e76_mean")}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
