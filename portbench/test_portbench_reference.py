"""The plain references against the JAX package's pure path (jnp, no
Pallas) at small sizes on the CPU. This file alone imports JAX; the
references and everything a run loads do not."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from low_light_image_enhancement_tpu import config as jconfig  # noqa: E402
from low_light_image_enhancement_tpu.pipeline import (  # noqa: E402
    EnhancePipeline as JaxPipeline,
)

from portbench import check, inputs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def jax_out(pipeline: dict, x: np.ndarray, params=None) -> np.ndarray:
    cfg = jconfig.PipelineConfig(**pipeline)
    jparams = None if params is None else {
        k: {"w": v["w"].permute(2, 3, 1, 0).numpy(), "b": v["b"].numpy()}
        for k, v in params.items()}
    return np.asarray(JaxPipeline(cfg, model_params=jparams,
                                  force_jnp=True).enhance_batch(x))


@pytest.mark.parametrize("h,w", [(40, 56), (37, 61)])
def test_retinex_reference_is_the_jax_pure_path(h, w):
    c = config("retinex")
    gen = torch.Generator().manual_seed(3)
    x = inputs.low_light(gen, 2, h, w, "cpu")
    want = jax_out(c["pipeline"], x.numpy())
    got = check.reference_outputs(c, x, None).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3


@pytest.mark.parametrize("h,w", [(40, 56), (37, 61)])
def test_zero_dce_reference_is_the_jax_pure_path(h, w):
    """The net in float32 on both sides."""
    c = config("zero_dce")
    gen = torch.Generator().manual_seed(4)
    params = inputs.net_params(gen, c["net"], "cpu")
    x = inputs.low_light(gen, 2, h, w, "cpu")
    pipeline = dict(c["pipeline"], compute_dtype="float32")
    want = jax_out(pipeline, x.numpy(), params)
    got = check.reference_outputs(c, x, params).numpy()
    d = np.abs(got.astype(int) - want.astype(int))
    assert d.max() <= 1 and (d > 0).mean() < 1e-3
