"""K5's plain version against the JAX package's tiled_denoise Pallas kernel
in interpret mode, on the same f32 block, and the wrapper's contract.

Bar: max |delta| <= 1e-6 on f32 values in [0, 1] (8 ulp of 1.0), not
bit equality. Both sides run the same cores tap for tap, but the Pallas
kernel in interpret mode is compiled by XLA, which fuses the tap sums and
rounds some of them differently from the eager ops (run eagerly in JAX,
the same cores equal the plain version bit for bit:
tests/test_torch_guided.py), and XLA's exp is not PyTorch's. Found over 3
seeds of every case here: max |delta| 4.2e-7, at most 56 ulp on small
values, no u8 step over 1.
The CUDA kernel itself is held to this plain version on the card by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.kernels.striping import plan_stripes
from low_light_image_enhancement_tpu.kernels.tiled_denoise import (
    tiled_denoise as jax_tiled_denoise,
)
from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.kernels import tiled_denoise as td

HB, WB = 40, 128  # a tiny block: one tile column of 128, one stripe


def _block(seed):
    return np.random.default_rng(seed).random((1, 3, HB, WB),
                                              dtype=np.float32)


def _jax_k5(y, kw, halo, rows):
    """The JAX package's K5 route (blocks.enhance_learned_block): slice the
    window, edge-pad it to the stripe plan, run the kernel, keep rows."""
    cfg = JConfig(**kw)
    m = canvas_margin(PipelineConfig(**kw))
    plan = plan_stripes(rows, WB - 2 * m, m, cfg.stripe_rows,
                        bytes_per_px=200)
    sub = y[..., halo - m:halo + rows + m, :]
    extra = plan.padded_h - (rows + 2 * m)
    if extra:
        sub = np.pad(sub, ((0, 0), (0, 0), (0, extra), (0, 0)), mode="edge")
    out = jax_tiled_denoise(
        jnp.asarray(sub), cfg.denoise_sigma, cfg.denoise_strength, plan,
        interpret=True, kind=cfg.denoise_kernel, guide=cfg.denoise_guide,
        taps=cfg.denoise_taps, guided_radius=cfg.guided_radius,
        guided_eps=cfg.guided_eps, windowed=cfg.stripe_windowed)
    return np.asarray(out)[..., :rows, :]


@pytest.mark.parametrize("kw", [
    dict(method="fcn"),  # luma / sep / exp, the fcn default
    dict(method="fcn", denoise_guide="perchannel", denoise_taps="full",
         denoise_kernel="epan"),
    dict(method="decom", denoise_taps="guided", guided_radius=1),
    dict(method="decom", denoise_taps="guided", guided_radius=2),
    dict(method="decom", denoise_taps="guided", guided_radius=4),
    dict(method="decom", denoise_taps="guided", guided_radius=2,
         denoise_guide="perchannel"),
], ids=["luma-sep-exp", "perchannel-full-epan", "luma-guided-r1",
        "luma-guided-r2", "luma-guided-r4", "perchannel-guided-r2"])
def test_k5_plain_equals_jax_kernel(kw):
    cfg = PipelineConfig(**kw)
    m = canvas_margin(cfg)
    halo, rows = m, HB - 2 * m
    y = _block(seed=len(str(kw)))
    got = td.tiled_denoise(torch.from_numpy(y), cfg, halo, rows)
    assert got.shape == (1, 3, rows, WB) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_k5(y, kw, halo, rows),
                               rtol=0, atol=1e-6)


def test_k5_reads_the_window_in_place():
    """The window is found from halo and rows: a block with more halo rows
    gives the same output as the tight block it contains."""
    cfg = PipelineConfig(method="decom", denoise_taps="guided")
    m = canvas_margin(cfg)
    y = torch.from_numpy(_block(seed=7))
    tight = td.tiled_denoise(y, cfg, m, HB - 2 * m)
    loose = td.tiled_denoise(torch.nn.functional.pad(y, (0, 0, 5, 3)), cfg,
                             m + 5, HB - 2 * m)
    torch.testing.assert_close(loose, tight, rtol=0, atol=0)


def test_k5_cpu_calls_launch_nothing_and_bad_inputs_raise():
    before = td.tiled_denoise.launches
    cfg = PipelineConfig(method="fcn")
    y = torch.from_numpy(_block(seed=8))
    td.tiled_denoise(y, cfg, 4, 32)
    assert td.tiled_denoise.launches == before
    with pytest.raises(ValueError):
        td.tiled_denoise(y.to(torch.float64), cfg, 4, 32)
    with pytest.raises(ValueError):
        td.tiled_denoise(y[:, :2], cfg, 4, 32)
    with pytest.raises(ValueError):
        td.tiled_denoise(y, cfg, 2, 32)   # halo below the margin
    with pytest.raises(ValueError):
        td.tiled_denoise(y, cfg, 4, 33)   # rows + margin beyond the block
    with pytest.raises(ValueError):
        td.tiled_denoise(y, cfg.replace(denoise_strength=0.0), 4, 32)
