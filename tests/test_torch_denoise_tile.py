"""K5's bilateral arm on the tile engine (``csrc/tiled_denoise.cu``
``denoise_bilateral_kernel``) on the CPU: a model of its window-to-engine
mapping and the mirror of its shared memory.

The kernel runs the engine's 32 x 64 tile with no blur: output row r is
block row halo + r, so the tile at (y0, x0) stages its ring row i from
block row halo + y0 - 1 + i, clamped into K5's window [halo - m, halo +
rows + m), and ring column j from block column x0 - 1 + j, clamped into
[0, WB); the engine's tail (its pair weights are held bit for bit to the
cores in tests/test_torch_retinex_tile.py) then blends the ring's centre,
and the result is clipped. ``model_k5`` repeats that: each tile's ring
gathered with those clamps, the configured tail on it, its centre kept.
It is held bit for bit (``torch.equal``) to ``tiled_denoise_plain`` on
the rows and columns a caller keeps, at shapes that end mid-tile (block
widths off a multiple of 4), in each tail form; the plain version is held
there to the JAX package's tiled_denoise in interpret mode within 1e-6 (as
tests/test_torch_tiled_denoise.py explains: XLA fuses and rounds some tap
sums otherwise). ``chip_smoke.py`` holds the kernel to the plain version
bit for bit on the card, and its shared memory to ``K5_SMEM_BYTES`` (so
this module imports no JAX at module level, for the card's host).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu_torch.config import (
    PipelineConfig,
    canvas_margin,
)
from low_light_image_enhancement_tpu_torch.core import denoise_tail
from low_light_image_enhancement_tpu_torch.kernels import tiled_denoise as td
from test_torch_retinex_tile import SMEM_PER_SM, TH, TW, YH, pitch

# The kernel's shared memory: the three ring planes (YH rows and a spare
# one) and pass 1's three planes of TH rows, at the engine's pitch with no
# blur; three blocks an SM.
K5_SMEM_BYTES = 4 * (3 * (YH + 1) * pitch(0) + 3 * TH * pitch(0))


def test_k5_bilateral_fits_three_blocks_an_sm():
    assert K5_SMEM_BYTES == 58692
    assert 3 * (K5_SMEM_BYTES + 1024) <= SMEM_PER_SM


def model_k5(y: torch.Tensor, cfg: PipelineConfig, halo: int,
             rows: int) -> torch.Tensor:
    """(B, 3, HB, WB) -> (B, 3, rows, WB) as the kernel's tiles compute it:
    each tile's ring read with the window's row clamp and the block's
    column clamp, the tail on the ring, the ring's centre clipped."""
    b, _, hb, wb = y.shape
    m = canvas_margin(cfg)
    lo, hi = halo - m, halo + rows + m - 1
    nty, ntx = -(-rows // TH), -(-wb // TW)
    out = torch.empty((b, 3, nty * TH, ntx * TW))
    for ty in range(nty):
        ring_rows = torch.clamp(halo + ty * TH - 1 + torch.arange(TH + 2),
                                lo, hi)
        for tx in range(ntx):
            ring_cols = torch.clamp(tx * TW - 1 + torch.arange(TW + 2), 0,
                                    wb - 1)
            ring = y[:, :, ring_rows][..., ring_cols]
            out[:, :, ty * TH:(ty + 1) * TH, tx * TW:(tx + 1) * TW] = \
                denoise_tail(ring, cfg)[..., 1:TH + 1, 1:TW + 1]
    return torch.clamp(out, 0.0, 1.0)[..., :rows, :wb]


def _jax_k5(y, kw, halo, rows):
    """The JAX package's K5 route (blocks.enhance_learned_block): slice the
    window, edge-pad it to the stripe plan, run the kernel, keep rows. Its
    blocks are whole lanes wide: columns edge-padded to a multiple of 128
    (past every column a caller keeps reads)."""
    import jax.numpy as jnp

    from low_light_image_enhancement_tpu.config import (
        PipelineConfig as JConfig,
    )
    from low_light_image_enhancement_tpu.kernels.striping import (
        plan_stripes,
    )
    from low_light_image_enhancement_tpu.kernels.tiled_denoise import (
        tiled_denoise as jax_tiled_denoise,
    )

    cfg = JConfig(**kw)
    y = np.pad(y, ((0, 0), (0, 0), (0, 0), (0, -y.shape[-1] % 128)),
               mode="edge")
    wb = y.shape[-1]
    m = canvas_margin(PipelineConfig(**kw))
    plan = plan_stripes(rows, wb - 2 * m, m, cfg.stripe_rows,
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
    dict(),                                   # luma / sep / exp, fcn's
    dict(denoise_guide="perchannel", denoise_taps="full",
         denoise_kernel="epan"),
    dict(denoise_taps="full"),
    dict(denoise_guide="perchannel", denoise_kernel="epan",
         denoise_strength=0.5),
], ids=["luma-sep-exp", "perchannel-full-epan", "luma-full-exp",
        "perchannel-sep-epan"])
def test_k5_tile_walk_equals_the_plain_version(kw):
    kw = dict(method="fcn", **kw)
    cfg = PipelineConfig(**kw)
    m = canvas_margin(cfg)
    halo, rows, w = m + 1, 45, 70             # 2 tile rows, 2 tile columns
    hb, wb = halo + rows + m + 2, 2 * m + w   # wb off a multiple of 4
    y = np.random.default_rng(len(str(kw))).random((2, 3, hb, wb),
                                                   dtype=np.float32)
    y[:, :, 10:14, :] = y[:, :, 10:11, :]     # runs of equal neighbours
    y[:, :, :, 30:34] = y[:, :, :, 30:31]
    yt = torch.from_numpy(y)
    got = model_k5(yt, cfg, halo, rows)
    want = td.tiled_denoise_plain(yt, cfg, halo, rows)
    assert got.shape == want.shape == (2, 3, rows, wb)
    assert torch.equal(got[..., m:m + w], want[..., m:m + w])
    np.testing.assert_allclose(want[..., m:m + w].numpy(),
                               _jax_k5(y, kw, halo, rows)[..., m:m + w],
                               rtol=0, atol=1e-6)
