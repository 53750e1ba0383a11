"""RAW ingest: the port's ``ops/isp``, the ISP front end ``_isp_u8_hwc``,
``EnhancePipeline.enhance_raw``/``enhance_raw_batch`` (also under
``spatial_shards`` and ``data_shards``) and ``llie-torch enhance --raw``,
against the JAX package on the same seeded numpy mosaics.

Bars: the ISP ops within 1e-6 (gray_world_gains within 2e-6 relative:
its means are float32 sums of H*W values, which XLA adds in sequence and
torch pairwise); the ISP's u8 and the pipelines' u8 output max |du8| <= 1
on a share < 1e-3 (the main path's bar; the share is printed), bf16
hybrid PSNR >= 40 dB. The JAX references run under ``jax.jit``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.ops import isp as jisp
from low_light_image_enhancement_tpu_torch import cli
from low_light_image_enhancement_tpu_torch import pipeline as tpipe
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.core import illumination_boost
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.io import codec
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)
from low_light_image_enhancement_tpu_torch.ops import isp as tisp

GAMMA = 1.0 / 2.2


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_boost():
    """A process's first multi-threaded boost on the CPU can round apart
    from the next ones: one runs before the comparisons."""
    illumination_boost(torch.rand(1, 3, 16, 16), PipelineConfig())


def mosaic_from_rgb(rgb_u8: np.ndarray) -> np.ndarray:
    """(B, H, W, 3) u8 -> (B, H, W) f32 RGGB mosaics: each Bayer site keeps
    its own channel."""
    x = rgb_u8.astype(np.float32) / 255.0
    raw = np.empty(x.shape[:-1], np.float32)
    raw[:, 0::2, 0::2] = x[:, 0::2, 0::2, 0]
    raw[:, 0::2, 1::2] = x[:, 0::2, 1::2, 1]
    raw[:, 1::2, 0::2] = x[:, 1::2, 0::2, 1]
    raw[:, 1::2, 1::2] = x[:, 1::2, 1::2, 2]
    return raw


def mosaics(b=2, h=40, w=64, seed=0):
    return mosaic_from_rgb(synth_batch(b, h, w, seed=seed)[0])


def delta(got, want, what=""):
    d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    print(f"{what}: max |du8| {d.max()}, changed share {(d > 0).mean():.3g}")
    return d.max(), (d > 0).mean()


def _pair(kw, bucket=None):
    ref = jpipe.EnhancePipeline(JConfig(**kw), force_jnp=True, bucket=bucket)
    params = None if ref.model_params is None else \
        params_from_numpy(ref.model_params)
    port = tpipe.EnhancePipeline(PipelineConfig(**kw), model_params=params,
                                 device="cpu", bucket=bucket)
    return port, ref


def _jit(fn, *args):
    return np.asarray(jax.jit(fn)(*args))


# ------------------------------------------------------------ ops/isp -- #

def test_isp_ops_match_jax():
    raw = mosaics()
    t = torch.from_numpy(raw)
    np.testing.assert_array_equal(
        tisp.demosaic_bilinear_rggb(t).numpy(),
        _jit(jisp.demosaic_bilinear_rggb, raw))
    rgb = _jit(jisp.demosaic_bilinear_rggb, raw)
    tr = torch.from_numpy(rgb.copy())
    gains = (1.8, 1.0, 1.4)
    cases = [
        ("white_balance", tisp.white_balance(tr, gains),
         _jit(lambda x: jisp.white_balance(x, gains), rgb)),
        ("color_correction", tisp.color_correction(tr, tisp.DEFAULT_CCM),
         _jit(lambda x: jisp.color_correction(x, jisp.DEFAULT_CCM), rgb)),
        ("color_correction custom",
         tisp.color_correction(tr, ((0.9, 0.2, -0.1), (0.0, 1.1, 0.0),
                                    (-0.2, 0.1, 1.3))),
         _jit(lambda x: jisp.color_correction(
             x, ((0.9, 0.2, -0.1), (0.0, 1.1, 0.0), (-0.2, 0.1, 1.3))), rgb)),
        ("raw_to_srgb", tisp.raw_to_srgb(t),
         _jit(jisp.raw_to_srgb, raw)),
        ("raw_to_srgb gains", tisp.raw_to_srgb(t, wb_gains=gains, gamma=0.5),
         _jit(lambda r: jisp.raw_to_srgb(r, wb_gains=gains, gamma=0.5), raw)),
    ]
    for name, got, want in cases:
        err = float(np.abs(got.numpy() - want).max())
        print(f"{name}: max |d| {err:.3g}")
        assert got.shape == want.shape and err <= 1e-6, (name, err)
    got = tisp.gray_world_gains(tr).numpy()
    want = _jit(jisp.gray_world_gains, rgb)
    rel = float((np.abs(got - want) / np.maximum(np.abs(want), 1.0)).max())
    print(f"gray_world_gains: max rel |d| {rel:.3g}")
    assert got.shape == want.shape == (2, 3) and rel <= 2e-6, rel


@pytest.mark.parametrize("wb_gains,valid_hw", [
    (None, None), ((1.6, 1.0, 1.9), None), (None, (34, 50))])
def test_isp_u8_hwc_matches_jax(wb_gains, valid_hw):
    raw = mosaics(3, 40, 64, seed=2)
    if valid_hw is None:
        want = _jit(lambda r: jpipe._isp_u8_hwc(r, wb_gains,
                                                jisp.DEFAULT_CCM, GAMMA), raw)
    else:
        want = _jit(lambda r, v: jpipe._isp_u8_hwc(
            r, wb_gains, jisp.DEFAULT_CCM, GAMMA, v), raw,
            jnp.asarray(valid_hw, jnp.int32))
    got = tpipe._isp_u8_hwc(torch.from_numpy(raw), wb_gains,
                            tisp.DEFAULT_CCM, GAMMA, valid_hw).numpy()
    assert got.shape == want.shape == (3, 40, 64, 3) and got.dtype == np.uint8
    dmax, share = delta(got, want, f"_isp_u8_hwc {wb_gains} {valid_hw}")
    assert dmax <= 1 and share < 1e-3, (dmax, share)


def test_reflect_index_matches_numpy():
    for n in (2, 4, 6, 40):
        np.testing.assert_array_equal(
            tpipe._reflect_index(n, 2, "cpu").numpy(),
            np.pad(np.arange(n), 2, mode="reflect"))


# ---------------------------------------------------------- pipeline -- #

def _u16(raw, level=65535.0):
    return np.round(raw * level).astype(np.uint16)


def _raw_cases():
    f32 = mosaics(2, 40, 64, seed=4)
    wl = _u16(f32, 4095.0)
    wl[:, ::7, ::5] = 5000          # DNs above the 12-bit white level
    return {
        "uint16": (_u16(f32), {}),
        "uint16 white_level 4095": (wl, dict(white_level=4095)),
        "uint8": (np.round(f32 * 255).astype(np.uint8), {}),
        "float": (f32 * 1.1 - 0.02, {}),   # clipped to [0, 1]
        "wb_gains": (f32, dict(wb_gains=(1.7, 1.0, 1.3))),
        "ccm gamma": (f32, dict(ccm=np.eye(3) * 1.05, raw_gamma=0.6)),
    }


@pytest.mark.parametrize("case", list(_raw_cases()))
def test_enhance_raw_batch_matches_jax(case):
    raws, kw = _raw_cases()[case]
    port, ref = _pair({})
    got = port.enhance_raw_batch(raws, **kw)
    want = ref.enhance_raw_batch(raws, **kw)
    assert got.shape == raws.shape + (3,) and got.dtype == np.uint8
    dmax, share = delta(got, want, f"enhance_raw_batch {case}")
    assert dmax <= 1 and share < 1e-3, (dmax, share)


def test_enhance_raw_bucket_odd_multiple_and_single():
    """bucket=16 at 46x62 (the mosaic reflect-padded to 48x64, the
    gray-world means over the 46x62 region, the output cropped back), and
    enhance_raw on one mosaic."""
    raws = mosaics(2, 46, 62, seed=5)
    port, ref = _pair({}, bucket=16)
    got = port.enhance_raw_batch(raws)
    assert got.shape == (2, 46, 62, 3)
    dmax, share = delta(got, ref.enhance_raw_batch(raws), "bucket 16")
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    one = port.enhance_raw(raws[1])
    np.testing.assert_array_equal(one, got[1])
    dmax, share = delta(one, ref.enhance_raw(raws[1]), "enhance_raw")
    assert dmax <= 1 and share < 1e-3, (dmax, share)


def test_enhance_raw_learned_matches_jax():
    """curve with float32 nets to the u8 bar; the default bf16 hybrid to
    PSNR >= 40 dB."""
    raws = mosaics(2, 40, 64, seed=6)
    port, ref = _pair(dict(method="curve", compute_dtype="float32"))
    dmax, share = delta(port.enhance_raw_batch(raws),
                        ref.enhance_raw_batch(raws), "curve f32")
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    port, ref = _pair(dict(method="hybrid"))
    a = port.enhance_raw_batch(raws).astype(np.float64)
    b = ref.enhance_raw_batch(raws).astype(np.float64)
    mse = np.mean((a - b) ** 2)
    psnr = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    print(f"hybrid bf16: PSNR {psnr:.2f} dB")
    assert psnr >= 40.0, psnr


def test_enhance_raw_is_the_isp_then_enhance_batch_device():
    raws = mosaics(2, 40, 64, seed=7)
    pipe = tpipe.EnhancePipeline(PipelineConfig(), device="cpu")
    x = torch.from_numpy(raws)
    srgb = tpipe._isp_u8_hwc(x, None, tisp.DEFAULT_CCM, GAMMA)
    want = pipe.enhance_batch_device(srgb)
    assert torch.equal(pipe.enhance_raw_batch_device(x), want)
    np.testing.assert_array_equal(pipe.enhance_raw_batch(raws), want.numpy())


def test_enhance_raw_sharded():
    """spatial_shards=4 on a CPU mesh: Δ 0 against the port's single
    device, and the u8 bar against the JAX package's sharded route (its
    ISP program, then its sharded enhance_batch on 4 fake devices);
    data_shards=2 on a batch of 3 (padded to 4, cropped back): Δ 0."""
    raws = mosaics(2, 64, 96, seed=8)
    single = tpipe.EnhancePipeline(PipelineConfig(), device="cpu")
    want = single.enhance_raw_batch(raws)
    sharded = tpipe.EnhancePipeline(PipelineConfig(spatial_shards=4),
                                    device="cpu")
    got = sharded.enhance_raw_batch(raws)
    np.testing.assert_array_equal(got, want)
    ref = jpipe.EnhancePipeline(JConfig(spatial_shards=4), force_jnp=True)
    dmax, share = delta(got, ref.enhance_raw_batch(raws), "spatial_shards 4")
    assert dmax <= 1 and share < 1e-3, (dmax, share)
    raws3 = mosaics(3, 40, 64, seed=9)
    dp = tpipe.EnhancePipeline(PipelineConfig(data_shards=2), device="cpu")
    np.testing.assert_array_equal(dp.enhance_raw_batch(raws3),
                                  single.enhance_raw_batch(raws3))


@pytest.mark.parametrize("raws,kw,match", [
    (np.zeros((4, 6), np.float32), {}, "expected"),
    (np.zeros((1, 6, 7), np.float32), {}, "even"),
    (np.zeros((1, 5, 6), np.float32), {}, "even"),
    (np.zeros((1, 4, 6), np.uint8), dict(white_level=255), "white_level"),
    (np.zeros((1, 4, 6), np.int32), {}, "unsupported"),
    (np.zeros((1, 4, 6), np.int16), {}, "unsupported"),
])
def test_enhance_raw_batch_errors_as_jax(raws, kw, match):
    port, ref = _pair({})
    with pytest.raises(ValueError, match=match):
        ref.enhance_raw_batch(raws, **kw)
    with pytest.raises(ValueError, match=match):
        port.enhance_raw_batch(raws, **kw)


def test_enhance_raw_needs_a_2d_mosaic():
    port = tpipe.EnhancePipeline(PipelineConfig(), device="cpu")
    with pytest.raises(ValueError, match=r"\(H, W\)"):
        port.enhance_raw(np.zeros((1, 4, 6), np.float32))


# --------------------------------------------------------------- CLI -- #

def _cli_raw(tmp_path, arr, *extra):
    src, dst = tmp_path / "in.npy", tmp_path / "out.png"
    np.save(src, arr)
    rc = cli.main(["enhance", "--raw", str(src), str(dst), "--device", "cpu",
                   *extra])
    return rc, dst


@pytest.mark.parametrize("dtype", [np.uint16, np.int32])
def test_cli_enhance_raw_npy(tmp_path, capsys, dtype):
    """A u16 mosaic, and an int32 one in [0, 65535] (converted to u16),
    written as PNG equal to enhance_raw's output."""
    raw = _u16(mosaics(1, 40, 64, seed=10)[0])
    rc, dst = _cli_raw(tmp_path, raw.astype(dtype), "--wb-gains",
                       "1.5,1,1.2")
    assert rc == 0 and "wrote" in capsys.readouterr().out
    want = tpipe.EnhancePipeline(PipelineConfig(), device="cpu").enhance_raw(
        raw, wb_gains=(1.5, 1.0, 1.2))
    np.testing.assert_array_equal(codec.decode_image(dst), want)


def test_cli_enhance_raw_white_level(tmp_path):
    raw = _u16(mosaics(1, 40, 64, seed=11)[0], 4095.0)
    rc, dst = _cli_raw(tmp_path, raw, "--white-level", "4095")
    want = tpipe.EnhancePipeline(PipelineConfig(), device="cpu").enhance_raw(
        raw, white_level=4095)
    assert rc == 0
    np.testing.assert_array_equal(codec.decode_image(dst), want)


def test_cli_enhance_raw_rejects(tmp_path, monkeypatch, capsys):
    bad = np.full((4, 6), 70000, np.int32)
    with pytest.raises(ValueError, match="outside"):
        _cli_raw(tmp_path, bad)
    with pytest.raises(ValueError, match="outside"):
        _cli_raw(tmp_path, -np.ones((4, 6), np.int32))
    for gains in ("1,2", "a,b,c"):
        with pytest.raises(SystemExit) as exc:
            _cli_raw(tmp_path, np.zeros((4, 6), np.uint16), "--wb-gains",
                     gains)
        assert exc.value.code == 2
    assert "--wb-gains" in capsys.readouterr().err
    # where PIL is absent (the card host), a PNG mosaic names .npy
    monkeypatch.setattr(codec, "Image", None)
    with pytest.raises(ValueError, match=r"\.npy"):
        cli.main(["enhance", "--raw", str(tmp_path / "m.png"),
                  str(tmp_path / "o.png"), "--device", "cpu"])
