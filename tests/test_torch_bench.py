"""The port's bench (low_light_image_enhancement_tpu_torch/bench.py) on the
CPU: its input against the JAX bench's (the root bench.py's synth_batch
tiled to the batch), two chained steps against two chained JAX
enhance_batch_device steps, the Python chain's result keys, the device
chain's refusal on the CPU, the marginal-rate arithmetic and main's
headline line, and the canvas chain's step. The CUDA-graph chain itself
runs only on the card (chip_smoke.py phase 11)."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.data.synth import (
    synth_batch as jsynth_batch,
)
from low_light_image_enhancement_tpu_torch import bench
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.core import pad_edge
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance import (
    fused_retinex_canvas,
)
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

TINY = dict(batch=2, h=16, w=24, repeats=2, n_short=1, n_long=3)
# bench_throughput's keys: the JAX bench's, then the port's
KEYS = {"images_per_sec", "canvas_images_per_sec", "rate_min", "rate_max",
        "rate_iqr_pct", "batch", "backend", "rates", "device_name",
        "method", "chain", "n_fallback", "roofline_bound",
        "achieved_hbm_gbps", "hbm_util_pct"}


def test_bench_input_equals_jax_bench_input():
    """bench.py:86-88 at a batch of 10: 8 images tiled, then cut."""
    lows, _ = jsynth_batch(8, 24, 40)
    want = np.tile(lows, (-(-10 // lows.shape[0]), 1, 1, 1))[:10]
    got = bench.bench_input(10, 24, 40, "cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got[8:].numpy(), got[:2].numpy())


@functools.lru_cache(maxsize=None)
def _jax_chain(method: str, dtype: str):
    """Two chained steps of the JAX pipeline's enhance_batch_device (its
    jnp path, one jitted program a step) on the bench's input, and its
    shipped weights."""
    ref = jpipe.EnhancePipeline(JConfig(method=method, compute_dtype=dtype),
                                force_jnp=True)
    x = jnp.asarray(bench.bench_input(2, 32, 48, "cpu").numpy())
    for _ in range(2):
        x = ref.enhance_batch_device(x)
    return np.asarray(x), ref.model_params


@pytest.mark.parametrize("method,dtype", [("retinex", "bfloat16"),
                                          ("hybrid", "float32"),
                                          ("hybrid", "bfloat16")])
def test_chained_steps_match_jax(method, dtype):
    """Each step's output is the next step's input, as the bench chains
    them: the port's two steps against JAX's with the shipped weights.
    retinex and float32 hybrid: max |du8| <= 1 (the changed share in the
    message); bf16 hybrid, the bench's default: PSNR >= 40 dB, the bar of
    tests/test_torch_pipeline.py, since bf16 convs round at other places
    in the two frameworks."""
    want, jparams = _jax_chain(method, dtype)
    params = None if jparams is None else params_from_numpy(jparams)
    pipe = EnhancePipeline(PipelineConfig(method=method,
                                          compute_dtype=dtype),
                           model_params=params, device="cpu")
    got = bench.eager_chain(pipe.enhance_batch_device,
                            bench.bench_input(2, 32, 48, "cpu"), 2).numpy()
    assert got.shape == want.shape == (2, 32, 48, 3)
    d = np.abs(got.astype(int) - want.astype(int))
    what = (method, dtype, "max", d.max(), "changed", (d > 0).mean())
    if method == "hybrid" and dtype == "bfloat16":
        mse = np.mean(d.astype(np.float64) ** 2)
        assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) >= 40.0, what
    else:
        assert d.max() <= 1, what


@pytest.mark.parametrize("method", ["retinex", "fcn"])
def test_python_chain_on_cpu_returns_every_key(method):
    res = bench.bench_throughput(method=method, chain="python",
                                 device="cpu", **TINY)
    assert KEYS <= set(res)
    assert res["backend"] == "cpu" and res["device_name"] == "cpu"
    assert res["batch"] == 2 and len(res["rates"]) == 2
    assert res["images_per_sec"] > 0 and res["rate_min"] > 0
    assert res["rate_min"] <= res["images_per_sec"] <= res["rate_max"]
    assert res["canvas_images_per_sec"] is None   # the device chain's
    assert "graph_launches" not in res


def test_device_chain_on_cpu_raises():
    """No CUDA graph on the CPU, and no swap to the Python chain."""
    with pytest.raises(ValueError, match="CUDA graph"):
        bench.bench_throughput(chain="device", device="cpu", **TINY)
    with pytest.raises(ValueError, match="CUDA graph"):
        bench.DeviceChain(lambda x: x, torch.zeros(1), 2)
    with pytest.raises(ValueError, match="chain must be"):
        bench.bench_throughput(chain="graph", device="cpu", **TINY)


def test_marginal_rate_and_its_fallback():
    """bench.py:119-129: the batch over the marginal seconds a step, else
    the long chain's total-time rate."""
    assert bench._rate(48, 0.1, 0.62, 8, 60) == (48 / 0.01, False)
    rate, fell = bench._rate(48, 0.5, 0.4, 8, 60)
    assert fell and rate == 48 * 60 / 0.4


def test_launch_counts_name_every_kernel_wrapper():
    counts = bench.launch_counts()
    assert {"fused_retinex", "fused_retinex_canvas", "fused_curve_enhance",
            "tiled_denoise", "conv2d_patch_mxu",
            "fcn_cascade_mxu"} <= set(counts)
    assert all(isinstance(n, int) for n in counts.values())


def test_main_prints_headline_last(capsys):
    assert bench.main(["--device", "cpu", "--chain", "python", "--height",
                       "16", "--width", "24", "--batch", "2", "--repeats",
                       "2", "--watchdog", "0"]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["metric"] == "images_per_sec_per_chip_24x16"
    assert line["unit"] == "images/sec/chip" and line["value"] > 0
    assert line["n_repeats"] == 2 and line["min"] <= line["max"]
    assert {"iqr_pct", "canvas_images_per_sec", "roofline_bound",
            "device_name", "power_limit"} <= set(line)
    assert "vs_baseline" not in line and line["power_limit"] is None
    assert "[bench] backend=cpu" in err


def test_canvas_chain_step_on_cpu():
    """The canvas chain's first input is K1's canvas form on the staged
    canvas, which crops to enhance_batch's output; a step re-pads the
    bottom rows by edge and keeps the canvas's shape."""
    pipe = EnhancePipeline(PipelineConfig(), device="cpu")
    x0 = bench.bench_input(2, 20, 36, "cpu")
    plan = pipe.canvas_plan(20, 36)
    c0 = bench.canvas_input(pipe, x0)
    assert c0.shape == (2, 3, plan.padded_h - 2 * plan.margin,
                        plan.padded_w) and c0.dtype == torch.uint8
    np.testing.assert_array_equal(pipe.crop_canvas(c0, 20, 36),
                                  pipe.enhance_batch(x0.numpy()))
    c1 = bench.canvas_step(pipe, 20, 36)(c0)
    assert c1.shape == c0.shape and c1.dtype == torch.uint8
    # the step is K1's canvas form on c0 edge-padded at the bottom
    vp = pad_edge(c0, 0, plan.padded_h - c0.shape[-2], 0, 0)
    want = fused_retinex_canvas(vp.contiguous(), pipe.config, plan.margin,
                                plan.padded_h - 2 * plan.margin)
    assert torch.equal(c1, want)
