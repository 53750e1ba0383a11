"""The port imports no jax and no module of the JAX package: in a fresh
interpreter where both are blocked (and PIL, as on the card host), it
imports every module and runs CPU pipelines (with the nets' pallas and
cascade arms among them), CPU video enhancers, the HWC entry point,
enhance_file through the zlib codec, enhance_stream, a CPU train step and
a checkpoint save and restore, and the parallel package (config 5's
sharded pipeline, the sharded video enhancer and a data-parallel step on
CPU meshes); in the same way RAW ingest (enhance_raw, also sharded, and
llie-torch enhance --raw on a .npy) and the toolkit ops; chip_smoke.py
names neither. Also the gemm and packed conv arms and the utils
(checked, profile_trace, stage, enable_compile_cache)."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.kernels import fcn_cascade as fc
from low_light_image_enhancement_tpu_torch.kernels import fused_enhance as fe
from low_light_image_enhancement_tpu_torch.kernels import (
    fused_enhance_hwc as hwc,
)
from low_light_image_enhancement_tpu_torch.kernels import mxu_conv as mx
from low_light_image_enhancement_tpu_torch.kernels import tiled_denoise as td

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED = r"""
import sys
preloaded = set(sys.modules)
sys.modules["jax"] = None
sys.modules["low_light_image_enhancement_tpu"] = None
sys.modules["PIL"] = None
"""

_LOADED = r"""
loaded = sorted(m for m in set(sys.modules) - preloaded
                if m.startswith(("jax", "low_light_image_enhancement_tpu."))
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK")
"""

_PROGRAM = _BLOCKED + r"""
import numpy as np
import torch
import low_light_image_enhancement_tpu_torch as llt
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
lows, _ = synth_batch(1, 24, 40)
from low_light_image_enhancement_tpu_torch.eval.metrics import psnr_u8
for cfg in (llt.PipelineConfig(), llt.PipelineConfig(method="hybrid"),
            llt.PRESETS["quality"], llt.PRESETS["quality_fast"],
            llt.PipelineConfig(method="hybrid", conv_impl="pallas"),
            llt.PRESETS["quality"].replace(conv_impl="pallas"),
            llt.PRESETS["quality_fast"].replace(conv_impl="cascade")):
    out = llt.EnhancePipeline(cfg, device="cpu").enhance_batch(lows)
    assert out.shape == lows.shape and out.dtype == np.uint8
    assert float(psnr_u8(torch.from_numpy(out), torch.from_numpy(lows))) > 0
for cfg in (llt.PipelineConfig(),
            llt.PipelineConfig(method="curve", curve_downsample=4)):
    ve = llt.VideoEnhancer(cfg, device="cpu")
    for frame in (lows[0], lows[0]):
        out = ve.process(frame)
        assert out.shape == frame.shape and out.dtype == np.uint8
from low_light_image_enhancement_tpu_torch.kernels.fused_enhance_hwc import (
    enhance_hwc_u8)
out = enhance_hwc_u8(torch.from_numpy(lows), llt.PipelineConfig(
    denoise_guide="perchannel", denoise_taps="full"))
assert out.shape == lows.shape and out.dtype == torch.uint8
import tempfile
from pathlib import Path
from low_light_image_enhancement_tpu_torch import cli, http_server
from low_light_image_enhancement_tpu_torch.data.lol import LOLDataset
from low_light_image_enhancement_tpu_torch.eval.runner import eval_lol
from low_light_image_enhancement_tpu_torch.io import codec
from low_light_image_enhancement_tpu_torch.utils.logging import JSONLLogger
assert codec.Image is None
pipe = llt.EnhancePipeline(device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    src, dst = Path(tmp) / "dark.png", Path(tmp) / "bright.png"
    llt.encode_image(lows[0], src)
    pipe.enhance_file(src, dst)
    assert (llt.decode_image(dst) == pipe.enhance(lows[0])).all()
for staging in ("hwc", "planar", "canvas"):
    outs = list(pipe.enhance_stream(iter([lows[0], lows]), staging=staging))
    assert (outs[0] == pipe.enhance(lows[0])).all()
    assert (outs[1] == pipe.enhance_batch(lows)).all()
from low_light_image_enhancement_tpu_torch import train
from low_light_image_enhancement_tpu_torch.data import synth_device
from low_light_image_enhancement_tpu_torch.models import (
    CurveEstimatorCNN, DecomNet, EnhanceFCN)
from low_light_image_enhancement_tpu_torch.models.weights import save_params
from low_light_image_enhancement_tpu_torch.utils import roofline
from low_light_image_enhancement_tpu_torch.utils.checkpoint import (
    CheckpointManager)
tcfg = train.TrainConfig(features=8, n_iter=2, batch_size=2, crop=32)
params, opt = train.init_train_state(tcfg, device="cpu")
batch = next(synth_device.synth_batch_iter(2, 32, 32, device="cpu"))[0]
params, opt, m = train.make_train_step(tcfg)(params, opt, batch)
assert int(opt["count"]) == 1 and np.isfinite(float(m["loss"]))
with tempfile.TemporaryDirectory() as tmp:
    ck = CheckpointManager(tmp)
    ck.save({"params": params, "opt_state": opt, "step": 1}, step=1)
    back = ck.restore_latest({"params": params, "opt_state": opt, "step": 0})
    assert back["step"] == 1 and torch.equal(back["params"]["c1"]["w"],
                                             params["c1"]["w"])
    save_params(params, Path(tmp) / "w.npz")
assert roofline.train_step_cost(8, 2, 32).tensor_flops > 0
from low_light_image_enhancement_tpu_torch import parallel
from low_light_image_enhancement_tpu_torch.parallel import distributed
cpu2 = parallel.make_mesh(1, 2, ["cpu", "cpu"])
out = llt.EnhancePipeline(llt.PRESETS["config5_4k_sharded"],
                          device="cpu").enhance_batch(lows)
assert (out == pipe.enhance_batch(lows)).all()
sve = parallel.SpatialShardedVideoEnhancer(cpu2, llt.PipelineConfig(),
                                           device="cpu")
assert (sve.process(lows[0]) == llt.VideoEnhancer(
    device="cpu").process(lows[0])).all()
params, opt, m = train.make_train_step(tcfg, parallel.make_mesh(
    2, 1, ["cpu", "cpu"]))(params, opt, batch)
assert int(opt["count"]) == 2 and distributed.process_group_size() == 0
""" + _LOADED

# the slices' programs, each run in a fresh interpreter with jax, the JAX
# package and PIL blocked
_SLICES = {
    "raw": r"""
import tempfile
from pathlib import Path
import numpy as np
import low_light_image_enhancement_tpu_torch as llt
from low_light_image_enhancement_tpu_torch import cli
from low_light_image_enhancement_tpu_torch.io import codec
assert codec.Image is None
raws = np.random.default_rng(0).integers(0, 4096, (2, 24, 40), np.uint16)
pipe = llt.EnhancePipeline(device="cpu")
out = pipe.enhance_raw_batch(raws, white_level=4095)
assert out.shape == (2, 24, 40, 3) and out.dtype == np.uint8
assert (pipe.enhance_raw(raws[0], white_level=4095) == out[0]).all()
sharded = llt.EnhancePipeline(llt.PipelineConfig(spatial_shards=2),
                              device="cpu")
assert (sharded.enhance_raw_batch(raws, white_level=4095) == out).all()
with tempfile.TemporaryDirectory() as tmp:
    src, dst = Path(tmp) / "m.npy", Path(tmp) / "o.png"
    np.save(src, raws[0])
    assert cli.main(["enhance", "--raw", str(src), str(dst), "--device",
                     "cpu", "--white-level", "4095"]) == 0
    assert (llt.decode_image(dst) == out[0]).all()
""",
    "conv_arms_utils": r"""
import os
import tempfile
import numpy as np
import torch
import low_light_image_enhancement_tpu_torch as llt
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.kernels import _build
from low_light_image_enhancement_tpu_torch.utils import (
    enable_compile_cache, profile_trace, stage)
from low_light_image_enhancement_tpu_torch.utils.debug import checked
lows, _ = synth_batch(1, 24, 40)
for cfg in (llt.PipelineConfig(method="hybrid", conv_impl="packed"),
            llt.PRESETS["quality_fast"].replace(conv_impl="gemm")):
    out = llt.EnhancePipeline(cfg, device="cpu").enhance_batch(lows)
    assert out.shape == lows.shape and out.dtype == np.uint8
try:
    checked(torch.log)(torch.tensor([-1.0]))
    raise AssertionError("checked let a NaN pass")
except FloatingPointError:
    pass
with tempfile.TemporaryDirectory() as tmp:
    with profile_trace(tmp):
        with stage("noop"):
            torch.ones(4).sum()
    assert os.listdir(tmp)
    assert enable_compile_cache(os.path.join(tmp, "k")) == \
        str(_build.BUILD_DIR)
""",
    "toolkit": r"""
import torch
from low_light_image_enhancement_tpu_torch import ops
x = torch.rand(1, 3, 24, 40)
for y in (ops.clahe(x), ops.autocontrast(x), ops.raw_to_srgb(x[:, 0]),
          ops.hvi_to_rgb(ops.rgb_to_hvi(x)),
          ops.fourier_amplitude_boost(x)):
    assert y.shape[-2:] == x.shape[-2:] and torch.isfinite(y).all()
""",
}


def test_port_runs_without_jax():
    proc = subprocess.run([sys.executable, "-c", _PROGRAM], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


@pytest.mark.parametrize("slice_", sorted(_SLICES))
def test_port_slice_runs_without_jax(slice_):
    proc = subprocess.run(
        [sys.executable, "-c", _BLOCKED + _SLICES[slice_] + _LOADED],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("OK")


def test_port_sources_name_no_jax_import():
    pkg = ROOT / "low_light_image_enhancement_tpu_torch"
    for path in pkg.rglob("*.py"):
        text = path.read_text()
        assert "import jax" not in text and "from jax" not in text, path
        assert "from low_light_image_enhancement_tpu." not in text, path
        assert "import low_light_image_enhancement_tpu\n" not in text, path


def test_cuda_tensors_go_to_the_kernels_or_raise():
    """A tensor on a CUDA device never takes the plain version: on a host
    without nvcc and a card, each wrapper raises."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: chip_smoke.py runs the kernels")
    with FakeTensorMode():
        x = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="cuda")
        xb = torch.empty((1, 3, 24, 128), dtype=torch.uint8, device="cuda")
        maps = torch.empty((1, 8, 3, 24, 128), device="cuda")
        yb = torch.empty((1, 3, 48, 128), device="cuda")
        lowres = torch.empty((1, 8, 3, 6, 32), device="cuda")
        plane = torch.empty((1, 24, 128), device="cuda")
    assert x.device.type == "cuda"
    wrappers = (fe.fused_retinex, fe.fused_curve_enhance,
                fe.fused_retinex_ema, fe.fused_retinex_canvas,
                td.tiled_denoise)
    before = [wr.launches for wr in wrappers]
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_retinex(x, PipelineConfig())
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_curve_enhance(xb, maps, PipelineConfig(method="hybrid"),
                               8, 8, 8)
    # K3 with maps at 1/4 and with the video's gain plane, K1's gain form
    # and K4
    hybrid4 = PipelineConfig(method="hybrid", curve_downsample=4)
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_curve_enhance(xb, lowres, hybrid4, 8, 8, 8, ds=4)
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_curve_enhance(xb, lowres, hybrid4, 8, 8, 8, ds=4,
                               gain=plane)
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_retinex_gain(xb, plane, PipelineConfig(), 8, 8)
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_retinex_canvas(xb, PipelineConfig(), 4, 16)
    with pytest.raises(RuntimeError, match="nvcc"):
        fe.fused_retinex_ema(xb, plane, PipelineConfig(), 8, 8, 8, 0.3)
    for cfg in (PipelineConfig(method="fcn"),
                PipelineConfig(method="decom", denoise_taps="guided",
                               guided_radius=4)):
        with pytest.raises(RuntimeError, match="nvcc"):
            td.tiled_denoise(yb, cfg, 16, 16)
    assert [wr.launches for wr in wrappers] == before


def test_chip_smoke_names_no_jax():
    text = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in text and "from jax" not in text
    assert "low_light_image_enhancement_tpu." not in text
    assert "import low_light_image_enhancement_tpu\n" not in text


def test_conv_and_hwc_cuda_tensors_go_to_the_kernels_or_raise():
    """K6a, K6b, K7 and K8 as the no-fallback test above: a CUDA tensor
    on a host without nvcc and a card raises, and nothing counts."""
    if torch.cuda.is_available():
        pytest.skip("the card is there: chip_smoke.py runs the kernels")
    with FakeTensorMode():
        act = torch.empty((1, 8, 16, 32), dtype=torch.bfloat16,
                          device="cuda")
        act24 = torch.empty((1, 8, 16, 24), dtype=torch.bfloat16,
                            device="cuda")
        w = torch.empty((32, 64, 3, 3), device="cuda")
        w24 = torch.empty((24, 24, 3, 3), device="cuda")
        b, b24 = (torch.empty((32,), device="cuda"),
                  torch.empty((24,), device="cuda"))
        img = torch.empty((1, 8, 8, 3), dtype=torch.uint8, device="cuda")
    wrappers = (mx.conv2d_patch_mxu, mx.conv2d_dense9_mxu,
                fc.fcn_cascade_mxu, hwc.enhance_hwc_u8, fe.fused_retinex)
    before = [wr.launches for wr in wrappers]
    with pytest.raises(RuntimeError, match="nvcc"):
        mx.conv2d_patch_mxu((act, act), w, b, act="relu")
    with pytest.raises(RuntimeError, match="nvcc"):
        mx.conv2d_dense9_mxu(act24, w24, b24, act="leaky", dilation=32)
    with pytest.raises(RuntimeError, match="nvcc"):
        fc.fcn_cascade_mxu(act24, [w24] * 6, [b24] * 6, (2, 4, 8, 16, 32, 1))
    with pytest.raises(RuntimeError, match="nvcc"):
        hwc.enhance_hwc_u8(img, PipelineConfig(denoise_guide="perchannel",
                                               denoise_taps="full"))
    assert [wr.launches for wr in wrappers] == before
