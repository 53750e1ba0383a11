"""K6 (kernels/mxu_conv.py) and the nets' conv_impl="pallas" arms against
the JAX package's Pallas kernels and nets, run in interpret mode on the CPU.

The JAX kernels take space-to-depth packed activations; the port's take
NHWC. The JAX side packs and unpacks with its own ``space_to_depth`` /
``depth_to_space``. Bars: float32 within 1e-5 (the sums run in another
order; found: under 4.1e-6 at these sizes), bf16 within one bf16 step of
the value (the f32 sums round to neighbouring bf16 values now and then;
see ``assert_within``).
Pipelines: float32 max |du8| <= 1 with a changed share < 1e-3, bf16 PSNR
>= 40 dB, the bars of tests/test_torch_pipeline.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import pipeline as jpipe
from low_light_image_enhancement_tpu.config import PRESETS as JPRESETS
from low_light_image_enhancement_tpu.config import PipelineConfig as JConfig
from low_light_image_enhancement_tpu.kernels import mxu_conv as jmx
from low_light_image_enhancement_tpu.models import curve_cnn as jcnn
from low_light_image_enhancement_tpu.models import decom as jdecom
from low_light_image_enhancement_tpu.models import fcn as jfcn
from low_light_image_enhancement_tpu.models import weights as jweights
from low_light_image_enhancement_tpu.ops.patch_conv import (
    depth_to_space,
    pack_patch_weights,
    space_to_depth,
)
from low_light_image_enhancement_tpu_torch import blocks as tblocks
from low_light_image_enhancement_tpu_torch import pipeline as tpipe
from low_light_image_enhancement_tpu_torch.config import (
    PRESETS,
    PipelineConfig,
)
from low_light_image_enhancement_tpu_torch.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch.kernels import mxu_conv as tmx
from low_light_image_enhancement_tpu_torch.models import curve_cnn as tcnn
from low_light_image_enhancement_tpu_torch.models import decom as tdecom
from low_light_image_enhancement_tpu_torch.models import fcn as tfcn
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
)
from test_torch_conv_wgmma import ROWS, SMEM_LIMIT, wgmma_plan

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

_DTYPES = {"float32": (jnp.float32, torch.float32),
           "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _layer(cins, cout, h, w, seed):
    """Unit-scale NHWC groups, He-scaled HWIO weights and a bias."""
    rng = np.random.default_rng(seed)
    xs = [rng.random((2, h, w, c), dtype=np.float32) for c in cins]
    cin = sum(cins)
    wt = (rng.standard_normal((3, 3, cin, cout))
          * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
    b = (0.1 * rng.standard_normal(cout)).astype(np.float32)
    return xs, wt, b


def _torch_layer(xs, wt, b, tdt):
    return ([torch.from_numpy(x).to(tdt) for x in xs],
            torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))),
            torch.from_numpy(b))


F32_BAR = 1e-5


def assert_within(got, want, dtype):
    """float32: within 1e-5. bf16: at most one bf16 step of the larger
    magnitude apart, or within the float32 bar where the sum cancels to
    near 0 (the two f32 sums differ by ~1e-7 whatever their size, and a
    value of 4e-6 has a bf16 step of 3e-8; found once in 276,480 values)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    d = np.abs(got - want)
    if dtype == "float32":
        assert d.max() <= F32_BAR, d.max()
        return
    mag = np.maximum(np.abs(got), np.abs(want))
    step = np.exp2(np.floor(np.log2(np.maximum(mag, 1e-30))) - 7)
    bar = np.maximum(step, F32_BAR)
    assert np.all(d <= bar), (d.max(), float((d > bar).mean()))


# K6a: (groups, Cout, act) as the curve CNN (c2-c4, c5/c6, c7) and decom
# (c2-c4) have them
_PATCH_CASES = {"32-32-relu": ((32,), 32, "relu"),
                "64cat-32-relu": ((32, 32), 32, "relu"),
                "64cat-24-tanh": ((32, 32), 24, "tanh")}


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("case", sorted(_PATCH_CASES))
def test_patch_plain_matches_jax_kernel(case, dtype):
    cins, cout, act = _PATCH_CASES[case]
    jdt, tdt = _DTYPES[dtype]
    xs, wt, b = _layer(cins, cout, 16, 24, seed=len(case) + cout)
    xp = jnp.concatenate(
        [space_to_depth(jnp.asarray(x).astype(jdt)) for x in xs], -1)
    want = depth_to_space(jmx.conv2d_patch_mxu(
        xp, pack_patch_weights(jnp.asarray(wt), groups=cins),
        jnp.asarray(b), groups=cins, act=act, interpret=True))
    txs, tw, tb = _torch_layer(xs, wt, b, tdt)
    got = tmx.conv2d_patch_mxu(txs, tw, tb, act=act)
    assert got.dtype == tdt and got.shape == (2, 16, 24, cout)
    assert_within(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("dilation", [2, 32])
def test_dense9_plain_matches_jax_kernel(dilation, dtype):
    """80 rows and 72 columns, so the dilation-32 taps land inside."""
    jdt, tdt = _DTYPES[dtype]
    xs, wt, b = _layer((24,), 24, 80, 72, seed=dilation)
    want = depth_to_space(jmx.conv2d_dense9_mxu(
        space_to_depth(jnp.asarray(xs[0]).astype(jdt)),
        jmx.pack_dense9_weights(jnp.asarray(wt), dilation=dilation),
        jnp.asarray(b), act="leaky", step=dilation // 2, interpret=True))
    txs, tw, tb = _torch_layer(xs, wt, b, tdt)
    got = tmx.conv2d_dense9_mxu(txs[0], tw, tb, act="leaky",
                                dilation=dilation)
    assert_within(got.float().numpy(), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("groups,cout,dilation", [((24,), 24, 1),
                                                  ((24,), 24, 2),
                                                  ((32, 32), 24, 1),
                                                  ((20, 12), 12, 4)])
def test_pack_dense9_weights_matches_jax(groups, cout, dilation):
    """The port's (Cout, Cin, 3, 3) weights packed into the JAX package's
    dense-9 layout, Δ 0; odd dilations raise in both."""
    _, wt, _ = _layer(groups, cout, 2, 2, seed=cout + dilation)
    want = jmx.pack_dense9_weights(jnp.asarray(wt), groups, dilation)
    got = tmx.pack_dense9_weights(
        torch.from_numpy(np.ascontiguousarray(wt.transpose(3, 2, 0, 1))),
        groups, dilation)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="even"):
        jmx.pack_dense9_weights(jnp.asarray(wt), groups, 3)
    with pytest.raises(ValueError, match="even"):
        tmx.pack_dense9_weights(torch.from_numpy(wt).permute(3, 2, 0, 1),
                                groups, 3)


def test_wrappers_check_their_arguments():
    xs, wt, b = _layer((8,), 8, 4, 6, seed=0)
    (x,), w, bb = _torch_layer(xs, wt, b, torch.float32)
    with pytest.raises(ValueError, match="even"):
        tmx.conv2d_dense9_mxu(x, w, bb, dilation=3)
    with pytest.raises(ValueError, match="act"):
        tmx.conv2d_patch_mxu((x,), w, bb, act="gelu")
    with pytest.raises(ValueError, match="Cout"):
        tmx.conv2d_patch_mxu((x, x), w, bb)
    with pytest.raises(ValueError, match="bf16 or f32"):
        tmx.conv2d_patch_mxu((x.double(),), w, bb)
    assert tmx.conv2d_patch_mxu.launches == 0
    assert tmx.conv2d_dense9_mxu.launches == 0


def _curve_layers(features, n_iter):
    """The curve CNN's c2-c7 as (input groups, Cout)."""
    f = features
    return ([((f,), f)] * 3 + [((f, f), f)] * 2 + [((f, f), 3 * n_iter)])


class _PlanLib:
    """The library's ``llie_conv_plan`` as the CPU mirror of the kernel's
    plan in tests/test_torch_conv_wgmma.py computes it."""

    @staticmethod
    def llie_conv_plan(ca, cb, cout, dil):
        g = wgmma_plan([c for c in (ca, cb) if c], cout, dil)
        return 0 if g is None else g["nc"]


@pytest.mark.parametrize("features,n_iter", [(32, 8), (64, 8), (32, 4),
                                             (32, 16), (64, 16), (20, 8),
                                             (128, 8), (160, 8), (512, 16)])
def test_kernel_takes_the_curve_cnn_widths(features, n_iter):
    """Every layer the curve_features / curve_iters configs reach has a
    plan in both forms: a chunk width dividing Cout's padding to 8, and in
    bf16 a ring and one chunk of weights within shared memory."""
    for cins, cout in _curve_layers(features, n_iter):
        for bf16 in (True, False):
            nc = tmx._check_kernel_shapes(_PlanLib, cins, cout, 1, bf16)
            assert nc % 8 == 0 and 8 <= nc <= 64
            assert tmx.padded(cout) % nc == 0
        g = wgmma_plan([tmx.padded(c) for c in cins], cout, 1)
        assert g["slots"] >= ROWS + 2 and g["smem"] <= SMEM_LIMIT
        assert g["nsplit"] * g["npass"] * g["nc"] == tmx.padded(cout)
    # fcn's layers at every dilation
    for d in (1, 2, 4, 8, 16, 32, 66):
        assert tmx._check_kernel_shapes(_PlanLib, (24,), 24, d, True) == 24


def test_kernel_shapes_raise_only_past_shared_memory():
    # past 16 pieces of 64 channels, and 16 pieces at dilation 64, whose
    # halo rows of 192 pixels leave no room for four slots beside a chunk's
    # weights: these refused until the weights were streamed by piece group
    assert tmx._check_kernel_shapes(_PlanLib, (1032,), 8, 1, True) == 8
    assert tmx._check_kernel_shapes(_PlanLib, (520, 520), 64, 1, True) == 64
    assert tmx._check_kernel_shapes(_PlanLib, (1024,), 8, 64, True) == 8
    for cins, cout, d in (((1032,), 8, 1), ((520, 520), 64, 1),
                          ((1024,), 8, 64), ((1024, 1024), 24, 1),
                          ((2048,), 8, 128)):
        assert wgmma_plan([tmx.padded(c) for c in cins], cout, d)["stream"]
    # nothing a 3x3 layer reaches is refused
    for cin in range(8, 2049, 40):
        for d in (1, 64, 128):
            assert tmx._check_kernel_shapes(_PlanLib, (cin,), 24, d, True)
    # wider than whole halo rows leave room for: piece groups
    assert tmx._check_kernel_shapes(_PlanLib, (384,), 8, 1, True) == 8
    assert tmx._check_kernel_shapes(_PlanLib, (160, 160), 64, 1, True) == 16
    # the f32 form reads wide weights in place
    assert tmx._check_kernel_shapes(None, (1032,), 8, 1, False) == 8


@pytest.mark.parametrize("groups,cout", [((20,), 20), ((20, 20), 12),
                                         ((32, 12), 15)])
def test_padded_groups_compute_the_same_conv(groups, cout):
    """The wrapper's one-time padding of a group off the step of 8 (zero
    channels against zero weight rows, ``_pad_weights``) and of Cout
    (zero outputs, sliced off) leave the conv as it was."""
    xs, wt, b = _layer(groups, cout, 6, 10, seed=cout)
    txs, tw, tb = _torch_layer(xs, wt, b, torch.float32)
    want = tmx.conv3x3_plain(txs, tw, tb, "tanh")
    pxs = [torch.nn.functional.pad(x, (0, tmx.padded(c) - c))
           for x, c in zip(txs, groups)]
    pw = tmx._pad_weights(tw, groups)
    pb = torch.nn.functional.pad(tb, (0, tmx.padded(cout) - cout))
    got = tmx.conv3x3_plain(pxs, pw, pb, "tanh")[..., :cout]
    assert_within(got.numpy(), want.numpy(), "float32")
    # the f32 packer holds the same zeros, tap-major
    packed = tmx.pack_conv_weights(tw, torch.float32, groups)
    assert packed.shape == (9, sum(map(tmx.padded, groups)),
                            tmx.padded(cout))
    assert torch.equal(packed, pw.permute(2, 3, 1, 0).reshape(
        9, *packed.shape[1:]))


def test_packed_weights_are_cached_per_parameter_set():
    w = torch.randn(24, 16, 3, 3)
    a = tmx.packed_params((w,), torch.bfloat16,
                          lambda: (tmx.pack_conv_weights(w, torch.bfloat16),))
    again = tmx.packed_params((w,), torch.bfloat16, lambda: None)
    assert again is a and a[0].shape == (9, 16, 24)
    torch.testing.assert_close(
        a[0][4], w[:, :, 1, 1].t().to(torch.bfloat16).float(),
        rtol=0, atol=0)
    w.mul_(2.0)  # changed in place: packed anew
    b = tmx.packed_params((w,), torch.bfloat16,
                          lambda: (tmx.pack_conv_weights(w, torch.bfloat16),))
    assert b is not a
    n = len(tmx._PACKED)
    del w, a, again, b
    assert len(tmx._PACKED) == n - 1


# ----------------------------------------------- the nets' pallas arms #

def _net_input(h, w, seed=0):
    return np.random.default_rng(seed).random((2, 3, h, w),
                                              dtype=np.float32)


def _jit_interpret(apply, **kw):
    """A JAX pallas arm in interpret mode under one jax.jit (eager, it
    dispatches and compiles op by op)."""
    return jax.jit(functools.partial(apply, compute_dtype=jnp.float32,
                                     interpret=True, **kw))


@pytest.fixture(scope="module")
def net_refs():
    """The JAX nets' pallas arms (interpret mode, float32) on shared
    inputs: the curve CNN and decom at 24x32, fcn at 80x96."""
    out = {}
    for name, weights, apply, (h, w) in (
            ("curve", "hybrid", jcnn.apply_curve_cnn_pallas, (24, 32)),
            ("decom", "decom_relit_guided", jdecom.apply_decom_net_pallas,
             (24, 32)),
            ("fcn", "fcn", jfcn.apply_fcn_pallas, (80, 96))):
        params = jweights.resolve_weights(weights)
        x = _net_input(h, w)
        y = _jit_interpret(apply)(params, jnp.asarray(x))
        out[name] = (params, x, y)
    return out


def _curve_params(features, n_iter, seed):
    """The curve CNN's He-normal weights and zero biases, as
    ``init_curve_cnn`` shapes them, drawn with numpy."""
    rng = np.random.default_rng(seed)
    sizes = [(3, features)] + [(features, features)] * 3 \
        + [(2 * features, features)] * 2 + [(2 * features, 3 * n_iter)]
    return {f"c{i}": {"w": (rng.standard_normal((3, 3, cin, cout))
                            * np.sqrt(2.0 / (9 * cin))).astype(np.float32),
                      "b": np.zeros(cout, np.float32)}
            for i, (cin, cout) in enumerate(sizes, start=1)}


@pytest.mark.parametrize("features,n_iter", [(64, 8), (32, 4), (32, 16)])
def test_pallas_curve_cnn_widths_match_jax(features, n_iter):
    """apply_curve_cnn_pallas at the widths curve_features 64 and
    curve_iters 4 and 16 reach (c5/c6 128 -> 64, heads of 12 and 48
    channels), random weights, against the JAX package's pallas arm in
    interpret mode, f32 within 1e-5."""
    params = _curve_params(features, n_iter, seed=features + n_iter)
    x = _net_input(24, 32, seed=n_iter)
    want = _jit_interpret(jcnn.apply_curve_cnn_pallas, n_iter=n_iter)(
        params, jnp.asarray(x))
    got = tcnn.apply_curve_cnn_pallas(params_from_numpy(params),
                                      torch.from_numpy(x), n_iter,
                                      compute_dtype="float32")
    assert got.shape == (2, n_iter, 3, 24, 32) == want.shape
    assert_within(got.numpy(), want, "float32")


_PORT_NETS = {"curve": tcnn.apply_curve_cnn_pallas,
              "decom": tdecom.apply_decom_net_pallas,
              "fcn": tfcn.apply_fcn_pallas}


@pytest.mark.parametrize("name", sorted(_PORT_NETS))
def test_pallas_net_matches_jax(net_refs, name):
    params, x, want = net_refs[name]
    got = _PORT_NETS[name](params_from_numpy(params), torch.from_numpy(x),
                           compute_dtype="float32")
    if name == "decom":
        for g, wnt in zip(got, want):
            assert_within(g.numpy(), wnt, "float32")
    else:
        assert got.shape == want.shape and got.dtype == torch.float32
        assert_within(got.numpy(), want, "float32")


def test_conv_impl_mapping():
    def impl(**kw):
        return tblocks.resolve_conv_impl(PipelineConfig(**kw)).conv_impl

    for method in ("curve", "hybrid", "fcn", "decom"):
        assert impl(method=method) == "xla"            # auto
        assert impl(method=method, conv_impl="xla") == "xla"
        assert impl(method=method, conv_impl="pallas") == "pallas"
    assert impl(method="fcn", conv_impl="cascade") == "cascade"
    for method in ("retinex", "curve", "hybrid", "decom"):
        assert impl(method=method, conv_impl="cascade") == "xla"
    # use_pallas does not steer it
    assert impl(method="fcn", conv_impl="pallas", use_pallas=False) \
        == "pallas"
    # ops/patch_conv.py's arms, ported: each resolves to itself
    for method in ("curve", "hybrid", "fcn", "decom"):
        for other in ("gemm", "packed", "packed12"):
            assert impl(method=method, conv_impl=other) == other


# --------------------------------------------------------- pipelines #

_PIPES = {
    "hybrid-pallas": (PipelineConfig(method="hybrid", conv_impl="pallas"),
                      JConfig(method="hybrid", conv_impl="pallas")),
    "quality-pallas": (PRESETS["quality"].replace(conv_impl="pallas"),
                       JPRESETS["quality"].replace(conv_impl="pallas")),
}


def pipeline_pair(tcfg, jcfg, compute_dtype):
    """The JAX pipeline with its kernels in interpret mode, and the port's
    on the CPU with the same weights."""
    ref = jpipe.EnhancePipeline(jcfg.replace(compute_dtype=compute_dtype),
                                pallas_interpret=True)
    port = tpipe.EnhancePipeline(tcfg.replace(compute_dtype=compute_dtype),
                                 model_params=params_from_numpy(
                                     ref.model_params), device="cpu")
    return port, ref


def check_pipeline(port, ref, lows, compute_dtype):
    got, want = port.enhance_batch(lows), ref.enhance_batch(lows)
    assert got.shape == lows.shape and got.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    if compute_dtype == "float32":
        assert d.max() <= 1 and (d > 0).mean() < 1e-3, \
            (d.max(), (d > 0).mean())
    else:
        mse = np.mean(d.astype(np.float64) ** 2)
        psnr = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
        assert psnr >= 40.0, psnr


@pytest.mark.parametrize("compute_dtype", sorted(_DTYPES))
@pytest.mark.parametrize("name", sorted(_PIPES))
def test_pallas_pipeline_matches_jax(name, compute_dtype):
    lows, _ = synth_batch(2, 24, 40, seed=2)
    port, ref = pipeline_pair(*_PIPES[name], compute_dtype)
    check_pipeline(port, ref, lows, compute_dtype)
