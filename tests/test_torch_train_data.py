"""Training's data, weights, checkpoints, roofline and CLI in the port,
against the JAX package where it has the same piece: the device-side
synthetic pairs (the deterministic body fed the JAX draws, within 1e-6),
LOL's batch plans (equal) and their decode (byte-equal), the prefetch
queue staging a (low, high) pair, checkpoint rotation, ``save_params``
through the JAX package's ``load_params`` and ``apply_*``, the roofline's
counts (equal), and ``llie-torch train`` on the CPU."""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from low_light_image_enhancement_tpu.config import PipelineConfig as JCfg
from low_light_image_enhancement_tpu.data import synth_device as jsd
from low_light_image_enhancement_tpu.data.lol import LOLDataset as JLOL
from low_light_image_enhancement_tpu.models import weights as jw
from low_light_image_enhancement_tpu.models.curve_cnn import (
    apply_curve_cnn as j_apply_curve,
)
from low_light_image_enhancement_tpu.utils import roofline as jr
from low_light_image_enhancement_tpu_torch import cli
from low_light_image_enhancement_tpu_torch.config import PipelineConfig
from low_light_image_enhancement_tpu_torch.data import synth_device as tsd
from low_light_image_enhancement_tpu_torch.data.lol import LOLDataset
from low_light_image_enhancement_tpu_torch.io.prefetch import PrefetchQueue
from low_light_image_enhancement_tpu_torch.models import weights as tw
from low_light_image_enhancement_tpu_torch.models.curve_cnn import (
    apply_curve_cnn,
    init_curve_cnn,
)
from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline
from low_light_image_enhancement_tpu_torch.utils import roofline as tr
from low_light_image_enhancement_tpu_torch.utils.checkpoint import (
    CheckpointManager,
)


def jax_draws(key, b, h, w):
    """The JAX package's synth_pair_batch draws, by its own key split."""
    (k_base, k_tex, k_fine, k_lvl, k_illum, k_cast, k_rd, k_sh,
     k_noise) = jax.random.split(key, 9)
    u = jax.random.uniform
    d = {"base": u(k_base, (b, 6, 6, 3)), "texture": u(k_tex, (b, 24, 24, 3)),
         "fine": u(k_fine, (b, 48, 48, 3)),
         "log_level": u(k_lvl, (b, 1, 1, 1), minval=jnp.log(0.03),
                        maxval=jnp.log(0.45)),
         "illum": u(k_illum, (b, 4, 4, 1)),
         "cast": u(k_cast, (b, 1, 1, 3), minval=-0.25, maxval=0.25),
         "read": u(k_rd, (b, 1, 1, 1), minval=0.004, maxval=0.015),
         "shot": u(k_sh, (b, 1, 1, 1), minval=0.0005, maxval=0.003),
         "noise": jax.random.normal(k_noise, (b, h, w, 3))}
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def test_synth_pair_batch_body_matches_jax():
    """At 40 rows the fine field (48) shrinks and JAX's resize antialiases;
    its columns and the other fields grow."""
    key = jax.random.PRNGKey(7)
    b, h, w = 2, 40, 56
    want = jsd.synth_pair_batch(key, b, h, w)
    got = tsd.synth_from_draws(jax_draws(key, b, h, w), h, w)
    for g, wnt in zip(got, want):
        assert g.shape == (b, 3, h, w)
        np.testing.assert_allclose(g.numpy(), np.asarray(wnt), atol=1e-6)


def test_bilinear_upsample_is_jax_resize():
    """F.interpolate (bilinear, align_corners=False) upsamples as
    jax.image.resize does: 6x6 -> 64x64 within 1.2e-7."""
    x = np.random.default_rng(0).random((1, 6, 6, 3), np.float32)
    want = jax.image.resize(x, (1, 64, 64, 3), method="bilinear")
    for aa in (False, True):
        got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                            size=(64, 64), mode="bilinear",
                            align_corners=False, antialias=aa)
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want), atol=1.2e-7)


def test_synth_batch_iter_seeded_on_the_cpu():
    a = next(tsd.synth_batch_iter(2, 32, 32, seed=3, device="cpu"))
    b = next(tsd.synth_batch_iter(2, 32, 32, seed=3, device="cpu"))
    c = next(tsd.synth_batch_iter(2, 32, 32, seed=4, device="cpu"))
    for x in a:
        assert x.shape == (2, 3, 32, 32) and x.dtype == torch.float32
        assert 0.0 <= float(x.min()) and float(x.max()) <= 1.0
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert float(a[0].mean()) < float(a[1].mean())  # the low is darker
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            next(tsd.synth_batch_iter(2, 32, 32))


@pytest.mark.parametrize("paired", [True, False])
def test_lol_plans_equal_and_batches_byte_equal(paired):
    jds, tds = JLOL(split="train"), LOLDataset(split="train")
    assert tds.is_synthetic and len(tds) == len(jds)
    jp = jds.train_batch_plans(2, 48, seed=5, start_step=7, paired=paired)
    tp = tds.train_batch_plans(2, 48, seed=5, start_step=7, paired=paired)
    for _ in range(2):
        a, b = next(jp), next(tp)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        want, got = jds.materialize_batch(a), tds.materialize_batch(b)
        want = want if paired else (want,)
        got = got if paired else (got,)
        for g, wnt in zip(got, want):
            assert g.dtype == np.float32 and g.shape == (2, 3, 48, 48)
            np.testing.assert_array_equal(g, wnt)
    np.testing.assert_array_equal(tds.low(3), jds.low(3))
    with pytest.raises(ValueError, match="crop 512 exceeds"):
        tds.materialize_batch(dict(next(tp), crop=512))


def test_prefetch_queue_stages_a_pair():
    """A (low, high) pair through the queue's workers comes out as a tuple
    of two tensors (it was stacked into one before), in plan order, equal
    to the serial train_batches stream."""
    ds = LOLDataset(split="train")
    plans = ds.train_batch_plans(2, 32, seed=1)
    serial = ds.train_batches(2, 32, seed=1)
    q = PrefetchQueue(plans, depth=2, transform=ds.materialize_batch,
                      workers=2, device="cpu")
    try:
        for _ in range(3):
            item, (lo, hi) = next(q), next(serial)
            assert isinstance(item, tuple) and len(item) == 2
            assert all(isinstance(t, torch.Tensor) for t in item)
            np.testing.assert_array_equal(item[0].numpy(), lo)
            np.testing.assert_array_equal(item[1].numpy(), hi)
    finally:
        q.close()
    q = PrefetchQueue([[np.zeros(2), np.ones(3)]], device="cpu")
    (pair,) = list(q)
    assert isinstance(pair, tuple) and [t.shape[0] for t in pair] == [2, 3]


def test_checkpoint_rotation_and_restore(tmp_path):
    ck = CheckpointManager(str(tmp_path / "ck"))
    assert ck.latest_step() is None and ck.restore_latest({}) is None
    state = {"params": {"c1": {"w": torch.ones(2, 3)}}, "step": 0}
    for step in range(1, 6):
        state = {"params": {"c1": {"w": torch.full((2, 3), float(step))}},
                 "step": step}
        ck.save(state, step=step)
    assert ck.steps() == [3, 4, 5] and ck.latest_step() == 5
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == \
        ["3", "4", "5"]  # no temporary directory left behind
    got = ck.restore(4, state)
    assert got["step"] == 4 and torch.equal(got["params"]["c1"]["w"],
                                            torch.full((2, 3), 4.0))
    with pytest.raises(ValueError, match="template"):
        ck.restore_latest(dict(state, ema_params=state["params"]))
    ck.wait()
    ck.close()


def test_save_params_round_trips_through_jax(tmp_path):
    """The port's weights -> save_params -> the JAX package's load_params
    -> its apply_curve_cnn equals the port's apply; and the JAX package's
    save_params -> the port's load_params -> params_from_numpy gives the
    same tensors back."""
    pp = init_curve_cnn(torch.Generator().manual_seed(2), features=8,
                        n_iter=2)
    path = tmp_path / "w.npz"
    tw.save_params(pp, path)
    jp = jw.load_params(path)
    x = np.random.default_rng(1).random((1, 3, 24, 32), np.float32)
    want = j_apply_curve(jp, jnp.asarray(x), n_iter=2)
    got = apply_curve_cnn(pp, torch.from_numpy(x), n_iter=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    jw.save_params(jp, tmp_path / "j.npz")
    back = tw.params_from_numpy(tw.load_params(tmp_path / "j.npz"))
    for a, b in zip(back.values(), pp.values()):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])


def test_roofline_counts_equal_jax():
    for remat in (True, False):
        for dtype in ("float32", "bfloat16"):
            j = jr.train_step_cost(32, 8, 512, remat, dtype)
            t = tr.train_step_cost(32, 8, 512, remat, dtype)
            assert (t.tensor_flops, t.cuda_core_flops, t.hbm_bytes) == \
                (j.mxu_flops, j.vpu_flops, j.hbm_bytes)
    for kw in (dict(method="retinex"), dict(method="hybrid"),
               dict(method="curve", curve_downsample=4),
               dict(method="fcn", compute_dtype="float32"),
               dict(method="decom", denoise_taps="full",
                    denoise_kernel="epan", denoise_guide="perchannel")):
        j = jr.pipeline_cost(JCfg(**kw), 400, 600)
        t = tr.pipeline_cost(PipelineConfig(**kw), 400, 600)
        assert (t.tensor_flops, t.cuda_core_flops, t.hbm_bytes) == \
            (j.mxu_flops, j.vpu_flops, j.hbm_bytes)
    rep = tr.train_roofline_report(32, 8, 512, 1000.0, True, "bfloat16")
    # config 3: 4 x 41.5 GFLOP of convs, ~660 MB of HBM traffic an image;
    # the bound is max(166 GFLOP / 989 TFLOP/s, 660 MB / 3.35 TB/s)
    assert abs(rep["train_flops_per_img_tensor"] - 166.1e9) < 0.1e9
    assert abs(rep["train_hbm_bytes_per_img"] - 660e6) < 5e6
    assert rep["train_roofline_bound"] == "HBM"
    assert 5000 < rep["train_bound_images_per_sec"] < 5200
    # float32 (TF32 off): the convs on the CUDA cores bind, 2.48 ms an image
    rep = tr.train_roofline_report(32, 8, 512, 100.0, True, "float32")
    assert rep["train_roofline_bound"] == "CUDA cores"
    assert abs(rep["train_bound_ms_per_img"] - 2.479) < 0.002
    assert tr.roofline_report(PipelineConfig(), 400, 600, 1e4)[
        "roofline_bound"] in ("tensor cores", "CUDA cores", "HBM")


def _cli_train(tmp_path, *argv):
    assert cli.main(["train", "--device", "cpu", "--steps", "2",
                     "--batch", "2", "--crop", "32", *argv]) == 0


@pytest.mark.parametrize("objective", ["zeroref", "paired"])
def test_cli_train_saves_weights_the_pipeline_loads(tmp_path, objective):
    """llie-torch train on the CPU (zero-reference on the synthetic
    stream; paired from --data-dir on an empty directory, the synthetic
    LOL stand-in, decoded on two workers) writes weights that the port's
    CPU pipeline serves."""
    w = tmp_path / "w.npz"
    extra = ([] if objective == "zeroref" else
             ["--data-dir", str(tmp_path), "--decode-workers", "2"])
    _cli_train(tmp_path, "--objective", objective, "--save-weights", str(w),
               "--checkpoint-dir", str(tmp_path / "ck"), *extra)
    assert CheckpointManager(str(tmp_path / "ck")).latest_step() == 2
    params = tw.params_from_numpy(tw.load_params(w))
    assert params["c7"]["w"].shape == (24, 64, 3, 3)
    lows = np.random.default_rng(0).integers(0, 60, (1, 24, 40, 3),
                                             dtype=np.uint8)
    out = EnhancePipeline(PipelineConfig(method="curve"),
                          model_params=params,
                          device="cpu").enhance_batch(lows)
    assert out.shape == lows.shape and out.dtype == np.uint8
    assert out.mean() > lows.mean()


def test_cli_train_fcn_and_decom(tmp_path):
    for model in ("fcn", "decom"):
        _cli_train(tmp_path, "--model", model, "--ema-decay", "0.9")
