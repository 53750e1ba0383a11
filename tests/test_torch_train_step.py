"""The port's training step and loop (train.py) against the JAX package's:
AdamW steps on carried weights, bf16, microbatching, remat, the loop with
EMA, early stopping, checkpoint resume (and the EMA flag changing across
it), the trainers end to end on the CPU, and the device and mesh rules.

Tolerances: losses rtol 1e-5 in float32 and 1e-2 in bf16; params after
steps atol 1e-6 + rtol 1e-4 of their JAX values (float32, sums in another
order). The port against itself (microbatch, remat, resume) is exact or
within float32 rounding, as stated at each test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import train as jt
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch import train as tt
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
    params_to_numpy,
)

PARAM_ATOL, PARAM_RTOL = 1e-6, 1e-4

TINY = jt.TrainConfig(features=8, n_iter=2, batch_size=4, crop=32,
                      compute_dtype="float32", log_every=1,
                      checkpoint_every=1000)


# one compiled JAX step a config, shared by the tests (XLA's compile of
# the step is most of their time)
jax_step = functools.lru_cache(jt.make_train_step)


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_conv():
    """A process's first CPU conv may sum in another order than the next
    ones (7e-6 of the zero-reference loss, whose TV term weighs 1600): one
    runs before the comparisons."""
    torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                               torch.ones(4, 3, 3, 3), padding=1)


def port_cfg(jcfg, **kw):
    return tt.TrainConfig(**{**dataclasses.asdict(jcfg), **kw})


def lows(seed=0, n=4):
    u8, _ = synth_batch(n, TINY.crop, TINY.crop, seed=seed)
    return (u8.astype(np.float32) / 255.0).transpose(0, 3, 1, 2).copy()


def carried_state(jcfg):
    """JAX's initial params and optimizer state, and the port's from the
    same weights."""
    jp, jo = jt.init_train_state(jcfg)
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    return jp, jo, pp, tt.make_optimizer(port_cfg(jcfg)).init(pp)


def assert_params_close(port, jax_params, **tol):
    tol = tol or dict(atol=PARAM_ATOL, rtol=PARAM_RTOL)
    got = params_to_numpy(port)
    for name, layer in got.items():
        for k, v in layer.items():
            np.testing.assert_allclose(v, np.asarray(jax_params[name][k]),
                                       err_msg=f"{name}.{k}", **tol)


def test_three_adamw_steps_match_jax():
    jp, jo, pp, po = carried_state(TINY)
    jstep, pstep = jax_step(TINY), tt.make_train_step(port_cfg(TINY))
    for i in range(3):
        x = lows(seed=i)
        jp, jo, jm = jstep(jp, jo, jnp.asarray(x))
        pp, po, pm = pstep(pp, po, torch.from_numpy(x))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
    assert int(po["count"]) == 3
    assert_params_close(pp, jp)


def test_adamw_update_is_optax():
    """The optimizer alone on the same gradients, three updates: optax's
    adamw arithmetic (params, both moments, the count) within float32
    rounding."""
    import optax

    rng = np.random.default_rng(4)
    p0 = {"c1": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                 "b": np.zeros(4, np.float32)}}
    grads = [{"c1": {"w": rng.normal(size=(3, 3, 2, 4)).astype(np.float32),
                     "b": rng.normal(size=4).astype(np.float32)}}
             for _ in range(3)]
    opt = optax.adamw(TINY.learning_rate, weight_decay=TINY.weight_decay)
    jp, js = p0, opt.init(p0)
    pp = params_from_numpy(p0)
    adamw = tt.make_optimizer(port_cfg(TINY))
    ps = adamw.init(pp)
    for g in grads:
        upd, js = opt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        pp, ps = adamw.update(tt._leaves(params_from_numpy(g)), ps, pp)
    tol = dict(rtol=1e-6, atol=1e-9)
    assert_params_close(pp, jp, **tol)
    assert_params_close(ps["mu"], js[0].mu, **tol)
    assert_params_close(ps["nu"], js[0].nu, **tol)
    assert int(ps["count"]) == int(js[0].count) == 3


def test_bf16_loss_matches_jax():
    jcfg = dataclasses.replace(TINY, compute_dtype="bfloat16")
    jp, _, pp, _ = carried_state(jcfg)
    x = lows()
    lj, _ = jt.zero_reference_loss(jp, jnp.asarray(x), jcfg)
    lt, _ = tt.zero_reference_loss(pp, torch.from_numpy(x), port_cfg(jcfg))
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-2)


def test_microbatch_equals_full_batch_and_jax():
    """Microbatch 2 of a batch of 4: the port's step equals its full-batch
    step within float32 rounding (the chunks' sums in another order), and
    JAX's microbatched step within the JAX tolerance."""
    mcfg = dataclasses.replace(TINY, microbatch=2)
    jp, jo, pp, po = carried_state(mcfg)
    x = lows()
    full_p, _, full_m = tt.make_train_step(port_cfg(TINY))(
        pp, po, torch.from_numpy(x))
    mb_p, mb_o, mb_m = tt.make_train_step(port_cfg(mcfg))(
        pp, po, torch.from_numpy(x))
    for k in full_m:
        np.testing.assert_allclose(float(mb_m[k]), float(full_m[k]),
                                   rtol=1e-6, err_msg=k)
    assert_params_close(mb_p, params_to_numpy(full_p), atol=1e-7, rtol=1e-6)
    jp1, _, jm = jax_step(mcfg)(jp, jo, jnp.asarray(x))
    np.testing.assert_allclose(float(mb_m["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    assert_params_close(mb_p, jp1)
    with pytest.raises(ValueError, match="not divisible by microbatch 3"):
        tt.make_train_step(port_cfg(TINY, microbatch=3))(
            pp, po, torch.from_numpy(x))


def test_remat_on_equals_off():
    """Recomputing the net's forward in the backward pass changes no
    value: the step's metrics and params are bit-equal."""
    _, _, pp, po = carried_state(TINY)
    x = torch.from_numpy(lows())
    outs = [tt.make_train_step(port_cfg(TINY, remat=r))(pp, po, x)
            for r in (True, False)]
    for k in outs[0][2]:
        assert float(outs[0][2][k]) == float(outs[1][2][k]), k
    for a, b in zip(tt._leaves(outs[0][0]), tt._leaves(outs[1][0])):
        assert torch.equal(a, b)


def fixed_stream(n_steps):
    """The same numpy batches for both loops, one a step from the start
    step (the loop's data factory contract)."""
    batches = [lows(seed=10 + i) for i in range(n_steps)]

    def factory(to_array):
        return lambda start: (to_array(b) for b in batches[start:])

    return factory


def test_training_loop_matches_jax_with_ema():
    jcfg = dataclasses.replace(TINY, steps=3, ema_decay=0.5)
    jp, jo, pp, po = carried_state(jcfg)
    factory = fixed_stream(3)
    # the step does not read steps or ema_decay: TINY's compiled step
    jparams, jhist = jt._run_training_loop(
        jcfg, jp, jo, lambda c, mesh: jax_step(TINY), factory(jnp.asarray),
        None, None, False, None)
    pparams, phist = tt._run_training_loop(
        port_cfg(jcfg), pp, po, tt.make_train_step,
        factory(torch.from_numpy), None, None, False, None)
    assert [h["step"] for h in phist] == [h["step"] for h in jhist]
    np.testing.assert_allclose([h["loss"] for h in phist],
                               [h["loss"] for h in jhist], rtol=1e-5)
    assert_params_close(pparams, jparams)


def test_early_stop_returns_best_snapshot():
    """eval_every 2, patience 2, a scripted metric that peaks at the third
    eval: the loop stops after the fifth (step 10 of 40) and returns the
    third's params."""
    tcfg = port_cfg(TINY, steps=40, eval_every=2, eval_patience=2,
                    log_every=50)
    scores = [0.1, 0.2, 0.3, 0.25, 0.2, 0.15, 0.1]
    calls = []

    def fake_eval(params):
        calls.append(params_to_numpy(params))
        return scores[len(calls) - 1]

    params, history = tt.train_curve_cnn(tcfg, eval_fn=fake_eval,
                                         device="cpu")
    assert len(calls) == 5
    assert [h["step"] for h in history if "eval_score" in h][-1] == 9
    assert [h["eval_score"] for h in history if "eval_score" in h] == \
        scores[:5]
    got = params_to_numpy(params)
    for name, layer in calls[2].items():
        for k, v in layer.items():
            np.testing.assert_array_equal(got[name][k], v)


def test_resume_equals_straight_run(tmp_path):
    """2 steps, then a resume to 4, equal a straight 4-step run (params,
    EMA and optimizer state restored, the stream offset by the restored
    step), bit for bit on the CPU; and the EMA flag may change across a
    resume both ways."""
    base = port_cfg(TINY, steps=4, checkpoint_every=2, ema_decay=0.5,
                    batch_size=2)
    straight, _ = tt.train_fcn(base, seed=3, device="cpu")
    ck = str(tmp_path / "ck")
    tt.train_fcn(dataclasses.replace(base, steps=2), seed=3, device="cpu",
                 checkpoint_dir=ck)
    resumed, hist = tt.train_fcn(base, seed=3, device="cpu",
                                 checkpoint_dir=ck, resume=True)
    assert hist[0]["step"] == 2
    for a, b in zip(tt._leaves(resumed), tt._leaves(straight)):
        assert torch.equal(a, b)

    one = dataclasses.replace(base, steps=1, checkpoint_every=1)
    for first, then in ((None, 0.9), (0.9, None)):
        d = str(tmp_path / f"drift{first}")
        tt.train_fcn(dataclasses.replace(one, ema_decay=first), seed=1,
                     device="cpu", checkpoint_dir=d)
        p, h = tt.train_fcn(dataclasses.replace(one, steps=2,
                                                ema_decay=then),
                            seed=1, device="cpu", checkpoint_dir=d,
                            resume=True)
        assert h[0]["step"] == 1
        assert all(torch.isfinite(t).all() for t in tt._leaves(p))


@pytest.mark.parametrize("trainer", ["paired_hybrid_tail", "decom_relit"])
def test_trainers_run_on_the_cpu(trainer):
    """The paired hybrid trainer (boosted inputs, the loss through the
    tail) and decom with the relit term, two steps on the default stream:
    finite losses, params changed."""
    tcfg = port_cfg(TINY, steps=2, batch_size=2, denoise_in_loss=True,
                    w_relit=1.0)
    if trainer == "paired_hybrid_tail":
        params, hist = tt.train_curve_cnn(tcfg, objective="paired",
                                          hybrid=True, device="cpu")
        init, _ = tt.init_train_state(tcfg, device="cpu")
    else:
        from low_light_image_enhancement_tpu_torch.models.decom import (
            init_decom_net,
        )

        params, hist = tt.train_decom(tcfg, device="cpu")
        init = init_decom_net(torch.Generator().manual_seed(0))
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    assert "relit_ssim" in hist[0] or trainer != "decom_relit"
    assert any(not torch.equal(a, b)
               for a, b in zip(tt._leaves(params), tt._leaves(init)))


def test_synth_stream_is_the_jax_one():
    """The default stream at a restored step: byte-equal batches."""
    tcfg = port_cfg(TINY, batch_size=2)
    it_j = jt._synth_planar_pairs(dataclasses.replace(TINY, batch_size=2),
                                  seed=4, start_step=3)
    it_t = tt._synth_planar_pairs(tcfg, seed=4, start_step=3, device="cpu")
    for _ in range(2):
        (jl, jh), (tl, th) = next(it_j), next(it_t)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))


def test_mesh_and_cuda_rules():
    """A mesh step takes a parallel.Mesh (tests/test_torch_train_parallel.py
    holds it to the JAX package's); spatial_batch without a mesh is the
    unsharded step, as in the JAX package."""
    from low_light_image_enhancement_tpu_torch.parallel import make_mesh

    x = torch.from_numpy(lows())
    _, _, pp, po = carried_state(TINY)
    ref = tt.make_paired_curve_train_step(port_cfg(TINY))(pp, po, x, x)
    got = tt.make_paired_curve_train_step(port_cfg(TINY),
                                          spatial_batch=True)(pp, po, x, x)
    assert float(got[2]["loss"]) == float(ref[2]["loss"])
    mesh = make_mesh(2, 1, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="not divisible"):
        tt.make_train_step(port_cfg(TINY), mesh=mesh)(pp, po, x[:3])
    if torch.cuda.is_available():
        pytest.skip("the card is there: chip_smoke.py phase 7 trains on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.init_train_state(port_cfg(TINY))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tt.train_fcn(port_cfg(TINY, steps=1))
