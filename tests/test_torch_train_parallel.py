"""The port's data-parallel and row-sharded training steps on a CPU mesh
(the CPU device repeated), against the port's unsharded step and the JAX
package's mesh steps on its eight fake CPU devices, from the same weights
and batches; and data parallelism across two processes (gloo).

Bars: the loss within 1e-6 relative; the parameters after the step within
1e-5 of the reference in the whole vector's L2 norm, relative (AdamW sizes
each element's step by its own gradient's history, so an element whose
gradient nearly cancels moves by a good part of the learning rate on a
rounding: PERF.md §6), float32 nets.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from low_light_image_enhancement_tpu import parallel as jpar
from low_light_image_enhancement_tpu import train as jt
from low_light_image_enhancement_tpu.data.synth import synth_batch
from low_light_image_enhancement_tpu_torch import parallel as tpar
from low_light_image_enhancement_tpu_torch import train as tt
from low_light_image_enhancement_tpu_torch.models.weights import (
    params_from_numpy,
    params_to_numpy,
)

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
LOSS_REL, PARAMS_REL = 1e-6, 1e-5

TINY = jt.TrainConfig(features=8, n_iter=2, batch_size=4, crop=32,
                      compute_dtype="float32")


@pytest.fixture(autouse=True, scope="module")
def _warm_cpu_conv():
    """A process's first CPU conv may sum in another order than the next
    ones (tests/test_torch_train_step.py): one runs first."""
    torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                               torch.ones(4, 3, 3, 3), padding=1)


def cpu_mesh(n_data, n_spatial):
    return tpar.make_mesh(n_data, n_spatial, [CPU] * (n_data * n_spatial))


def port_cfg(jcfg):
    return tt.TrainConfig(**dataclasses.asdict(jcfg))


def lows(n=4, crop=32, seed=0):
    u8, _ = synth_batch(n, crop, crop, seed=seed)
    return (u8.astype(np.float32) / 255.0).transpose(0, 3, 1, 2).copy()


def flat(params) -> np.ndarray:
    """The parameter vector, float64, the port's leaf order (the JAX
    package's params are carried into that order first)."""
    if not isinstance(next(iter(params["c1"].values())), torch.Tensor):
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          params))
    return np.concatenate([t.detach().double().numpy().ravel()
                           for t in tt._leaves(params)])


def assert_step_close(got, want, what):
    (gp, gm), (wp, wm) = got, want
    loss_rel = abs(float(gm["loss"]) - float(wm["loss"])) / abs(
        float(wm["loss"]))
    g, w = flat(gp), flat(wp)
    params_rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert loss_rel <= LOSS_REL and params_rel <= PARAMS_REL, (
        what, loss_rel, params_rel)


def carried(jcfg):
    """The port's initial state and the JAX package's from its weights
    (the JAX package's own init draws through jax.random eagerly, ~10 s on
    the CPU)."""
    pp, po = tt.init_train_state(port_cfg(jcfg), device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(pp))
    return jp, jt.make_optimizer(jcfg).init(jp), pp, po


@pytest.mark.parametrize("n_data", [2, 4])
def test_data_parallel_step_matches_unsharded_and_jax(n_data):
    """make_train_step(tcfg, mesh): the batch split over an (n, 1) mesh,
    the parameters replicated, each shard's gradients weighted by its share
    and summed, one AdamW update; against the unsharded step and the JAX
    package's make_train_step(tcfg, mesh) on n fake devices."""
    jp, jo, pp, po = carried(TINY)
    x = lows()
    tcfg = port_cfg(TINY)
    p_ref, _, m_ref = tt.make_train_step(tcfg)(pp, po, torch.from_numpy(x))
    p_dp, o_dp, m_dp = tt.make_train_step(tcfg, cpu_mesh(n_data, 1))(
        pp, po, torch.from_numpy(x))
    assert int(o_dp["count"]) == 1 and set(m_dp) == set(m_ref)
    assert_step_close((p_dp, m_dp), (p_ref, m_ref), "unsharded")
    jmesh = jpar.make_mesh(n_data=n_data, n_spatial=1)
    jp2, _, jm = jt.make_train_step(TINY, jmesh)(jp, jo, jnp.asarray(x))
    assert_step_close((p_dp, m_dp), (jp2, jm), "jax")


def test_row_sharded_paired_step_matches_unsharded_and_jax():
    """make_paired_curve_train_step(tcfg, mesh, spatial_batch=True) on a
    (2, 4) mesh: the 32-row crop in 4 row shards of 8 (the boundaries at
    rows 8 and 24 fall inside 16-row exposure patches and SSIM windows),
    the batch over data; against the unsharded step and the JAX package's
    spatial_batch step (tests/parallel/test_dp_scaling.py's case)."""
    jcfg = dataclasses.replace(TINY, batch_size=2, steps=1)
    rng = np.random.default_rng(0)
    low = rng.random((2, 3, 32, 32), np.float32) * 0.4
    high = np.clip(low * 2.5, 0.0, 1.0)
    jp, jo, pp, po = carried(jcfg)
    tcfg = port_cfg(jcfg)
    args = (torch.from_numpy(low), torch.from_numpy(high))
    ref = tt.make_paired_curve_train_step(tcfg)(pp, po, *args)
    got = tt.make_paired_curve_train_step(tcfg, cpu_mesh(2, 4),
                                          spatial_batch=True)(pp, po, *args)
    assert_step_close(got[::2], ref[::2], "unsharded")
    jgot = jt.make_paired_curve_train_step(
        jcfg, jpar.make_mesh(n_data=2, n_spatial=4), spatial_batch=True)(
        jp, jo, jnp.asarray(low), jnp.asarray(high))
    assert_step_close(got[::2], jgot[::2], "jax")


def test_mesh_step_rules():
    """A batch that does not divide over the mesh raises, as do crop rows
    that do not divide over the spatial axis."""
    _, _, pp, po = carried(TINY)
    tcfg = port_cfg(TINY)
    x = torch.from_numpy(lows())
    with pytest.raises(ValueError, match="not divisible"):
        tt.make_train_step(tcfg, cpu_mesh(3, 1))(pp, po, x)
    with pytest.raises(ValueError, match="crop rows 30"):
        tt.make_train_step(tcfg, cpu_mesh(1, 4), spatial_batch=True)(
            pp, po, x[..., :30, :])
    with pytest.raises(ValueError, match="data axis"):
        tt.make_train_step(tcfg, cpu_mesh(3, 1), spatial_batch=True)(
            pp, po, x)


_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    from low_light_image_enhancement_tpu_torch import train as tt
    from low_light_image_enhancement_tpu_torch.parallel import make_mesh
    from low_light_image_enhancement_tpu_torch.parallel.distributed import (
        global_batch_from_local, initialize_distributed)
    pid, init = int(sys.argv[1]), sys.argv[2]
    initialize_distributed(init, num_processes=2, process_id=pid,
                           device="cpu")
    torch.nn.functional.conv2d(torch.ones(1, 3, 8, 8),
                               torch.ones(4, 3, 3, 3), padding=1)
    try:
        make_mesh(1, 2)
        raise SystemExit("a mesh past this process's devices did not raise")
    except ValueError as e:
        assert "halos across processes" in str(e), e
    mesh = make_mesh(1, 1, ["cpu"])
    tcfg = tt.TrainConfig(features=8, n_iter=2, batch_size=4, crop=32,
                          compute_dtype="float32")
    params, opt = tt.init_train_state(tcfg, seed=0, device="cpu")
    full = np.load(sys.argv[3])
    batch = global_batch_from_local(mesh, full[2 * pid:2 * pid + 2])
    params, opt, m = tt.make_train_step(tcfg, mesh)(params, opt, batch)
    vec = torch.cat([t.reshape(-1) for t in tt._leaves(params)])
    np.save(sys.argv[4], vec.numpy())
    print(f"RESULT {pid} {float(m['loss']).hex()}", flush=True)
""")


def test_two_process_data_parallel_step(tmp_path):
    """Two processes (gloo), each stepping its half of the batch through a
    one-device mesh: the step all-reduces the gradients and metrics over
    the group, so both report the same loss and parameters, equal to one
    process stepping the whole batch."""
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    batch = tmp_path / "batch.npy"
    np.save(batch, lows())
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
              "LOCAL_RANK"):
        env.pop(k, None)
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), init, str(batch),
         str(tmp_path / f"params{pid}.npy")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    losses = {}
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out[-3000:]
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, loss = line.split()
                losses[pid] = float.fromhex(loss)
    assert set(losses) == {"0", "1"}, outs
    vecs = [np.load(tmp_path / f"params{pid}.npy") for pid in range(2)]
    assert losses["0"] == losses["1"]
    np.testing.assert_array_equal(vecs[0], vecs[1])
    tcfg = port_cfg(TINY)
    params, opt = tt.init_train_state(tcfg, seed=0, device="cpu")
    p_ref, _, m_ref = tt.make_train_step(tcfg)(params, opt,
                                               torch.from_numpy(lows()))
    assert abs(losses["0"] - float(m_ref["loss"])) <= LOSS_REL * abs(
        float(m_ref["loss"]))
    w = flat(p_ref)
    assert np.linalg.norm(vecs[0] - w) / np.linalg.norm(w) <= PARAMS_REL
