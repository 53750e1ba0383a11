"""Halos across processes: two gloo processes on the CPU form a process
group, each drives 4 spatial shards of an 8-shard mesh
(``make_mesh(1, 8, [cpu] * 4)``) and passes its own rows of the image to
``enhance_spatial_sharded``; the halo rows at the seam between the two
cross the group (``parallel.halo.exchange_seams``). Each process's output
must equal its rows of the port's single-process 8-shard output, Δ 0, for
retinex (K1's canvas form a shard) and curve (the net with
``blocks.learned_halo`` as its halo, then K3), u8 and f32, at 64x96 b2 as
the JAX package's two-process test (``tests/parallel/test_multiprocess.py``)
runs them. A split the geometry does not give and a block shorter than the
halo raise in both processes. The per-shard ``halo_pad_local``: eight gloo
processes, one shard of an 8-shard mesh each, equal to ``halo_pad``'s rows
for that shard and to the JAX package's ``halo_pad_local`` on its eight
fake CPU devices, Δ 0."""

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
from jax import shard_map
from jax.sharding import PartitionSpec as P

from low_light_image_enhancement_tpu.parallel import halo_pad_local
from low_light_image_enhancement_tpu.parallel import make_mesh as jmake_mesh
from low_light_image_enhancement_tpu_torch.parallel import halo

# one CPU thread a test worker: the tier-1 run's workers share the cores
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, rendezvous = int(sys.argv[1]), sys.argv[2]
    from low_light_image_enhancement_tpu_torch.config import PipelineConfig
    from low_light_image_enhancement_tpu_torch.core import illumination_boost
    from low_light_image_enhancement_tpu_torch.parallel import (
        enhance_spatial_sharded, make_mesh)
    from low_light_image_enhancement_tpu_torch.parallel.distributed import (
        initialize_distributed, process_group_size)
    from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline

    initialize_distributed(rendezvous, num_processes=2, process_id=pid,
                           device="cpu")
    assert process_group_size() == 2
    # a process's first boost and conv on the CPU can round apart from the
    # next ones: run one of each before the outputs held to Δ 0
    illumination_boost(torch.rand(1, 3, 16, 16), PipelineConfig())
    torch.nn.functional.conv2d(torch.rand(1, 3, 8, 8), torch.rand(4, 3, 3, 3))
    mesh = make_mesh(1, 8, ["cpu"] * 4)
    assert mesh.shape == {"data": 1, "spatial": 8} and mesh.processes == 2
    single = make_mesh(1, 8, ["cpu"] * 8)
    h, w = 64, 96
    full = np.random.default_rng(7).random((2, 3, h, w)).astype(np.float32)
    mine = slice(pid * 32, (pid + 1) * 32)
    for method in ("retinex", "curve"):
        cfg = PipelineConfig(method=method, compute_dtype="float32")
        params = (None if method == "retinex"
                  else EnhancePipeline._default_params(cfg, 0))
        for x in (torch.from_numpy(full),
                  torch.from_numpy(np.round(full * 255).astype(np.uint8))):
            got = enhance_spatial_sharded(x[:, :, mine], cfg, mesh, params)
            want = enhance_spatial_sharded(x, cfg, single, params)
            assert got.dtype == x.dtype and got.shape == (2, 3, 32, w)
            assert torch.equal(got, want[:, :, mine]), (method, x.dtype)
    # 30 + 34 rows: not the split of 8 shards of 8 rows; fcn's halo is
    # longer than a shard's 8 rows
    fcn = PipelineConfig(method="fcn")
    for rows, cfg, params in (
            ((30, 34), PipelineConfig(), None),
            ((32, 32), fcn, EnhancePipeline._default_params(fcn, 0))):
        try:
            enhance_spatial_sharded(torch.from_numpy(full[:, :, :rows[pid]]),
                                    cfg, mesh, params)
            raise SystemExit(f"{rows} {cfg.method} did not raise")
        except ValueError as e:
            print(f"raised as it should: {e}", flush=True)
    print(f"SPATIAL-OK {pid}", flush=True)
    # leave the group together: a process that exits with gloo's threads
    # up can abort in teardown (SIGABRT) after its work passed
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    """
)


def run_group(tmp_path, worker, n, *args):
    """``worker`` in ``n`` processes of one gloo group (rank, rendezvous,
    ``args``): their outputs, each process given 120 s."""
    script = tmp_path / "worker.py"
    script.write_text(worker)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    rendezvous = (tmp_path / "rendezvous").as_uri()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), rendezvous, *map(str, args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(n)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs, procs


def test_two_process_spatial_halos_cross_processes(tmp_path):
    outs, procs = run_group(tmp_path, _WORKER, 2)
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out[-3000:]
        assert any(line.startswith("SPATIAL-OK")
                   for line in out.splitlines()), out[-3000:]
        assert out.count("raised as it should") == 2, out[-3000:]


_HALO_WORKER = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    pid, rendezvous, src = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from low_light_image_enhancement_tpu_torch.parallel.distributed import (
        initialize_distributed)
    from low_light_image_enhancement_tpu_torch.parallel.halo import (
        halo_pad, halo_pad_local)

    initialize_distributed(rendezvous, num_processes=8, process_id=pid,
                           device="cpu")
    x = torch.from_numpy(np.load(src))
    shards = list(x.split(x.shape[-2] // 8, dim=-2))
    for m in (3, 8):
        got = halo_pad_local(shards[pid], m, pid, 8)
        assert torch.equal(got, halo_pad(shards, m)[pid]), m
        np.save(src.replace(".npy", f"_{pid}_{m}.npy"), got.numpy())
    print(f"HALO-OK {pid}", flush=True)
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    """
)


def test_halo_pad_local_eight_processes_match_halo_pad_and_jax(tmp_path):
    x = np.random.default_rng(5).random((2, 64, 16), np.float32)
    src = tmp_path / "x.npy"
    np.save(src, x)
    outs, procs = run_group(tmp_path, _HALO_WORKER, 8, src)
    for out, p in zip(outs, procs):
        assert p.returncode == 0 and "HALO-OK" in out, out[-3000:]
    mesh = jmake_mesh(n_data=1, n_spatial=8)
    for m in (3, 8):
        want = np.asarray(jax.jit(shard_map(
            lambda xl: halo_pad_local(xl, m, "spatial"), mesh=mesh,
            in_specs=P(None, "spatial", None),
            out_specs=P(None, "spatial", None)))(jnp.asarray(x)))
        want = want.reshape(2, 8, 8 + 2 * m, 16)
        for pid in range(8):
            got = np.load(tmp_path / f"x_{pid}_{m}.npy")
            np.testing.assert_array_equal(got, want[:, pid])


def test_halo_pad_local_one_shard_replicates_and_checks_its_place():
    x = torch.arange(2 * 5 * 4, dtype=torch.float32).reshape(2, 5, 4)
    np.testing.assert_array_equal(
        halo.halo_pad_local(x, 3, 0, 1).numpy(),
        np.pad(x.numpy(), ((0, 0), (3, 3), (0, 0)), mode="edge"))
    with pytest.raises(ValueError, match="shard 2 of 2"):
        halo.halo_pad_local(x, 3, 2, 2)
