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
halo raise in both processes."""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

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
    """
)


def test_two_process_spatial_halos_cross_processes(tmp_path):
    script = tmp_path / "spatial_worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    rendezvous = (tmp_path / "rendezvous").as_uri()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), rendezvous],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out, p in zip(outs, procs):
        assert p.returncode == 0, out[-3000:]
        assert any(line.startswith("SPATIAL-OK")
                   for line in out.splitlines()), out[-3000:]
        assert out.count("raised as it should") == 2, out[-3000:]
