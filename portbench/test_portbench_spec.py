"""Cells, configurations, mixes and metrics are found by name, and a new
cell comes from new files and an entry alone; a run's process loads
nothing of the JAX side."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, spec

ROOT = Path(__file__).resolve().parents[1]


def test_every_cell_resolves():
    bench = spec.load_benchmark(ROOT)
    names = [w["name"] for w in bench["workloads"]]
    assert len(names) == len(set(names))
    for name in names:
        c = spec.cell(ROOT, name)
        assert spec.loop(c.traffic["loop"]).run
        assert spec.reference(c.config["reference"]).enhance
        assert set(c.config["limits"]) <= {"max_du8", "mean_du8"}
        assert c.config["limits"]
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.per_layer
        for m in c.end_to_end + c.per_layer:
            assert callable(spec.reader(ROOT, m["name"]))
    for m in bench["per_layer"]:
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}


def test_a_new_cell_is_files_and_an_entry(tmp_path):
    """A copy of the benchmark gains a configuration, a mix, a metric and
    a cell by adding files and entries, and runs it."""
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = json.loads((ROOT / "portbench/configs/retinex.json").read_text())
    conf["pipeline"]["gamma"] = 0.6
    (tmp_path / "portbench/configs/retinex_g06.json").write_text(
        json.dumps(conf))
    (tmp_path / "portbench/traffic/b2_tiny.json").write_text(json.dumps(
        {"loop": "batch_closed", "batch": 2, "height": 24, "width": 40,
         "pool": 2, "ahead": 2, "sample_steps": 2}))
    (tmp_path / "portbench/metrics/steps_done.py").write_text(
        "def read(run):\n    return run.record.images / run.record.batch\n")
    bench["configs"].append({"name": "retinex_g06", "source": "x",
                             "file": "portbench/configs/retinex_g06.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "retinex_g06.b2_tiny",
                               "config": "retinex_g06", "traffic": "b2_tiny",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "steps_done", "unit": "steps",
                               "better": "higher", "source": "host_clock",
                               "layer": "pipeline", "moves": "images_per_s",
                               "workloads": ["retinex_g06.b2_tiny"]})
    bench["end_to_end"][0]["workloads"].append("retinex_g06.b2_tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    c = spec.cell(tmp_path, "retinex_g06.b2_tiny")
    assert c.config["pipeline"]["gamma"] == 0.6
    assert [m["name"] for m in c.per_layer] == ["steps_done"]
    out = harness.run_cell(c, 11, 0.2, False, device="cpu")
    assert out["correct"] is True
    assert set(out["metrics"]) == {"images_per_s", "setup_s"}
    assert out["metrics"]["images_per_s"]["value"] > 0
    parts = out["setup_parts"]
    assert list(parts) == ["device", "program", "inputs", "warm-up"]
    assert sum(parts.values()) == pytest.approx(
        out["metrics"]["setup_s"]["value"])
    r, _, _ = harness.execute(c, 11, 0.2, False, device="cpu")
    assert spec.reader(tmp_path, "steps_done")(r) >= 1


def test_a_kept_mix_runs_without_an_entry():
    """A mix that no workload names yet runs under a configuration, with
    the metrics that name no workloads."""
    c = spec.kept_cell(ROOT, "zero_dce", "serve_over_600x400")
    assert c.name == "zero_dce.serve_over_600x400" and c.chips == 1
    assert c.traffic["loop"] == "serve_open"
    assert [m["name"] for m in c.end_to_end] == ["setup_s"]
    assert c.per_layer == []
    with pytest.raises(KeyError):
        spec.cell(ROOT, c.name)


def test_forbidden_names_compare_whole_top_levels():
    assert harness.forbidden_modules(
        ["low_light_image_enhancement_tpu_torch.pipeline", "jaxtyping",
         "flaxen", "portbench.run"]) == []
    assert harness.forbidden_modules(
        ["jax.numpy", "jaxlib", "low_light_image_enhancement_tpu.config",
         "flax"]) == ["flax", "jax", "jaxlib",
                      "low_light_image_enhancement_tpu"]


def test_a_run_loads_nothing_of_the_jax_side():
    """A run of every loop, in a fresh process: no module whose top-level
    name is jax, jaxlib, flax or the JAX package."""
    code = """
import json, sys, torch
torch.set_num_threads(1)
from pathlib import Path
from portbench import harness, spec
for c, over in [
        (spec.cell(Path.cwd(), "zero_dce.b48_600x400"),
         dict(batch=2, height=24, width=40, pool=1, sample_steps=1)),
        (spec.kept_cell(Path.cwd(), "zero_dce", "serve_over_600x400"),
         dict(height=24, width=40, pool=2, rate_per_s=10, sample_requests=2,
              drain_s=20))]:
    c.traffic.update(over)
    assert harness.run_cell(c, 5, 0.3, False, device="cpu")["correct"]
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=240)
    assert p.returncode == 0, p.stderr[-2000:]
    top = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "low_light_image_enhancement_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_no_card_no_result():
    """Without CUDA the command exits non-zero and prints no result."""
    pytest.importorskip("torch")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "retinex.b48_600x400", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
