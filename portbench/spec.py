"""Finds a cell's parts by name: ``BENCHMARK.json`` at the root names the
cell's configuration (its file) and traffic mix; the mix is
``portbench/traffic/<traffic>.json`` and names its loop,
``portbench/loops/<loop>.py``; the configuration names its reference,
``portbench/reference/<reference>.py``; each metric is read by
``portbench/metrics/<metric>.py``. A new cell, configuration, mix or
metric is added by adding files and entries, without editing one."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

PACKAGE = Path(__file__).resolve().parent


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    root: Path
    config_name: str
    config: dict            # the configuration's file
    traffic_name: str
    traffic: dict           # the traffic mix's file
    end_to_end: List[dict]  # the metrics this cell reports, with --trace 0
    per_layer: List[dict]   # and with --trace 1


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(root, name: str) -> Cell:
    """The cell ``name`` of the benchmark at ``root``."""
    root = Path(root)
    bench = load_benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    return _compose(root, bench, name, w["config"], w["traffic"],
                    w["chips"])


def kept_cell(root, config: str, traffic: str) -> Cell:
    """A cell that ``BENCHMARK.json`` does not list: the configuration
    ``config`` under the mix ``portbench/traffic/<traffic>.json``, on one
    chip, reporting the metrics that name no workloads. A mix kept for a
    later cell runs so (``sweep``, the tests)."""
    root = Path(root)
    return _compose(root, load_benchmark(root), f"{config}.{traffic}",
                    config, traffic, 1)


def _compose(root: Path, bench: dict, name: str, config: str, traffic: str,
             chips: int) -> Cell:
    conf = {c["name"]: c for c in bench["configs"]}[config]
    return Cell(
        name=name, chips=chips, root=root,
        config_name=conf["name"],
        config=json.loads((root / conf["file"]).read_text()),
        traffic_name=traffic,
        traffic=json.loads((root / "portbench" / "traffic"
                            / f"{traffic}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)],
    )


def loop(name: str):
    """The traffic loop ``portbench/loops/<name>.py``."""
    return importlib.import_module(f"portbench.loops.{name}")


def reference(name: str):
    """The plain reference ``portbench/reference/<name>.py``."""
    return importlib.import_module(f"portbench.reference.{name}")


def reader(root: Path, metric: str) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py`` (a metric's name may
    hold dots, so the file is loaded by its path)."""
    path = Path(root) / "portbench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(c: Cell, trace: bool) -> Dict[str, dict]:
    """The metrics a run of ``c`` reports, by name."""
    return {m["name"]: m for m in (c.per_layer if trace else c.end_to_end)}
