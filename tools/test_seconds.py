#!/usr/bin/env python3
"""Where the CPU test run's time goes: junit worker-seconds by file, the
port's files (``tests/test_torch_*.py``) apart from the others, and, with
the plugin, the XLA compiles each test made.

Summarise a junit file of the tier-1 command (ROADMAP.md, "Tier-1
verify"; add ``--durations=0`` to see the slowest in the log too)::

    python3 tools/test_seconds.py run.xml [compile_dir]

It prints the port's and the other files' summed junit seconds and test
counts, the slowest files and the slowest tests. As a pytest plugin it
records, for every test, the XLA compiles JAX made while it ran
(``jax.monitoring``'s backend-compile durations), one JSON file a worker
in ``$LLIE_COMPILE_STATS_DIR``; given that directory, the summary adds
the compiles and their seconds beside each test::

    LLIE_COMPILE_STATS_DIR=build/compile_stats PYTHONPATH=tools \\
        python -m pytest tests/test_torch_*.py -p test_seconds -n 6 \\
        --dist loadfile --junitxml=build/run.xml
"""

from __future__ import annotations

import collections
import json
import os
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

PORT_PREFIX = "tests.test_torch_"


def _node_id(case) -> str:
    return case.get("classname").replace(".", "/") + ".py::" + case.get(
        "name")


def summarise(xml_path: str, compile_dir=None, top: int = 12) -> None:
    root = ET.parse(xml_path).getroot()
    files, counts = collections.Counter(), collections.Counter()
    tests = []
    for case in root.iter("testcase"):
        seconds = float(case.get("time") or 0.0)
        files[case.get("classname")] += seconds
        counts[case.get("classname")] += 1
        tests.append((seconds, _node_id(case)))
    compiles = {}
    if compile_dir:
        for path in Path(compile_dir).glob("*.json"):
            compiles.update(json.loads(path.read_text()))
    for label, mine in (("port", True), ("other", False)):
        names = [f for f in files if f.startswith(PORT_PREFIX) == mine]
        print(f"{label}: {sum(files[f] for f in names):.1f} worker-seconds, "
              f"{sum(counts[f] for f in names)} tests, {len(names)} files")
    print("slowest files:")
    for name, seconds in files.most_common(top):
        print(f"  {seconds:8.1f} s {counts[name]:4d} tests  {name}")
    print("slowest tests:")
    for seconds, node in sorted(tests, reverse=True)[:top]:
        n, s = compiles.get(node, (0, 0.0))
        extra = f"  ({n} compiles, {s:.1f} s)" if compile_dir else ""
        print(f"  {seconds:8.1f} s  {node}{extra}")
    if compiles:
        n = sum(v[0] for v in compiles.values())
        s = sum(v[1] for v in compiles.values())
        print(f"XLA compiles: {n}, {s:.1f} s in all")


# ------------------------------------------------------- pytest plugin #

_CURRENT = {"node": None}
_STATS = collections.defaultdict(lambda: [0, 0.0])


def _on_duration(event: str, seconds: float, **_) -> None:
    node = _CURRENT["node"]
    if node is not None and event.endswith("backend_compile_duration"):
        _STATS[node][0] += 1
        _STATS[node][1] += seconds


def pytest_configure(config) -> None:
    from jax import monitoring

    monitoring.register_event_duration_secs_listener(_on_duration)


def pytest_runtest_protocol(item, nextitem):
    _CURRENT["node"] = item.nodeid


def pytest_runtest_logfinish(nodeid, location) -> None:
    _CURRENT["node"] = None
    out = os.environ.get("LLIE_COMPILE_STATS_DIR")
    if out:
        os.makedirs(out, exist_ok=True)
        Path(out, f"compiles_{os.getpid()}.json").write_text(
            json.dumps(_STATS))


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    summarise(sys.argv[1], sys.argv[2] if len(sys.argv) > 2 else None)
