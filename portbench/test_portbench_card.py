"""On a card: the control fails each cell's limits at the cell's own
size, and the program's timed entry passes them on the same inputs.
``python -m pytest portbench -m card`` on a machine with an NVIDIA card;
skipped elsewhere."""

from pathlib import Path

import pytest

from portbench import calibrate, check, spec

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in spec.load_benchmark(
    ROOT)["workloads"]])
def test_control_fails_at_the_cells_size(card, name):
    c = spec.cell(ROOT, name)
    r = calibrate.readings(c, 2**31 + 51, card)
    assert not check.passes(r["control"], c.config["limits"]), r
    if "program" in r:
        assert check.passes(r["program"], c.config["limits"]), r
