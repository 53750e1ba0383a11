"""The comparison that decides ``correct`` has been shown to fail: the
control (the reference one step below the configuration's precision, in
the program's place) fails the limits, and so does a run of the harness
with the program broken underneath, once for each fault an enhancement
cell can have. The program's own plain versions pass. On the CPU at small
sizes; ``test_portbench_card.py`` repeats the control at the cells' own
sizes on a card."""

from pathlib import Path

import pytest

from portbench import calibrate, check, harness, spec

ROOT = Path(__file__).resolve().parents[1]
# the serving mix is kept for a later cell (PERF.md section 7)
SERVE = "zero_dce.serve_over_600x400"
CELLS = ["retinex.b48_600x400", "zero_dce.b48_600x400", SERVE,
         "retinex.b8_2160x3840"]
SMALL = {"batch_closed": dict(batch=3, height=48, width=72, pool=2,
                              sample_steps=3),
         "serve_open": dict(height=48, width=72, pool=4, rate_per_s=30,
                            sample_requests=1000, drain_s=30)}
# the control's widest gap needs some 10^5 values to show: at 48 x 72 it
# can read 2 on a seed
CONTROL = {"batch_closed": dict(batch=4, height=120, width=176, pool=2),
           "serve_open": dict(height=120, width=176, pool=6)}


def small(name, sizes=SMALL):
    c = (spec.kept_cell(ROOT, *name.split(".", 1)) if name == SERVE
         else spec.cell(ROOT, name))
    c.traffic.update(sizes[c.traffic["loop"]])
    return c


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_and_program_passes(name):
    c = small(name, CONTROL)
    for seed in (21, 2**31 + 22):
        r = calibrate.readings(c, seed, "cpu")
        assert not check.passes(r["control"], c.config["limits"]), r
        if "program" in r:
            assert check.passes(r["program"], c.config["limits"]), r


class Broken:
    """The pipeline with its device call broken after it runs."""

    def __init__(self, pipe, fault):
        self._pipe, self._fault = pipe, fault

    def __getattr__(self, name):
        return getattr(self._pipe, name)

    def enhance_batch_device(self, x):
        return self._fault(x, self._pipe.enhance_batch_device(x))


def unchanged(x, y):
    """The step hands its input back: no enhancement."""
    return x.clone()


def half_left_out(x, y):
    """The second half of the batch (of a batch of one, of its rows) is
    never computed."""
    y = y.clone()
    if y.shape[0] > 1:
        y[y.shape[0] // 2:] = 0
    else:
        y[:, y.shape[1] // 2:] = 0
    return y


def one_answer_altered(x, y):
    """The first answer of every call comes out wrong."""
    y = y.clone()
    y[0] = 255 - y[0]
    return y


@pytest.mark.parametrize("name", ["retinex.b48_600x400",
                                  "zero_dce.b48_600x400", SERVE])
@pytest.mark.parametrize("fault", [None, unchanged, half_left_out,
                                   one_answer_altered])
def test_a_broken_program_is_not_correct(name, fault):
    c = small(name)
    hook = None if fault is None else (lambda p: Broken(p, fault))
    out = harness.run_cell(c, 2**31 + 31, 0.5, False, device="cpu",
                           hook=hook)
    assert out["correct"] is (fault is None), out["checks"]
    assert out["attempted"] > 0


def test_answers_that_never_come_are_not_correct(monkeypatch):
    """Every device call in the window fails: no request is answered."""
    c = small(SERVE)
    window = []
    monkeypatch.setattr(harness.Context, "begin_window",
                        lambda self: window.append(True))

    def lost(x, y):
        if window:
            raise RuntimeError("the device call was lost")
        return y

    out = harness.run_cell(c, 41, 0.5, False, device="cpu",
                           hook=lambda p: Broken(p, lost))
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] > 0
    assert out["checks"]["missing_answers"]["value"] > 0
