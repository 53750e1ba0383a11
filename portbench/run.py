"""Runs one cell of the port's benchmark once and prints its result as the
last line of standard output:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout on a machine with an NVIDIA card. With
``--trace 0`` the line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the device's busy time from one
``torch.profiler`` session over the window; ``setup_parts`` gives the
seconds of each step of set-up. The numbers compared with the
plain reference are printed, each beside its limit, as the last lines of
standard error and under ``checks`` at the end of the result line.

Exits 2 without a result when there is no card or too few, and 3 when a
package of the JAX side was loaded."""

import time

T_START = time.perf_counter()   # before any import that takes time

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def process_age() -> float:
    """Seconds since this process started (its start time in
    ``/proc/self/stat``, clock ticks since boot)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    return time.clock_gettime(time.CLOCK_BOOTTIME) - started


try:
    PROCESS_T0 = T_START - process_age()
except OSError:
    PROCESS_T0 = T_START


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    marks = {"python": T_START}
    from portbench import harness, spec

    import torch

    marks["imports"] = time.perf_counter()
    c = spec.cell(Path.cwd(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        print(f"portbench: {args.workload} needs {c.chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    marks["cuda check"] = time.perf_counter()
    result = harness.run_cell(c, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t_start=PROCESS_T0,
                              marks=marks)
    found = harness.forbidden_modules(list(sys.modules))
    if found:
        print(f"portbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, v in result["checks"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
