"""Readings the limits of ``correct`` are set from, for one cell at its
own size, on many seeds in one process: the control's numbers (the
reference one step below the configuration's precision, in the program's
place) and, for a cell whose loop calls ``enhance_batch_device`` itself,
the program's numbers on the same inputs the window would send.

    python3 -m portbench.calibrate --workload <name> --seeds 1 2 3 ...

One JSON line a seed on standard output."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from portbench import check, harness, spec


def readings(c: spec.Cell, seed: int, device) -> dict:
    """The control's numbers and, where the loop is ``batch_closed``, the
    program's, for one seed."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    pipe, params = harness.build_pipeline(c, gen, device)
    ctx = harness.Context(pipe, c.traffic, seed, 0.0, device, gen)
    refs = spec.loop(c.traffic["loop"]).reference_inputs(ctx)
    got_ctl, got_prog = [], []
    for x, (h, w) in refs.values():
        want = check.reference_outputs(c.config, x, params)[:, :h, :w]
        got_ctl.append((check.reference_outputs(c.config, x, params,
                                                control=True)[:, :h, :w],
                        want))
        if c.traffic["loop"] == "batch_closed":
            with torch.inference_mode():
                got_prog.append((pipe.enhance_batch_device(x)[:, :h, :w],
                                 want))
    out = {"seed": seed, "control": check.tally(got_ctl)}
    if got_prog:
        out["program"] = check.tally(got_prog)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    c = spec.cell(Path.cwd(), args.workload)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA device", file=sys.stderr)
        return 2
    for s in args.seeds:
        r = readings(c, s, "cuda")
        r["workload"] = args.workload
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
