"""Where the server's dispatcher spends its batches, from the program's
own spans in a traced run of a serving mix: for each step of a batch
(``serve.stack``, ``serve.copy_in``, ``serve.run``, ``serve.copy_out``,
``serve.resolve``) its count, milliseconds a batch and share of the
dispatcher's ``serve.batch`` time. One traced run a rate:

    python3 -m portbench.serve_split --config <config> --traffic <mix> \\
        --rate <r> --seed <n> --seconds <s>

prints one JSON line: the split under ``steps``, the three kept serve
readers and ``sweep.summary``'s latencies and backlog. Compare two
processes at one rate to see which step varies between them."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from portbench import harness, program_spans, spec, sweep

STEPS = ("serve.stack", "serve.copy_in", "serve.run", "serve.copy_out",
         "serve.resolve")
READERS = ("serve_queue_wait_p95_ms", "serve_fill_pct",
           "device_idle_pct.serve_host")


def read(run):
    """{step: {"n", "ms_each", "pct_of_batches"}} over the run's window;
    None where the program recorded no batch span there."""
    spans = program_spans.window(run, "serve.batch", *STEPS)
    if not spans:
        return None
    batch_s = sum(s.end - s.start for s in spans if s.name == "serve.batch")
    if batch_s <= 0:
        return None
    out = {}
    for step in STEPS:
        took = [s.end - s.start for s in spans if s.name == step]
        if took:
            out[step] = {"n": len(took),
                         "ms_each": 1e3 * sum(took) / len(took),
                         "pct_of_batches": 100.0 * sum(took) / batch_s}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.serve_split")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    c = spec.kept_cell(Path.cwd(), args.config, args.traffic)
    c.traffic["rate_per_s"] = args.rate
    run, _, _ = harness.execute(c, args.seed, args.seconds, True)
    out = {"rate_per_s": args.rate, "seed": args.seed, "steps": read(run)}
    out.update({name: spec.reader(c.root, name)(run) for name in READERS})
    out["summary"] = sweep.summary(run, c.root)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
