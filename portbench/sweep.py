"""The knee of a serving mix, found once when a cell is defined: one run
a rate (the configuration under the mix at ``--rate``), printing its
latencies, the backlog and, with ``--trace 1``, the device's idle share.

    python3 -m portbench.sweep --config <config> --traffic <mix> \\
        --rate <r> --seed <n> --seconds <s> [--trace 1]

The knee is the highest rate whose backlog does not grow over the window:
the requests outstanding at the window's end stay near those at its
middle, and the last quarter's latencies near the first's. Above it,
``served_per_s`` is the rate the server sustains."""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from portbench import harness, spec, stats


def outstanding(due, t):
    """Requests due by ``t`` and not yet answered at ``t``."""
    return sum(1 for d, lat in due if d <= t and (lat is None or d + lat > t))


def summary(run, root: Path) -> dict:
    r = run.record
    rate = run.traffic["rate_per_s"]
    seconds = r.attempted / rate
    due = list(zip(r.due, r.latencies))
    quarter = max(1, len(due) // 4)
    first = [lat for _, lat in due[:quarter] if lat is not None]
    last = [lat for _, lat in due[-quarter:] if lat is not None]
    out = {
        "rate_per_s": rate,
        "sent": r.attempted, "failed": r.failed,
        "p50_ms": 1e3 * stats.latency_quantile(r.latencies, 0.5, 1e9),
        "p95_ms": 1e3 * stats.latency_quantile(r.latencies, 0.95, 1e9),
        "backlog_mid": outstanding(due, r.t0 + seconds / 2),
        "backlog_end": outstanding(due, r.t0 + seconds),
        "first_quarter_mean_ms": 1e3 * sum(first) / max(len(first), 1),
        "last_quarter_mean_ms": 1e3 * sum(last) / max(len(last), 1),
        "batch_mean": (sum(r.launched) / len(r.launched)
                       if r.launched else None),
        "drain_s": r.t1 - (r.t0 + seconds),
        "served_per_s": spec.reader(root, "served_images_per_s")(run),
        "setup_parts": run.setup_parts,
    }
    busy = run.busy_s()
    if busy is not None:
        out["idle_pct"] = 100.0 * (1.0 - busy / run.window_s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.sweep")
    ap.add_argument("--config", required=True)
    ap.add_argument("--traffic", required=True)
    ap.add_argument("--rate", type=float, required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    c = spec.kept_cell(Path.cwd(), args.config, args.traffic)
    c.traffic["rate_per_s"] = args.rate
    run, _, _ = harness.execute(c, args.seed, args.seconds, bool(args.trace))
    print(json.dumps(summary(run, c.root)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
