"""One run of one cell: set-up, the measured window (the cell's loop), the
check against the plain reference, the metrics, the result line.

The program is driven only through its public entries:
``PipelineConfig``, ``EnhancePipeline(..., model_params=...)`` and its
``enhance_batch_device``, and ``EnhanceServer(pipeline=...)``."""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from portbench import check, inputs, spec, stats
from portbench.trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "low_light_image_enhancement_tpu")
TOP_OPS = 10


def forbidden_modules(names: Sequence[str]) -> List[str]:
    """The forbidden packages among loaded modules, compared by whole
    top-level name (the part before the first dot)."""
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


@dataclasses.dataclass
class Context:
    """What a loop gets: the program, the cell's mix, the seed's generator,
    and the window's start and stop (which trace it in a traced run)."""

    pipeline: Any
    traffic: dict
    seed: int
    seconds: float
    device: torch.device
    gen: torch.Generator
    tracer: Optional[Tracer] = None
    # set-up's steps: name -> perf_counter when it ended (the loop adds
    # "inputs" once its inputs are made)
    marks: Dict[str, float] = dataclasses.field(default_factory=dict)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def begin_window(self) -> None:
        if self.tracer is not None:
            self.tracer.start()

    def end_window(self) -> None:
        if self.tracer is not None:
            self.tracer.stop()


@dataclasses.dataclass
class Record:
    """What a loop measured. Times are ``time.perf_counter`` seconds."""

    kind: str                         # "batch" or "serve"
    t0: float                         # the first timed dispatch
    t1: float                         # after the last output completed
    attempted: int                    # images (batch) or requests (serve)
    failed: int
    images: int                       # images completed in the window
    batch: int
    height: int
    width: int
    # the program's input as the reference takes it, and the crop of its
    # output that is compared: key -> ((B, H, W, 3) u8, (h, w))
    inputs: Dict[Any, Tuple[torch.Tensor, Tuple[int, int]]]
    samples: List[Tuple[Any, Any]]    # (inputs key, the program's output)
    spans: Dict[str, List[Tuple[float, float]]]
    span_order: Tuple[str, ...]       # names the idle gaps, first open wins
    span_rest: str                    # the name of a gap with none open
    latencies: List[Optional[float]] = dataclasses.field(
        default_factory=list)        # serve: seconds from due; None missed
    launched: List[int] = dataclasses.field(default_factory=list)
    due: List[float] = dataclasses.field(default_factory=list)  # serve
    close: float = 0.0                # serve: when the window closed
    missing: int = 0                  # sampled answers that never came


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""

    record: Record
    config: dict
    traffic: dict
    setup_s: float
    trace: Optional[Tracer]
    setup_parts: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return self.record.t1 - self.record.t0

    def busy_s(self) -> Optional[float]:
        if self.trace is None:
            return None
        return stats.busy([(a, b) for a, b, _ in self.trace.device_ops],
                          self.record.t0, self.record.t1)

    def idle_pct(self) -> Optional[float]:
        """The share of the window in which no device operation runs."""
        busy = self.busy_s()
        if busy is None:
            return None
        return 100.0 * (1.0 - busy / self.window_s)


def build_pipeline(c: spec.Cell, gen: torch.Generator, device):
    """The program under test, its weights drawn from ``gen`` on
    ``device``."""
    from low_light_image_enhancement_tpu_torch.config import PipelineConfig
    from low_light_image_enhancement_tpu_torch.pipeline import EnhancePipeline

    net = c.config.get("net")
    params = inputs.net_params(gen, net, device) if net else None
    pipe = EnhancePipeline(PipelineConfig(**c.config["pipeline"]),
                           model_params=params, device=device)
    return pipe, params


def breakdown(run: Run) -> dict:
    """The device operations that took most time in the window, and the
    idle gaps by the host span open at their midpoint."""
    r = run.record
    by_name: Dict[str, float] = {}
    for a, b, name in run.trace.device_ops:
        d = min(b, r.t1) - max(a, r.t0)
        if d > 0:
            by_name[name] = by_name.get(name, 0.0) + d
    idle = stats.name_gaps(
        stats.gaps([(a, b) for a, b, _ in run.trace.device_ops], r.t0, r.t1),
        r.spans, r.span_order, r.span_rest)

    def top(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:TOP_OPS]

    return {"device_ops": top(by_name), "idle_gaps": top(idle)}


def check_trace(run: Run) -> None:
    """Every device call of the window launches at least one operation: a
    trace with fewer lost some of its device events (torch's profiler can,
    PERF.md section 7), and its shares would read wrong."""
    r = run.record
    ops = sum(1 for a, b, _ in run.trace.device_ops if r.t0 <= a < r.t1)
    calls = len(r.spans.get("dispatch", ()))
    if ops < calls:
        raise RuntimeError(f"the trace holds {ops} device operations for "
                           f"{calls} device calls: device events were lost")


def execute(c: spec.Cell, seed: int, seconds: float, trace: bool,
            device="cuda", t_start: Optional[float] = None,
            hook: Optional[Callable] = None,
            marks: Optional[Dict[str, float]] = None):
    """Set-up and the window of one run of ``c``: (the run, the weights
    both sides were given, the device's peak allocation). ``t_start``: the
    process's start on the ``perf_counter`` clock (set-up is counted from
    it). ``hook`` wraps the program (a test's planted fault). ``marks``:
    set-up's steps before this call, by name, each at its end."""
    marks = dict(marks or {})
    if t_start is None:
        t_start = time.perf_counter()
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    torch.zeros(1, device=device).sum().item()
    marks["device"] = time.perf_counter()
    pipe, params = build_pipeline(c, gen, device)
    if hook is not None:
        pipe = hook(pipe)
    marks["program"] = time.perf_counter()
    tracer = Tracer() if trace else None
    ctx = Context(pipe, c.traffic, seed, seconds, device, gen, tracer,
                  marks)
    record = spec.loop(c.traffic["loop"]).run(ctx)
    marks["warm-up"] = record.t0
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del ctx, pipe
    if cuda:
        torch.cuda.empty_cache()
    parts, t = {}, t_start
    for name, at in sorted(marks.items(), key=lambda kv: kv[1]):
        parts[name], t = at - t, at
    return Run(record, c.config, c.traffic, record.t0 - t_start,
               tracer, parts), params, peak


def run_cell(c: spec.Cell, seed: int, seconds: float, trace: bool,
             device="cuda", t_start: Optional[float] = None,
             hook: Optional[Callable] = None,
             marks: Optional[Dict[str, float]] = None) -> dict:
    """Runs ``c`` once (``execute``), then the check against the reference
    and the metrics; returns the result line as a dict."""
    device = torch.device(device)
    run, params, peak = execute(c, seed, seconds, trace, device, t_start,
                                hook, marks)
    record = run.record
    cuda = device.type == "cuda"
    if trace:
        check_trace(run)
    numbers = check.compare(record, c.config, params)
    limits = c.config["limits"]
    correct = record.missing == 0 and check.passes(numbers, limits)

    metrics = {}
    for name, m in spec.readers(c, trace).items():
        value = spec.reader(c.root, name)(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": record.attempted,
           "failed": record.failed, "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = run.busy_s()
        dev["window_s"] = run.window_s
        out["breakdown"] = breakdown(run)
    out["setup_parts"] = run.setup_parts
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    if record.missing:
        out["checks"]["missing_answers"] = {"value": record.missing,
                                            "limit": 0}
    return out
