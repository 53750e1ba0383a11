"""The traced run's device timeline: one ``torch.profiler`` session over
the window, its device activity read from the exported trace and put on
the host's ``time.perf_counter`` clock by a marker span opened at a known
host time."""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Tuple

import torch

MARK = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Tracer:
    """``start`` before the window's clock starts, ``stop`` after its last
    sync; ``device_ops`` then holds (start, end, name) of every device
    operation on the host's clock."""

    def __init__(self):
        self.device_ops: List[Tuple[float, float, str]] = []
        self._prof = self._mark = None
        self._host_mark = 0.0

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._mark = record_function(MARK)
        self._mark.__enter__()
        self._host_mark = time.perf_counter()

    def stop(self) -> None:
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self._prof = None
        marks = [e["ts"] for e in events
                 if e.get("name") == MARK and e.get("ph") == "X"]
        if not marks:
            raise RuntimeError("the trace lacks the window's marker span")
        base = marks[0]
        self.device_ops = [
            ((e["ts"] - base) * 1e-6 + self._host_mark,
             (e["ts"] + e["dur"] - base) * 1e-6 + self._host_mark,
             e["name"])
            for e in events
            if e.get("cat") in DEVICE_CATS and e.get("ph") == "X"]
        if not self.device_ops and torch.cuda.is_available():
            raise RuntimeError("the trace holds no device activity")
