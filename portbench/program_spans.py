"""The program's own spans in a run's window, as the port records them
while a ``torch.profiler`` session records (``utils.profiling``), for the
readers of the ``program_span`` metrics."""

from __future__ import annotations

from typing import List, Optional


def window(run, *names: str) -> Optional[List]:
    """The spans of ``names`` that started in the run's window; None where
    the program records no spans (a version without the recorder, or a run
    without the trace) or dropped some in the window."""
    try:
        from low_light_image_enhancement_tpu_torch.utils.profiling import (
            recorded_spans,
        )
    except ImportError:
        return None
    if run.trace is None:
        return None
    spans = recorded_spans(run.record.t0, run.record.t1)
    if spans is None:
        return None
    return [s for s in spans if s.name in names]
