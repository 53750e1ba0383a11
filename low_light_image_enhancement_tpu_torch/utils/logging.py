"""Structured metrics logging (one JSON object a line, so that scripts can
read a run's results) and the standard Python logging set-up: the port's
own copy of the JAX package's ``utils/logging.py``."""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional, Union


def get_logger(name: str = "llie") -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s")
        )
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class JSONLLogger:
    """Append-only JSONL metrics writer; one dict per line, timestamped."""

    def __init__(self, path: Union[str, Path]):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)

    def log(self, record: Dict, step: Optional[int] = None) -> None:
        rec = dict(record)
        rec.setdefault("time", time.time())
        if step is not None:
            rec["step"] = step
        with self.path.open("a") as f:
            f.write(json.dumps(rec) + "\n")

    def read(self):
        if not self.path.exists():
            return []
        with self.path.open() as f:
            return [json.loads(line) for line in f if line.strip()]
