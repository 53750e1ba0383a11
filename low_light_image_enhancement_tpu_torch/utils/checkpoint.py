"""Training checkpoints on ``torch.save``: params, optimizer state, step
(and the EMA params) of the training loop, with rotation and resume; the
API of the JAX package's orbax ``CheckpointManager``.

Layout: ``<root>/<step>/state.pt``. A save writes ``<root>/.tmp-<step>/``
and renames it to ``<root>/<step>``, so a crash never leaves a half-written
newest step; the oldest steps past ``max_to_keep`` are then removed.
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path
from typing import Any, List, Optional

import torch

_FILE = "state.pt"


def _structure(tree: Any) -> Any:
    """The keys of a nested dict, its leaves replaced by None."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return None


def _like(loaded: Any, template: Any) -> Any:
    """``loaded`` with every tensor leaf on its template leaf's device."""
    if isinstance(template, dict):
        return {k: _like(loaded[k], v) for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        return loaded.to(template.device)
    return loaded


class CheckpointManager:
    """Saves and restores nested dicts of tensors and numbers by step."""

    def __init__(self, root: str, max_to_keep: int = 3):
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> List[int]:
        return sorted(int(p.name) for p in self.root.iterdir()
                      if p.name.isdigit() and (p / _FILE).exists())

    def save(self, state: Any, step: int, wait: bool = False) -> None:
        """Write ``state`` as step ``step`` (saves are synchronous, so
        ``wait`` has nothing to wait for)."""
        tmp = self.root / f".tmp-{step}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / _FILE)
        final = self.root / str(step)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.root / str(old))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: int, template: Any) -> Any:
        """Step ``step``'s state, its tensors on the template's devices.
        Raises ``ValueError`` when its keys differ from the template's."""
        state = torch.load(self.root / str(step) / _FILE, map_location="cpu")
        if _structure(state) != _structure(template):
            raise ValueError(
                f"checkpoint {self.root / str(step)} holds "
                f"{_structure(state)}, not the template's "
                f"{_structure(template)}")
        return _like(state, template)

    def restore_latest(self, template: Any) -> Optional[Any]:
        step = self.latest_step()
        if step is None:
            return None
        return self.restore(step, template)

    def wait(self) -> None:
        """Saves are synchronous: nothing is in flight."""

    def close(self) -> None:
        self.wait()
