"""LOL paired low-light dataset: the eval half of the JAX package's
``data/lol.py`` (485 train / 15 eval pairs).

Loads the standard on-disk layout when available::

    <root>/our485/low/*.png   <root>/our485/high/*.png
    <root>/eval15/low/*.png   <root>/eval15/high/*.png

Root resolution order: explicit ``root`` arg, ``$LLIE_LOL_DIR``, ``data/LOL``
under the working directory. When no real dataset is present, the
deterministic synthetic stand-in of ``data.synth`` (the same images as the
JAX package's) takes its place, with the same counts. The training half
(batch plans and their decode) comes with the port's training.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from low_light_image_enhancement_tpu_torch.data.synth import synth_pair
from low_light_image_enhancement_tpu_torch.io.codec import decode_image

_SPLITS = {"train": ("our485", 485), "eval15": ("eval15", 15)}


class LOLDataset:
    def __init__(
        self,
        root: Optional[str] = None,
        split: str = "eval15",
        size: Tuple[int, int] = (400, 600),
        synthetic_seed: int = 0,
    ):
        if split not in _SPLITS:
            raise ValueError(f"split must be one of {sorted(_SPLITS)}")
        self.split = split
        self.size = size
        self._seed = synthetic_seed
        self._files: Optional[List[Tuple[Path, Path]]] = None

        root = root or os.environ.get("LLIE_LOL_DIR") or "data/LOL"
        subdir, self._n_synth = _SPLITS[split]
        low_dir = Path(root) / subdir / "low"
        high_dir = Path(root) / subdir / "high"
        if low_dir.is_dir() and high_dir.is_dir():
            pairs = [(lp, high_dir / lp.name)
                     for lp in sorted(low_dir.iterdir())
                     if (high_dir / lp.name).exists()]
            if pairs:
                self._files = pairs

    @property
    def is_synthetic(self) -> bool:
        return self._files is None

    def __len__(self) -> int:
        return len(self._files) if self._files else self._n_synth

    def __getitem__(self, i: int) -> Tuple[np.ndarray, np.ndarray, str]:
        """Returns (low_u8, high_u8, name)."""
        if self._files is not None:
            lp, hp = self._files[i]
            return decode_image(lp), decode_image(hp), lp.name
        h, w = self.size
        low, high = synth_pair(i, h, w, seed=self._seed)
        return low, high, f"synth_{self.split}_{i:04d}"
