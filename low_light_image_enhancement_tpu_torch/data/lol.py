"""LOL paired low-light dataset (485 train / 15 eval pairs): the port of
the JAX package's ``data/lol.py``, its eval and its training half.

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
from typing import Iterator, List, Optional, Tuple

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

    def low(self, i: int) -> np.ndarray:
        """The low image alone: the unpaired (zero-reference) stream skips
        the high image's decode."""
        if self._files is not None:
            return decode_image(self._files[i][0])
        h, w = self.size
        return synth_pair(i, h, w, seed=self._seed)[0]

    def pairs(self) -> Iterator[Tuple[np.ndarray, np.ndarray, str]]:
        for i in range(len(self)):
            yield self[i]

    def train_batch_plans(
        self,
        batch_size: int,
        crop: int,
        seed: int = 0,
        start_step: int = 0,
        augment: bool = True,
        paired: bool = True,
    ) -> Iterator[dict]:
        """Infinite iterator of numpy batch plans (no decode): sample
        indices, crop anchors as [0, 1) fractions (mapped to offsets at
        decode time), flip bits. Each step draws from
        ``default_rng((seed, step))``, so a run resumed at ``start_step``
        sees the stream a straight run would, and the JAX package's plans
        are the same."""
        step = start_step
        n = len(self)
        while True:
            r = np.random.default_rng((seed, step))
            yield {
                "idx": r.integers(0, n, batch_size),
                "uv": r.random((batch_size, 2)),
                "flips": (r.integers(0, 2, (batch_size, 2)) if augment
                          else np.zeros((batch_size, 2), np.int64)),
                "crop": crop,
                "paired": paired,
            }
            step += 1

    def materialize_batch(self, plan: dict):
        """Decode, crop, flip and stack one plan into planar f32
        ``(B, 3, crop, crop)`` numpy arrays: a ``(low, high)`` pair, or the
        low batch alone when the plan is unpaired."""
        crop = plan["crop"]
        paired = plan["paired"]
        lows, highs = [], []
        for i, (u, v), (fh, fv) in zip(plan["idx"], plan["uv"],
                                       plan["flips"]):
            if paired:
                lo, hi, _ = self[int(i)]
            else:
                lo, hi = self.low(int(i)), None
            h, w = lo.shape[:2]
            if h < crop or w < crop:
                raise ValueError(
                    f"crop {crop} exceeds image {h}x{w} in {self.split}")
            y = int(u * (h - crop + 1))
            x = int(v * (w - crop + 1))
            for img, out in ((lo, lows), (hi, highs)):
                if img is None:
                    continue
                img = img[y:y + crop, x:x + crop]
                if fh:
                    img = img[:, ::-1]
                if fv:
                    img = img[::-1]
                out.append(img)

        def _planar(imgs):
            x8 = np.ascontiguousarray(np.stack(imgs))
            return np.transpose(x8.astype(np.float32) / 255.0, (0, 3, 1, 2))

        if paired:
            return _planar(lows), _planar(highs)
        return _planar(lows)

    def train_batches(
        self,
        batch_size: int,
        crop: int,
        seed: int = 0,
        start_step: int = 0,
        augment: bool = True,
        paired: bool = True,
    ) -> Iterator:
        """Infinite iterator of training batches: :meth:`train_batch_plans`
        through :meth:`materialize_batch` in series (a ``PrefetchQueue``
        with workers composes the same two and yields the same stream)."""
        return map(self.materialize_batch,
                   self.train_batch_plans(batch_size, crop, seed, start_step,
                                          augment, paired))

    def as_batch(self, n: Optional[int] = None):
        """The first ``n`` (default: all) pairs stacked into (lows, highs)
        u8 arrays; the images must share one size."""
        n = len(self) if n is None else min(n, len(self))
        lows, highs = [], []
        for i in range(n):
            lo, hi, _ = self[i]
            lows.append(lo)
            highs.append(hi)
        return np.stack(lows), np.stack(highs)
