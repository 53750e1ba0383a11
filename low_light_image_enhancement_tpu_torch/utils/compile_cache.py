"""Where the kernel library is built and reused (the JAX package's
``utils/compile_cache.py``, whose persistent XLA cache this stands for).

``kernels/_build.py`` compiles each CUDA source into an object named by
its hash and reuses every object that is already there, so that a process
after the first builds nothing and one whose sources changed recompiles
only those. ``enable_compile_cache()`` picks the directory those objects
and the library live in. ``llie-torch`` calls it on startup; library users
may call it before the first kernel launch. The ``LLIE_COMPILE_CACHE``
environment variable: unset -> ``<repo>/build/torch_kernels`` (the
default, also without a call); a path -> that directory; ``0``/``off``/
``none``/empty -> no reuse: a fresh temporary directory, removed at exit.
"""

from __future__ import annotations

import atexit
import logging
import os
import shutil
import tempfile
from pathlib import Path
from typing import Optional, Union

from low_light_image_enhancement_tpu_torch.kernels import _build

__all__ = ["enable_compile_cache"]

_DISABLE = {"0", "off", "none", ""}


def enable_compile_cache(
    path: Optional[Union[str, Path]] = None,
) -> Optional[str]:
    """Build and reuse the kernel library in ``path`` (or the
    ``LLIE_COMPILE_CACHE`` directory, or ``build/torch_kernels`` of the
    checkout). Returns the directory, or None when reuse is off (the
    library is then built in a fresh temporary directory) or the directory
    is not writable (the build directory stays as it was; logged). Never
    raises."""
    if path is None:
        env = os.environ.get("LLIE_COMPILE_CACHE")
        if env is not None and env.strip().lower() in _DISABLE:
            tmp = tempfile.mkdtemp(prefix="llie_kernels_")
            atexit.register(shutil.rmtree, tmp, ignore_errors=True)
            _build.set_build_dir(tmp)
            return None
        path = env or _build.DEFAULT_BUILD_DIR
    cache_dir = Path(path).expanduser()
    try:
        cache_dir.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryFile(dir=cache_dir):
            pass
    except OSError as e:
        logging.getLogger("llie").warning(
            "kernel build cache disabled (%s): %s", cache_dir, e)
        return None
    _build.set_build_dir(cache_dir)
    return str(cache_dir)
