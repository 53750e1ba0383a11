"""The shipped ``.npz`` weights, read with numpy from the JAX package's
``weights/`` directory (by path: importing that package would import
``jax``), their conversion to this package's tensors and back, and
``save_params``, which writes the JAX package's npz layout."""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Optional, Union

import numpy as np
import torch

_SEP = "::"

_WEIGHTS_DIR = (Path(__file__).resolve().parents[2]
                / "low_light_image_enhancement_tpu" / "weights")
PRETRAINED = {
    "curve": _WEIGHTS_DIR / "curve_cnn.npz",
    "hybrid": _WEIGHTS_DIR / "curve_hybrid.npz",
    "fcn": _WEIGHTS_DIR / "fcn.npz",
    "decom": _WEIGHTS_DIR / "decom_relit.npz",
}
NAMED = dict(PRETRAINED)
NAMED["zeroref"] = _WEIGHTS_DIR / "curve_zeroref.npz"
NAMED["hybrid_guided"] = _WEIGHTS_DIR / "curve_hybrid_guided.npz"
NAMED["curve_guided"] = _WEIGHTS_DIR / "curve_cnn_guided.npz"
NAMED["fcn_guided"] = _WEIGHTS_DIR / "fcn_guided.npz"
NAMED["decom_relit_guided"] = _WEIGHTS_DIR / "decom_relit_guided.npz"
NAMED["decom_relit"] = _WEIGHTS_DIR / "decom_relit.npz"
NAMED["decom_v4"] = _WEIGHTS_DIR / "decom.npz"


def load_params(path: Union[str, Path]) -> Dict[str, Any]:
    """Flat npz -> nested dict-of-dicts of numpy arrays (HWIO conv weights,
    as the JAX package stores them)."""
    out: Dict[str, Any] = {}
    with np.load(path) as data:
        for key in data.files:
            node = out
            parts = key.split(_SEP)
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return out


def load_pretrained(method: str) -> Optional[Dict[str, Any]]:
    """Load the shipped weights for a pipeline method, or None."""
    path = PRETRAINED.get(method)
    if path is not None and path.exists():
        return load_params(path)
    return None


def resolve_weights(name_or_path: Union[str, Path]) -> Dict[str, Any]:
    """Load params from a shipped name or an .npz path."""
    p = Path(name_or_path)
    if p.exists():
        return load_params(p)
    named = NAMED.get(str(name_or_path))
    if named is not None and named.exists():
        return load_params(named)
    raise FileNotFoundError(
        f"weights {name_or_path!r} is neither a file nor a shipped name "
        f"(shipped: {sorted(k for k, v in NAMED.items() if v.exists())})"
    )


def params_from_numpy(
    params: Dict[str, Any], device="cpu"
) -> Dict[str, Dict[str, torch.Tensor]]:
    """JAX-layout params (conv weights HWIO ``(3, 3, cin, cout)``) -> this
    package's layout (OIHW tensors) on ``device``. Accepts numpy arrays or
    anything ``np.asarray`` takes (such as JAX arrays)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, layer in params.items():
        w = np.asarray(layer["w"], dtype=np.float32)
        out[name] = {
            "w": torch.from_numpy(
                np.ascontiguousarray(w.transpose(3, 2, 0, 1))).to(device),
            "b": torch.from_numpy(
                np.asarray(layer["b"], dtype=np.float32).copy()).to(device),
        }
    return out


def params_to_numpy(params: Dict[str, Dict[str, torch.Tensor]]
                    ) -> Dict[str, Dict[str, np.ndarray]]:
    """The inverse of :func:`params_from_numpy`: this package's layout
    (OIHW tensors, on any device) -> JAX-layout float32 numpy arrays (conv
    weights HWIO ``(3, 3, cin, cout)``)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, layer in params.items():
        w = layer["w"].detach().to("cpu", torch.float32).numpy()
        out[name] = {
            "w": np.ascontiguousarray(w.transpose(2, 3, 1, 0)),
            "b": layer["b"].detach().to("cpu", torch.float32).numpy().copy(),
        }
    return out


def save_params(params: Dict[str, Dict[str, torch.Tensor]],
                path: Union[str, Path]) -> None:
    """This package's params -> a flat npz in the JAX package's layout
    (HWIO conv weights, keys ``layer::w``), which its ``load_params`` and
    this package's :func:`load_params` both read."""
    flat = {f"{name}{_SEP}{k}": v
            for name, layer in params_to_numpy(params).items()
            for k, v in layer.items()}
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **flat)
