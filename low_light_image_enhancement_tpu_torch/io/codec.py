"""JPEG/PNG codec (host side).

Where PIL imports, it decodes and encodes, as the JAX package's codec
does. Where it does not (the H100 host has no PIL), PNG is read and
written by the standard library's ``zlib``: 8-bit, non-interlaced, colour
types 0 (grey, replicated to RGB), 2 (RGB) and 6 (RGBA, alpha dropped), as
PIL's ``convert("RGB")`` gives them; the reader takes all five row filters,
the writer uses Sub. JPEG, 16-bit, palette and interlaced PNGs raise
``ValueError`` there: nothing decodes to something that silently differs.
"""

from __future__ import annotations

import io as _io
import os
import struct
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np

try:
    from PIL import Image
except ImportError:
    Image = None

Source = Union[str, os.PathLike, bytes, bytearray, _io.BytesIO]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> bytes a pixel, at bit depth 8
_PNG_CHANNELS = {0: 1, 2: 3, 6: 4}


def decode_image(src: Source) -> np.ndarray:
    """Decode JPEG/PNG (path or bytes) -> uint8 (H, W, 3) RGB."""
    if Image is not None:
        if isinstance(src, (bytes, bytearray)):
            src = _io.BytesIO(src)
        with Image.open(src) as im:
            return np.array(im.convert("RGB"), dtype=np.uint8)
    if isinstance(src, (bytes, bytearray)):
        data = bytes(src)
    elif isinstance(src, _io.BytesIO):
        data = src.getvalue()
    else:
        data = Path(src).read_bytes()
    return _decode_png(data)


def encode_image(
    img_u8: np.ndarray,
    dst: Optional[Union[str, os.PathLike]] = None,
    format: Optional[str] = None,
    quality: int = 95,
) -> Optional[bytes]:
    """Encode uint8 (H, W, 3) RGB. With ``dst`` writes a file (format from the
    extension); without, returns encoded bytes (``format`` required)."""
    img_u8 = np.asarray(img_u8)
    if img_u8.dtype != np.uint8:
        raise ValueError(f"expected uint8, got {img_u8.dtype}")
    if img_u8.ndim != 3 or img_u8.shape[-1] != 3:
        raise ValueError(f"expected RGB (H,W,3), got {img_u8.shape}")
    if dst is None and format is None:
        raise ValueError("format required when encoding to bytes")
    if Image is not None:
        im = Image.fromarray(np.ascontiguousarray(img_u8))
        if dst is not None:
            im.save(dst, format=format, quality=quality)
            return None
        buf = _io.BytesIO()
        im.save(buf, format=format, quality=quality)
        return buf.getvalue()
    fmt = format or Path(dst).suffix.lstrip(".")
    if fmt.upper() != "PNG":
        raise ValueError(f"encoding {fmt!r} needs PIL; without it only PNG "
                         "is written")
    data = _encode_png(img_u8)
    if dst is None:
        return data
    Path(dst).write_bytes(data)
    return None


# ------------------------------------------------------ the zlib PNG codec #

def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def _encode_png(img: np.ndarray) -> bytes:
    """8-bit RGB PNG, each row filtered by Sub (the difference to the pixel
    on its left, mod 256)."""
    h, w, _ = img.shape
    sub = np.empty((h, 1 + 3 * w), dtype=np.uint8)
    sub[:, 0] = 1
    rows = img.reshape(h, 3 * w)
    sub[:, 1:4] = rows[:, :3]
    sub[:, 4:] = rows[:, 3:] - rows[:, :-3]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(sub.tobytes(), 6))
            + _chunk(b"IEND", b""))


def _paeth_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Paeth's predictor runs along the row, a byte at a time."""
    cur = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        c = up[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), dtype=np.uint8)


def _average_row(raw: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    cur = bytearray(raw.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + up[i]) >> 1)) & 0xFF
    return np.frombuffer(bytes(cur), dtype=np.uint8)


def _unfilter(data: np.ndarray, h: int, w: int, bpp: int) -> np.ndarray:
    """The scanlines (h, 1 + w bpp), filter byte first, -> (h, w bpp)."""
    out = np.empty((h, w * bpp), dtype=np.uint8)
    prev = np.zeros(w * bpp, dtype=np.uint8)
    for y in range(h):
        kind, raw = data[y, 0], data[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:
            # Sub: a running sum of each channel along the row, mod 256
            cur = np.cumsum(raw.reshape(w, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = raw + prev
        elif kind == 3:
            cur = _average_row(raw, prev, bpp)
        elif kind == 4:
            cur = _paeth_row(raw, prev, bpp)
        else:
            raise ValueError(f"PNG row {y} has filter type {kind}")
        out[y] = cur
        prev = out[y]
    return out


def _decode_png(data: bytes) -> np.ndarray:
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError("not a PNG; JPEG and other formats need PIL")
    pos, header, idat = len(PNG_SIGNATURE), None, []
    while pos + 12 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4 or \
                struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} is truncated or corrupt")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    w, h, depth, colour, compression, filt, interlace = header
    if depth != 8 or colour not in _PNG_CHANNELS or interlace != 0 \
            or compression != 0 or filt != 0:
        raise ValueError(
            f"PNG of bit depth {depth}, colour type {colour}, interlace "
            f"{interlace} needs PIL; without it only 8-bit, non-interlaced "
            "grey, RGB and RGBA are read")
    bpp = _PNG_CHANNELS[colour]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data does not inflate: {e}") from None
    if len(raw) != h * (1 + w * bpp):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not "
                         f"{h * (1 + w * bpp)} for {w}x{h}")
    pix = _unfilter(np.frombuffer(raw, dtype=np.uint8).reshape(h, -1), h, w,
                    bpp).reshape(h, w, bpp)
    if colour == 0:
        return np.repeat(pix, 3, axis=-1)
    return np.ascontiguousarray(pix[..., :3])
