"""The port's codec: its zlib PNG reader equals PIL's decode on the golden
fixtures and on random images of every colour type and row filter it
takes, PIL decodes what its zlib writer wrote back to the input, and where
PIL is absent (forced here by patching the module's PIL handle)
unsupported inputs raise."""

import io
import struct
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from low_light_image_enhancement_tpu_torch.io import codec

DATA = Path(__file__).parent / "data"
FIXTURES = sorted(DATA.glob("pair*_*.png"))


def _pil_decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"), dtype=np.uint8)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filtered(pix: np.ndarray, kinds) -> bytes:
    """The scanlines of (h, w, bpp) u8 pixels, row y filtered by kinds[y]
    as the PNG specification writes it, byte by byte."""
    h, w, bpp = pix.shape
    rows = pix.reshape(h, w * bpp).astype(int)
    out = bytearray()
    for y in range(h):
        kind = kinds[y % len(kinds)]
        out.append(kind)
        for i in range(w * bpp):
            a = rows[y, i - bpp] if i >= bpp else 0
            b = rows[y - 1, i] if y else 0
            c = rows[y - 1, i - bpp] if y and i >= bpp else 0
            pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[kind]
            out.append((rows[y, i] - pred) & 0xFF)
    return bytes(out)


def _png(pix: np.ndarray, colour: int, kinds=(0, 1, 2, 3, 4),
         interlace: int = 0, depth: int = 8) -> bytes:
    h, w, _ = pix.shape
    ihdr = struct.pack(">IIBBBBB", w, h, depth, colour, 0, 0, interlace)
    return (codec.PNG_SIGNATURE + codec._chunk(b"IHDR", ihdr)
            + codec._chunk(b"IDAT", zlib.compress(_filtered(pix, kinds)))
            + codec._chunk(b"IEND", b""))


@pytest.fixture
def no_pil(monkeypatch):
    monkeypatch.setattr(codec, "Image", None)


def test_fixtures_decode_as_pil_decodes_them(no_pil):
    assert len(FIXTURES) == 6
    for path in FIXTURES:
        got = codec.decode_image(path)
        want = _pil_decode(path.read_bytes())
        assert got.shape == want.shape == (64, 64, 3)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("colour", [0, 2, 6])
def test_every_colour_type_and_filter_as_pil(no_pil, colour):
    rng = np.random.default_rng(colour)
    bpp = codec._PNG_CHANNELS[colour]
    for h, w in ((7, 5), (1, 13), (12, 1)):
        pix = rng.integers(0, 256, (h, w, bpp), dtype=np.uint8)
        data = _png(pix, colour)
        got = codec.decode_image(data)
        np.testing.assert_array_equal(got, _pil_decode(data))
        want = np.repeat(pix, 3, -1) if colour == 0 else pix[..., :3]
        np.testing.assert_array_equal(got, want)


def test_pil_decodes_what_zlib_wrote(no_pil, tmp_path):
    rng = np.random.default_rng(7)
    for h, w in ((33, 47), (1, 1), (64, 64)):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        np.testing.assert_array_equal(
            _pil_decode(codec.encode_image(img, format="PNG")), img)
        path = tmp_path / f"{h}x{w}.png"
        codec.encode_image(img, path)
        np.testing.assert_array_equal(_pil_decode(path.read_bytes()), img)
        np.testing.assert_array_equal(codec.decode_image(path), img)


def test_unsupported_inputs_raise_without_pil(no_pil, tmp_path):
    img = np.random.default_rng(3).integers(0, 256, (8, 8, 3),
                                            dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="PIL"):
        codec.decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="PIL"):
        codec.encode_image(img, format="JPEG")
    with pytest.raises(ValueError, match="PIL"):
        codec.encode_image(img, tmp_path / "out.jpg")
    for im in (Image.fromarray(img).quantize(16),          # palette
               Image.fromarray(img[..., 0].astype(np.uint16) * 257)):
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        with pytest.raises(ValueError, match="needs PIL"):
            codec.decode_image(buf.getvalue())
    with pytest.raises(ValueError, match="needs PIL"):
        codec.decode_image(_png(img, 2, interlace=1))
    corrupt = bytearray(codec.encode_image(img, format="PNG"))
    corrupt[40] ^= 0xFF
    with pytest.raises(ValueError, match="corrupt"):
        codec.decode_image(bytes(corrupt))


def test_both_paths_check_what_they_encode():
    img = np.zeros((4, 4, 3), np.uint8)
    with pytest.raises(ValueError, match="uint8"):
        codec.encode_image(img.astype(np.float32), format="PNG")
    with pytest.raises(ValueError, match="format required"):
        codec.encode_image(img)
    with pytest.raises(ValueError, match="RGB"):
        codec.encode_image(img[..., 0], format="PNG")
