"""Host-side PNG decode: 8-bit gray, 16-bit depth, color.

Parity target: cv::imread as used by the reference —
imread(path, 0) 8-bit grayscale (reference src/GraphicEnd.cpp:271),
imread(path, -1) unchanged 16-bit depth (src/GraphicEnd.cpp:276),
imread(path, CV_LOAD_IMAGE_COLOR) (src/convert2PCD.cpp:50).

Grayscale conversion follows OpenCV's BT.601 weights with rounding
(PIL's 'L' mode truncates, which would shift feature responses).

Decoding goes through the native codec (native/png_codec.cc) when it is
built, PIL otherwise; gray8 and depth16 files are written by a stdlib
encoder (zlib + struct), so writing a dataset needs neither. PIL is
imported only by the paths that use it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _native():
    """The C++ decoder (native/png_codec.cc) when built; None otherwise."""
    from .. import native_io
    return native_io if native_io.available() else None


def load_gray(path: str) -> np.ndarray:
    """8-bit grayscale (H,W) uint8, BT.601 rounding like cv::imread(.,0)."""
    nat = _native()
    if nat is not None:
        try:
            out = nat.png_decode(path, to_gray=True)
            if out.dtype == np.uint8 and out.ndim == 2:
                return out
        except ValueError:
            pass  # fall through to PIL for exotic encodings
    from PIL import Image

    img = Image.open(path)
    if img.mode in ("L", "I;16", "I"):
        arr = np.asarray(img)
        if arr.dtype != np.uint8:
            arr = np.clip(arr, 0, 255).astype(np.uint8)
        return arr
    rgb = np.asarray(img.convert("RGB"), dtype=np.float32)
    gray = rgb[..., 0] * 0.299 + rgb[..., 1] * 0.587 + rgb[..., 2] * 0.114
    return np.clip(np.round(gray), 0, 255).astype(np.uint8)


def load_depth(path: str) -> np.ndarray:
    """16-bit depth (H,W) uint16, raw values (cv::imread(.,-1))."""
    nat = _native()
    if nat is not None:
        try:
            out = nat.png_decode(path, to_gray=False)
            if out.ndim == 2:
                return out.astype(np.uint16, copy=False)
        except ValueError:
            pass
    from PIL import Image

    arr = np.asarray(Image.open(path))
    if arr.dtype == np.uint8:
        return arr.astype(np.uint16)
    return arr.astype(np.uint16)


def load_color(path: str) -> np.ndarray:
    """(H,W,3) uint8 RGB."""
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def decoder() -> str:
    """Which decoder load_gray/load_depth use: "native" or "PIL".
    Raises RuntimeError when neither is available."""
    if _native() is not None:
        return "native"
    try:
        import PIL  # noqa: F401
    except ImportError as e:
        raise RuntimeError(
            "no PNG decoder: the native codec did not build "
            "(`make -C native`) and PIL is not installed") from e
    return "PIL"


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _write_gray_png(path: str, arr: np.ndarray, bit_depth: int) -> None:
    """Grayscale PNG (color type 0), every row with filter type 0; 16-bit
    samples are big-endian as the format requires."""
    h, w = arr.shape
    dtype = ">u2" if bit_depth == 16 else "u1"
    rows = np.ascontiguousarray(arr, dtype=dtype).reshape(h, -1).view(np.uint8)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, bit_depth, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(_png_chunk(b"IHDR", ihdr))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_png_chunk(b"IEND", b""))


def save_gray(path: str, arr: np.ndarray) -> None:
    _write_gray_png(path, np.asarray(arr, dtype=np.uint8), 8)


def save_depth(path: str, arr: np.ndarray) -> None:
    _write_gray_png(path, np.asarray(arr, dtype=np.uint16), 16)


def save_color(path: str, arr: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(np.asarray(arr, dtype=np.uint8), mode="RGB").save(path)
