"""PNG codec in numpy + zlib, the port's own copy of
``putslam_tpu/io/png.py`` (``write_png`` :30, ``read_png`` :63).

Neither PIL, imageio nor cv2 is assumed. TUM-layout sequences are pairs of
8-bit RGB (or gray) and 16-bit depth PNGs; the writer materialises rendered
sequences on disk so the file-player path (``io/tum.py``) can be driven end to
end, the reader is the decoder used when the native libpng loader
(``io/native_loader.py``) cannot be loaded.

Grayscale 8/16-bit and RGB 8-bit, no interlace, no palette. The writer emits
filter 0 scanlines with zlib level 6, so its files equal the JAX package's
byte for byte; the reader handles all five filters.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write (H,W) uint8 / uint16 grayscale or (H,W,3) uint8 RGB
    (``putslam_tpu/io/png.py:30``)."""
    arr = np.asarray(arr)
    if arr.ndim == 2 and arr.dtype == np.uint8:
        color, depth, payload = 0, 8, arr[:, :, None]
    elif arr.ndim == 2 and arr.dtype == np.uint16:
        color, depth, payload = 0, 16, arr[:, :, None].astype(">u2")
    elif arr.ndim == 3 and arr.shape[2] == 3 and arr.dtype == np.uint8:
        color, depth, payload = 2, 8, arr
    else:
        raise ValueError(f"unsupported array {arr.shape} {arr.dtype}")
    h, w = arr.shape[:2]
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    rows = np.ascontiguousarray(payload).view(np.uint8).reshape(h, -1)
    # one filter byte (0 = None) in front of every scanline
    lines = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    data = zlib.compress(lines.tobytes(), 6)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", data)
                + _chunk(b"IEND", b""))


def _unfilter_serial(ft: int, line: np.ndarray, prev: np.ndarray,
                     bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4): every byte needs the reconstructed byte
    ``bpp`` to its left, so the scanline is walked once, over Python ints."""
    cur = bytearray(line.tobytes())
    pr = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = pr[i]
        if ft == 3:
            pred = (a + b) >> 1
        else:
            c = pr[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read a PNG → (H,W) uint8/uint16 or (H,W,C) uint8 array
    (``putslam_tpu/io/png.py:63``). Sub is a prefix sum mod 256 per byte lane
    and is done with ``cumsum``; the reference walks it byte by byte, the
    bytes that come out are the same."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG")
    pos, ihdr, idat = 8, None, []
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        payload = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, color, _, _, interlace = ihdr
    if interlace:
        raise ValueError("interlaced PNG unsupported")
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    bpp = channels * (depth // 8)          # bytes per pixel
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{path}: truncated image data")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    filters = raw[:, 0]
    out = raw[:, 1:].copy()
    if filters.any():
        prev = np.zeros((stride,), np.uint8)
        for y in range(h):
            ft = int(filters[y])
            if ft == 0:
                pass
            elif ft == 1:                       # Sub
                lanes = out[y].reshape(w, bpp)
                lanes[...] = np.cumsum(lanes, axis=0, dtype=np.uint8)
            elif ft == 2:                       # Up
                out[y] += prev
            elif ft in (3, 4):                  # Average / Paeth
                out[y] = _unfilter_serial(ft, out[y], prev, bpp)
            else:
                raise ValueError(f"bad filter {ft}")
            prev = out[y]
    if depth == 16:
        img = out.reshape(h, w, channels, 2)
        img = (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    else:
        img = out.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
