"""PNG read/write over the standard library's ``zlib`` — port of
``slam_eds_tpu.io.image_rw`` (the ``dso::IOWrap`` ImageRW equivalent).

8/16-bit grayscale and 8-bit RGB, non-interlaced; all five scanline filters
on read, filter 0 on write (lossless either way). The sequential filters
(Sub, Average, Paeth) are undone by the host library's
``png_unfilter_rows`` when it is built (``io/event_buffer``), else by the
Python loop below, with the same result.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _native():
    from .event_buffer import _load
    return _load()


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img) -> None:
    """Write a [H, W] (grayscale, uint8/uint16) or [H, W, 3] (RGB, uint8)
    numpy array as PNG."""
    a = np.asarray(img)
    if a.ndim == 2:
        color, channels = 0, 1
    elif a.ndim == 3 and a.shape[2] == 3:
        color, channels = 2, 3
        if a.dtype != np.uint8:
            raise ValueError("RGB PNGs must be uint8")
    else:
        raise ValueError(f"unsupported image shape {a.shape}")
    if a.dtype == np.uint8:
        depth, raw = 8, a.astype(">u1")
    elif a.dtype == np.uint16:
        depth, raw = 16, a.astype(">u2")
    else:
        raise ValueError(f"unsupported dtype {a.dtype} (uint8/uint16 only)")

    h, w = a.shape[:2]
    body = raw.tobytes()
    stride = w * channels * (depth // 8)
    scan = b"".join(b"\x00" + body[i * stride:(i + 1) * stride]
                    for i in range(h))
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(scan, 6))
                + _chunk(b"IEND", b""))


def _unfilter(scan: np.ndarray, ftype: int, prev: np.ndarray,
              bpp: int) -> np.ndarray:
    """Undo one scanline's PNG filter (types 0-4) without the host library:
    None and Up vectorized, Sub as a per-lane prefix sum, Average and Paeth
    as the sequential per-byte recurrence."""
    if ftype == 0:
        return scan
    if ftype == 2:                       # Up
        return (scan.astype(np.int32) + prev).astype(np.uint8)
    if ftype == 1:                       # Sub: per-lane prefix sum mod 256
        lanes = scan.reshape(-1, bpp).astype(np.int64)
        return (np.cumsum(lanes, axis=0) & 0xFF).astype(np.uint8).reshape(-1)
    cur = scan.astype(np.int32).copy()
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        up = int(prev[i])
        ul = int(prev[i - bpp]) if i >= bpp else 0
        if ftype == 3:                   # Average
            cur[i] = (cur[i] + ((left + up) >> 1)) & 0xFF
        else:                            # Paeth
            p = left + up - ul
            pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
            pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc
                                                         else ul)
            cur[i] = (cur[i] + pred) & 0xFF
    return cur.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Read a PNG into a [H, W] (grayscale) or [H, W, C] numpy array."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = depth = color = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if interlace:
                raise ValueError("interlaced PNG unsupported")
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 4: 2, 6: 4}[color]
    if depth not in (8, 16):
        raise ValueError(f"bit depth {depth} unsupported")
    raw = zlib.decompress(idat)
    stride = w * channels * (depth // 8)
    bpp = channels * (depth // 8)
    scan = np.frombuffer(raw, np.uint8)[: h * (1 + stride)].reshape(
        h, 1 + stride)
    ftypes = np.ascontiguousarray(scan[:, 0])
    out = np.ascontiguousarray(scan[:, 1:])
    if ftypes.max(initial=0) > 4:
        raise ValueError("bad PNG filter type")
    lib = _native()
    if lib is not None:
        lib.png_unfilter_rows(out, ftypes, h, stride, bpp)
    else:
        prev = np.zeros(stride, np.uint8)
        for row in range(h):
            prev = _unfilter(out[row], int(ftypes[row]), prev, bpp)
            out[row] = prev
    if depth == 16:
        img = out.view(">u2").astype(np.uint16).reshape(h, w, channels)
    else:
        img = out.reshape(h, w, channels)
    return img[..., 0] if channels == 1 else img
