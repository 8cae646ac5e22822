"""Minimal PNG codec on numpy and zlib for the formats the pipeline uses:
8-bit RGB, 8-bit gray and 16-bit gray, non-interlaced.

Writers emit filter type 0 (none) rows in one IDAT chunk; the reader
undoes all five PNG row filters, so files from other encoders read too.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # PNG colour type -> channels (gray, RGB)


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """uint8 [H,W,3] RGB, uint8 [H,W] gray or uint16 [H,W] gray -> PNG."""
    a = np.asarray(img)
    if a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3:
        color, depth = 2, 8
    elif a.dtype == np.uint8 and a.ndim == 2:
        color, depth = 0, 8
    elif a.dtype == np.uint16 and a.ndim == 2:
        color, depth = 0, 16
    else:
        raise ValueError(f"unsupported PNG image: {a.dtype} {a.shape}")
    h, w = a.shape[:2]
    rows = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a)
    rows = rows.reshape(h, -1).view(np.uint8)
    data = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(data.tobytes(), level))
                + _chunk(b"IEND", b""))


def _unfilter_sequential(ft: int, line: np.ndarray, prev: np.ndarray,
                         bpp: int) -> np.ndarray:
    """Average (3) and Paeth (4) rows: each byte depends on its
    reconstructed left neighbour, so they decode byte by byte."""
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = up[i]
        if ft == 3:
            pred = (a + b) >> 1
        else:
            c = up[i - bpp] if i >= bpp else 0
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def read_png(path: str) -> np.ndarray:
    """PNG -> uint8 [H,W,3] RGB, uint8 [H,W] gray or uint16 [H,W] gray."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path}")
    pos, hdr, idat = 8, None, []
    while pos + 8 <= len(buf):
        n, tag = struct.unpack(">I4s", buf[pos:pos + 8])
        data = buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"PNG without IHDR: {path}")
    w, h, depth, color, _, _, interlace = hdr
    if depth not in (8, 16) or color not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG (bit depth {depth}, colour type "
                         f"{color}, interlace {interlace}): {path}")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw[: h * (stride + 1)].reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(raw[y, 0]), raw[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:  # Sub: running sum along each byte lane
            cur = (np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint32)
                   .astype(np.uint8).reshape(-1))
        elif ft == 2:  # Up
            cur = line + prev
        elif ft in (3, 4):
            cur = _unfilter_sequential(ft, line, prev, bpp)
        else:
            raise ValueError(f"bad PNG row filter {ft}: {path}")
        out[y] = cur
        prev = out[y]
    if depth == 16:
        img = out.view(">u2").astype(np.uint16)
    else:
        img = out
    return img.reshape(h, w, ch) if ch > 1 else img.reshape(h, w)
