"""Minimal PNG reader and writer (8-bit, non-interlaced), zlib + numpy only,
so the port needs no imaging package."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {img.shape}")
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[r].tobytes() for r in range(h))  # filter 0 rows
    with open(path, "wb") as f:
        f.write(_SIG)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(_chunk(b"IEND", b""))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit non-interlaced RGB PNG as (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path} is not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or interlace != 0 or ctype != 2:
        raise ValueError(f"unsupported PNG (depth {depth}, type {ctype}, interlace {interlace})")
    ch = 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    out = np.zeros((h, w * ch), dtype=np.int32)
    prev = np.zeros(w * ch, dtype=np.int32)
    for r in range(h):
        ftype, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        else:
            # Sub/Average/Paeth depend on the reconstructed left neighbour:
            # resolve one pixel column at a time.
            cur = np.zeros_like(line)
            for x in range(0, w * ch, ch):
                left = cur[x - ch : x] if x else np.zeros(ch, np.int32)
                up = prev[x : x + ch]
                ul = prev[x - ch : x] if x else np.zeros(ch, np.int32)
                if ftype == 1:
                    pred = left
                elif ftype == 3:
                    pred = (left + up) // 2
                elif ftype == 4:
                    pred = _paeth(left, up, ul)
                else:
                    raise ValueError(f"bad PNG filter type {ftype}")
                cur[x : x + ch] = (line[x : x + ch] + pred) & 0xFF
        out[r] = cur
        prev = cur
    return out.astype(np.uint8).reshape(h, w, ch)
