"""The renderer's counter-hash random numbers (the upstream port's fused
RNG): uniform (sample, bounce, slot) is

    h = fmix32(sample ^ k0)
    u = unit(fmix32((h + (bounce * 8 + slot) * 0x9E3779B9) ^ k1))

with (k0, k1) the high and low words of the 64-bit key, fmix32 murmur3's
finalizer and unit() the top 23 bits as a float in [0, 1).  uint32 values
are carried in int64 tensors.  fold_in derives a key from a key and an
integer, on Python ints."""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
M1, M2 = 0x85EBCA6B, 0xC2B2AE35
CAMERA_STREAM = 0x43414D  # fold_in data of the extraction's camera key ("CAM")


def words(key: int):
    return (key >> 32) & MASK32, key & MASK32


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    return ((x & 0xFFFF) * c + ((((x >> 16) * c) & 0xFFFF) << 16)) & MASK32


def fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, M1)
    x = x ^ (x >> 13)
    x = _mul(x, M2)
    return x ^ (x >> 16)


def _fmix_int(x: int) -> int:
    x ^= x >> 16
    x = (x * M1) & MASK32
    x ^= x >> 13
    x = (x * M2) & MASK32
    return x ^ (x >> 16)


def fold_in(key: int, data: int) -> int:
    k0, k1 = words(key)
    d = data & MASK32
    return (_fmix_int(k0 ^ d) << 32) | _fmix_int(k1 ^ ((d * GOLDEN) & MASK32))


def sample_hash(key: int, idx: torch.Tensor) -> torch.Tensor:
    return fmix((idx.to(torch.int64) & MASK32) ^ words(key)[0])


def uniforms(key: int, h: torch.Tensor, bounce: int, slots) -> torch.Tensor:
    """(len(slots), n) float32 uniforms of one bounce."""
    k1 = words(key)[1]
    rows = []
    for s in slots:
        bits = fmix(((h + (bounce * 8 + s) * GOLDEN) & MASK32) ^ k1)
        rows.append(((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0)
    return torch.stack(rows)
