"""Counter-hash RNG, bit-exact to the JAX package's fused-kernel RNG
(ops/pallas/render_kernel.py _fmix32, _unit_from_bits_i32,
_make_uniform_stream).

Uniform (sample, bounce, slot) is a pure function of the two key words and
the global sample index:

    h = fmix32(orig ^ k0)
    u = unit(fmix32((h + (bounce*8 + slot) * 0x9E3779B9) ^ k1))

so a render is the same under any tiling.  A seed s maps to the key words
(s >> 32, s & 0xFFFFFFFF), which for s < 2**32 are the words of
jax.random.PRNGKey(s).

Slot map, per bounce b (counter b*8 + slot):

    forward loop   slots 0-5: light pick, r1, r2, roulette, phi, theta
                   slots 6, 7 of bounce 0: the camera jitter (x, y)
    inverse loop   slots 0-6: spec, light pick, r1, r2, roulette, phi,
                   theta (the JAX inverse pass's row order)

The inverse loop reads slot 6 of bounce 0, the forward camera's x jitter,
so the extraction draws its camera rays under another key,
fold_in(key, CAMERA_STREAM): the two streams share no (key, counter) pair.

The arithmetic is uint32, carried here in int64 tensors holding values in
[0, 2**32) (int64 shifts of non-negative values are logical); products are
split so that no int64 intermediate overflows.
"""

from __future__ import annotations

from typing import Tuple

import torch

MASK32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
SLOT_JITTER_X, SLOT_JITTER_Y = 6, 7
# fold_in data of the inverse pass's camera stream (ASCII "CAM").
CAMERA_STREAM = 0x43414D
# fold_in data of the dataset's target renders (ASCII "TGT"): scene i of
# data/pipeline.py generate_files renders under fold_in(fold_in(key,
# TARGET_STREAM), i), so that no target shares its key with a render under
# a small key such as the default 0 (fold_in(0, 0) is 0).
TARGET_STREAM = 0x544754


def key_words(seed: int) -> Tuple[int, int]:
    if seed < 0:
        raise ValueError(f"seed must be non-negative, got {seed}")
    return (seed >> 32) & MASK32, seed & MASK32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for x in [0, 2**32), c < 2**32, in int64."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on uint32 values held in int64."""
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def unit_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits -> float32 in [0, 1): top 23 bits as the mantissa of a
    number in [1, 2), minus 1."""
    u = (bits >> 9) | 0x3F800000
    return u.to(torch.int32).view(torch.float32) - 1.0


def hash_orig(keys: Tuple[int, int], orig: torch.Tensor) -> torch.Tensor:
    """The per-sample half of the hash, fmix32(orig ^ k0)."""
    return fmix32((orig.to(torch.int64) & MASK32) ^ keys[0])


def draw(keys: Tuple[int, int], h_orig: torch.Tensor, bounce: int,
         slots=range(8)) -> torch.Tensor:
    """(len(slots), n) float32 uniforms of one bounce."""
    rows = []
    for s in slots:
        ctr = (bounce * 8 + s) * GOLDEN
        rows.append(unit_from_bits(fmix32(((h_orig + ctr) & MASK32) ^ keys[1])))
    return torch.stack(rows, dim=0)


def _fmix32_int(x: int) -> int:
    """fmix32 of one uint32 held in a Python int."""
    x ^= x >> 16
    x = (x * _M1) & MASK32
    x ^= x >> 13
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def fold_in(seed: int, data: int) -> int:
    """A new seed, a pure function of (seed, data): with (k0, k1) =
    key_words(seed), the words fmix32(k0 ^ data) and fmix32(k1 ^ data *
    0x9E3779B9), both mod 2**32.  It stands in for jax.random.fold_in, whose
    threefry mixing has no counterpart on the port's integer seeds; the
    two give different keys.  Computed on Python ints: no tensor op."""
    k0, k1 = key_words(seed)
    d = data & MASK32
    return (_fmix32_int(k0 ^ d) << 32) | _fmix32_int(k1 ^ ((d * GOLDEN) & MASK32))
