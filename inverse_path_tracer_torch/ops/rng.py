"""Counter-hash RNG, bit-exact to the JAX package's fused-kernel RNG
(ops/pallas/render_kernel.py _fmix32, _unit_from_bits_i32,
_make_uniform_stream).

Uniform (sample, bounce, slot) is a pure function of the two key words and
the global sample index:

    h = fmix32(orig ^ k0)
    u = unit(fmix32((h + (bounce*8 + slot) * 0x9E3779B9) ^ k1))

so a render is the same under any tiling.  A seed s maps to the key words
(s >> 32, s & 0xFFFFFFFF), which for s < 2**32 are the words of
jax.random.PRNGKey(s).  Bounce slots 0-5 feed the bounce loop; slots 6 and 7
of bounce 0 are the camera jitter.

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


def fold_in(seed: int, data: int) -> int:
    """A new seed, a pure function of (seed, data): with (k0, k1) =
    key_words(seed), the words fmix32(k0 ^ data) and fmix32(k1 ^ data *
    0x9E3779B9), both mod 2**32.  It stands in for jax.random.fold_in, whose
    threefry mixing has no counterpart on the port's integer seeds; the
    two give different keys."""
    k0, k1 = key_words(seed)
    d = data & MASK32
    w = fmix32(torch.tensor([k0 ^ d, k1 ^ ((d * GOLDEN) & MASK32)], dtype=torch.int64))
    w0, w1 = w.tolist()
    return (w0 << 32) | w1
