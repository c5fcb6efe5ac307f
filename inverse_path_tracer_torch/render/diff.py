"""Analytic material VJP of the renderer (the counterpart of the JAX
package's render/diff.py).

The path-traced radiance is multilinear in the per-bounce diffuse albedos:
with per-bounce throughput factors f_k = bsdf_k * coeff_k and masked
per-bounce contributions c_b (emission + direct light),

    L = sum_b pm_b * c_b,        pm_b = prod_{j<b} f_j .

So the material cotangent needs only per-bounce records of one forward
pass (BounceRecords) and a suffix recursion over bounces,

    suffix_k = g * c_{k+1} + f_{k+1} * suffix_{k+1},

whose terms are (only Kd is learnable; the reference's set/getMaterials
touch only diffuse):

  * the throughput: d f_k / d kd = coeff_k / pi, so ct_k += pm_k * suffix_k
    * coeff_k / pi;
  * next-event estimation at hit lanes: l_d = (kd + spec*phong) * nee, so
    d l_d / d kd = nee and ct_k += g * pm_k * nee_k;
  * quirk Q2: the stale l_d re-added on escape at bounce k+1 belongs to
    bounce k's hit, so ct_k += g * pm_{k+1} * nee_k there.

Each bounce's cotangent is scattered into the (nT, 3) material array with a
one-hot contraction (einsum "rt,rc->tc"), which is deterministic, unlike
index_add_ on CUDA.

The records come from ops/kernels/render_kernel.py: render_tile_rec_plain
(the plain bounce loop with records) or the B3 kernel render_tile_rec; the
kernels B2 (grad_tile) and B4 (reverse_tile) run this recursion on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

INV_PI = 1.0 / math.pi

# Rows per bounce of the (max_bounces * REC_ROWS, n) record array: f(3) c(3)
# nee(3) pm_in(3) coeff tri hit esc (the JAX package's REC_ROWS layout,
# ops/pallas/render_kernel.py:118).  Slots past a ray's last bounce are 0.
REC_ROWS = 16


class BounceRecords(NamedTuple):
    """Per-bounce residuals of one forward pass, (B, n, ...) each."""

    f: torch.Tensor  # (B, n, 3) throughput factor bsdf*coeff (0 when the path ends)
    c: torch.Tensor  # (B, n, 3) masked per-bounce contribution l_e + l_d
    nee: torch.Tensor  # (B, n, 3) material-independent NEE factor l_o*geo*ok
    pm: torch.Tensor  # (B, n, 3) throughput entering the bounce
    coeff: torch.Tensor  # (B, n) cosine/pdf/p_RR (0 when the path ends)
    tri: torch.Tensor  # (B, n) int64 hit triangle (0 on a miss)
    hit: torch.Tensor  # (B, n) bool
    esc: torch.Tensor  # (B, n) bool: alive but missed (quirk Q2 lanes)

    @classmethod
    def from_rows(cls, rec: torch.Tensor) -> "BounceRecords":
        """View a (B * REC_ROWS, n) record array as BounceRecords."""
        v = rec.reshape(-1, REC_ROWS, rec.shape[-1])
        vec = lambda lo: v[:, lo : lo + 3].transpose(1, 2)
        return cls(f=vec(0), c=vec(3), nee=vec(6), pm=vec(9), coeff=v[:, 12],
                   tri=v[:, 13].long(), hit=v[:, 14] > 0, esc=v[:, 15] > 0)


def backward_from_records(
    records: BounceRecords, g: torch.Tensor, n_tri: int, quirks: bool
) -> torch.Tensor:
    """Records + radiance cotangent g (n, 3) -> material cotangent (nT, 3),
    by the suffix recursion of the module docstring, run backwards over the
    bounces in the order of the kernels' (render_bwd.cu reverse_path)."""
    iota = torch.arange(n_tri, device=g.device)
    d_mats = torch.zeros((n_tri, 3), dtype=g.dtype, device=g.device)
    suf = torch.zeros_like(g)
    esc_next = torch.zeros(g.shape[0], dtype=torch.bool, device=g.device)
    zero = torch.zeros_like(g)
    for k in range(records.f.shape[0] - 1, -1, -1):
        pm, f, nee, hit = records.pm[k], records.f[k], records.nee[k], records.hit[k]
        ct = pm * suf * (records.coeff[k] * INV_PI)[:, None] + g * pm * nee
        if quirks:
            ct = torch.where(esc_next[:, None], ct + g * (pm * f) * nee, ct)
        ct = torch.where(hit[:, None], ct, zero)
        onehot = ((records.tri[k][:, None] == iota[None, :]) & hit[:, None]).to(g.dtype)
        d_mats = d_mats + torch.einsum("rt,rc->tc", onehot, ct)
        suf = g * records.c[k] + f * suf
        esc_next = records.esc[k]
    return d_mats
