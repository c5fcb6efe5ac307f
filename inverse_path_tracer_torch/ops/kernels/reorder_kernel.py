"""Wrapper of the staged wavefront's re-sort kernel and its plain PyTorch
version.

    reorder_tile / reorder_tile_plain   the stable re-sort of a launch's
                                        lane carry before a stage

Before each stage the staged wavefront (render/forward.py _staged_launch)
re-sorts its lanes stably, live ones first and, on clustered scenes, binned
by ray direction octant and origin cell (the JAX package's
render/forward.py:620 _alive_first_order and :635 _binned_order, then its
gathers).  Both take

    carry   (CARRY_ROWS, n) float32 lane carry (render_kernel.py CARRY_ROWS)
    orig    (1, n) int32 global sample index of each lane
    bins    (lo, inv_ext), each (3,) float32, the scene's box
            (render/forward.py _scene_bins), or None: alive first only
    cells   origin cells per axis (RenderConfig.bin_cells)

and return (carry, orig, live, order): the re-sorted carry and orig, live
(1,) int32 the count of live lanes (which come first; B8 takes it), and,
with with_rec, order (n,) int64, new column j holding old column order[j]
(the stage records keep it for the reverse), else None.

reorder_tile launches reorder.cu's counting sort for CUDA tensors and runs
the plain version for CPU tensors; it never falls back from one to the
other on a CUDA tensor.  Its order is the plain version's element for
element, so the carries B8 sees are the same.  With a ReorderScratch the
kernel writes the carry, orig and live into the scratch's buffers, which
one range allocates once and reuses in every stage and launch (they hold
until the next call with that scratch); without one each call allocates
its outputs.  reorder_tile.launches counts its calls (three kernels each);
each runs under the span ipt.launch.reorder_tile (utils/profiling.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    CAR_ALIVE,
    CARRY_ROWS,
    _check,
    _library,
    _ptr,
    _raise_on,
)
from inverse_path_tracer_torch.utils.profiling import spanned

Bins = Tuple[torch.Tensor, torch.Tensor]


def _bin_keys(carry: torch.Tensor, lo: torch.Tensor, inv_ext: torch.Tensor,
              cells: int) -> torch.Tensor:
    """The binned sort key of each lane (JAX render/forward.py:635): (dead *
    8 + direction octant) * cells^3 + origin cell, the cell of the next
    origin in a cells^3 grid over the scene's box."""
    d, p = carry[0:3], carry[3:6]
    dead = (carry[CAR_ALIVE] <= 0).to(torch.int64)
    octant = (d[0] > 0).long() + 2 * (d[1] > 0).long() + 4 * (d[2] > 0).long()
    cidx = torch.clamp(((p - lo[:, None]) * inv_ext[:, None] * cells).to(torch.int32), 0,
                       cells - 1).long()
    cell = cidx[0] + cells * (cidx[1] + cells * cidx[2])
    return (dead * 8 + octant) * cells**3 + cell


def _alive_first_order(alive: torch.Tensor) -> torch.Tensor:
    """Stable partition of the lanes, alive (> 0) first: new[j] =
    old[order[j]] (JAX render/forward.py:620)."""
    return torch.sort((alive <= 0).to(torch.int32), stable=True).indices


def _binned_order(carry: torch.Tensor, lo: torch.Tensor, inv_ext: torch.Tensor,
                  cells: int) -> torch.Tensor:
    """Alive-first and ray-binned stable order of the carry's lanes (JAX
    render/forward.py:635): by _bin_keys.  Alive lanes still come strictly
    first; within them, rays of one direction octant and region share
    warps, so that their cluster box tests agree."""
    return torch.sort(_bin_keys(carry, lo, inv_ext, cells), stable=True).indices


def reorder_tile_plain(carry: torch.Tensor, orig: torch.Tensor, bins: Optional[Bins] = None,
                       cells: int = 1, with_rec: bool = False):
    """reorder_tile's plain version: the order by sort, the gathers, the
    live count."""
    order = (_binned_order(carry, *bins, cells) if bins is not None
             else _alive_first_order(carry[CAR_ALIVE]))
    carry = carry[:, order].contiguous()
    orig = orig[:, order].contiguous()
    live = (carry[CAR_ALIVE] > 0).sum(dtype=torch.int32).reshape(1)
    return carry, orig, live, (order if with_rec else None)


class ReorderScratch:
    """reorder_tile's device buffers for one range: the keys, the bucket
    table (and the per-bucket counts where they do not fit in shared
    memory), the carry out, two orig rows out (a call never writes the row
    it reads) and live.  Allocated at the first call, and again only for a
    larger launch or more buckets; a smaller launch takes their leading
    part."""

    def __init__(self):
        self._key = None
        self._bufs = {}

    def buffers(self, lib, n: int, binned: bool, cells: int, device) -> dict:
        table, counts = ctypes.c_longlong(0), ctypes.c_longlong(0)
        _raise_on(lib, lib.ipt_reorder_sizes(n, int(binned), cells, ctypes.byref(table),
                                             ctypes.byref(counts)), "reorder reorder_tile")
        cap = self._key
        if cap is None or cap[0] != device or n > cap[1] or table.value > cap[2] or (
                counts.value > cap[3]):
            i32 = dict(dtype=torch.int32, device=device)
            self._bufs = dict(
                keys=torch.empty(n, **i32), table=torch.empty(table.value, **i32),
                counts=torch.empty(counts.value, **i32) if counts.value else None,
                carry=torch.empty(CARRY_ROWS * n, dtype=torch.float32, device=device),
                orig=(torch.empty(n, **i32), torch.empty(n, **i32)),
                live=torch.empty(1, **i32))
            self._key = (device, n, table.value, counts.value)
        b = self._bufs
        return dict(keys=b["keys"], table=b["table"], counts=b["counts"],
                    carry=b["carry"][: CARRY_ROWS * n].view(CARRY_ROWS, n),
                    orig=tuple(o[:n].view(1, n) for o in b["orig"]), live=b["live"])


@spanned("ipt.launch.reorder_tile")
def reorder_tile(carry: torch.Tensor, orig: torch.Tensor, bins: Optional[Bins] = None,
                 cells: int = 1, with_rec: bool = False, *,
                 scratch: Optional[ReorderScratch] = None):
    """The stable re-sort of a launch's lanes before a stage: (carry, orig,
    live, order or None), see the module's docstring."""
    n = carry.shape[1]
    _check(carry, {"carry": (carry, (CARRY_ROWS, n), torch.float32),
                   "orig": (orig, (1, n), torch.int32)})
    if bins is not None:
        _check(carry, {"lo": (bins[0], (3,), torch.float32),
                       "inv_ext": (bins[1], (3,), torch.float32)})
    if cells < 1:
        raise ValueError(f"cells must be >= 1, got {cells}")
    if carry.device.type == "cpu":
        return reorder_tile_plain(carry, orig, bins, cells, with_rec)
    if carry.device.type != "cuda":
        raise ValueError(f"reorder_tile runs on CUDA or CPU tensors, got {carry.device}")
    lib = _library("reorder")
    dev = carry.device
    with torch.cuda.device(dev):
        buf = (scratch or ReorderScratch()).buffers(lib, n, bins is not None, cells, dev)
        out = buf["carry"]
        if out.data_ptr() == carry.data_ptr():  # never in place: a fresh carry
            out = torch.empty_like(carry)
        orig_out = next(o for o in buf["orig"] if o.data_ptr() != orig.data_ptr())
        order = torch.empty(n, dtype=torch.int64, device=dev) if with_rec else None
        lo, inv_ext = (None, None) if bins is None else bins
        err = lib.ipt_reorder_tile(
            carry.data_ptr(), orig.data_ptr(), n, _ptr(lo), _ptr(inv_ext), cells,
            buf["keys"].data_ptr(), buf["table"].data_ptr(), _ptr(buf["counts"]),
            out.data_ptr(), orig_out.data_ptr(), _ptr(order), buf["live"].data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(lib, err, "reorder reorder_tile")
    reorder_tile.launches += 1
    return out, orig_out, buf["live"], order


reorder_tile.launches = 0
