"""The regenerating schedule of B1, B2 and B3 on the CPU, through a Python
mirror transcribed from render_common.cuh (warp_rays, take_ray) and the
loops of render_fwd.cu render_kernel and render_bwd.cu grad_tile_kernel,
the persistent grids of B7 and B9 (render_common.cuh warp_chunks: fixed
per-warp ranges of 32-lane chunks), and the CPU routes of the wrappers.
No JAX is needed.  The mirror holds the schedule's design; the card tests
(tests/test_torch_cuda.py) hold the CUDA code itself.

Path lengths are drawn with numpy from a seed: a live ray enters 1 to
max_bounces bounces, a dead one (alive = 0) none.
"""

import os
from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401

from inverse_path_tracer_torch import ASSET_ROOT, RenderConfig, load_scene
from inverse_path_tracer_torch.ops import rng
from inverse_path_tracer_torch.ops.kernels.render_kernel import (
    grad_tile,
    grad_tile_plain,
    persistent_blocks,
    render_tile_rec,
    render_tile_rec_plain,
)
from inverse_path_tracer_torch.render.forward import camera_rays

BLOCK = 256  # threads per block (render_common.cuh kThreads)
LANES = 32
WARPS = BLOCK // LANES


def warp_range(n: int, blocks: int, warp: int) -> Tuple[int, int]:
    """The rays [lo, hi) of global warp `warp` (blockIdx.x * WARPS + warp
    in the block) of a grid of `blocks` blocks: per = ceil(n / warps) each,
    cut at n (render_common.cuh warp_rays)."""
    warps = blocks * WARPS
    per = -(-n // warps)
    lo = warp * per
    return min(lo, n), min(lo + per, n)


def take_ray(nxt: int, end: int, asks: Sequence[bool]) -> Tuple[List[int], int]:
    """One hand-out (render_common.cuh take_ray): each lane that asks gets
    the next ray of [nxt, end) in lane order, or -1 once the range is used
    up.  Returns (the ray of each lane, -1 where it did not ask, and the new
    nxt)."""
    out, k = [], 0
    for ask in asks:
        i = nxt + k
        out.append(i if ask and i < end else -1)
        k += bool(ask)
    return out, min(nxt + k, end)


class Event(NamedTuple):
    round: int
    lane: int
    ray: int


class WarpTrace(NamedTuple):
    starts: List[Event]  # a lane takes a ray (a dead ray, path length 0, too)
    ends: List[Tuple[Event, int]]  # a path ends (its recursion runs), with its length
    rounds: int  # rounds the warp's loop ran


def simulate(n: int, blocks: int, warp: int, path_len: Sequence[int]) -> WarpTrace:
    """The loop of one warp (render_fwd.cu render_kernel, render_bwd.cu
    grad_tile_kernel) over its range, given each ray's path length: the
    bounces it enters (n_reached: at least 1 for a live ray, 0 for a dead
    one, alive = 0).  A lane that traces a ray enters one bounce a round;
    where that bounce is the path's last, the path ends in that round, its
    recursion runs, and the lane asks for a ray in the same round."""
    nxt, end = warp_range(n, blocks, warp)
    has = [False] * LANES
    ray = [-1] * LANES
    b = [0] * LANES
    starts: List[Event] = []
    ends: List[Tuple[Event, int]] = []
    rnd = 0
    while True:
        for lane in range(LANES):
            if has[lane]:
                b[lane] += 1
                if b[lane] == path_len[ray[lane]]:
                    ends.append((Event(rnd, lane, ray[lane]), b[lane]))
                    has[lane] = False
        got, nxt = take_ray(nxt, end, [not h for h in has])
        for lane, i in enumerate(got):
            if i >= 0:
                starts.append(Event(rnd, lane, i))
                ray[lane], b[lane] = i, 0
                has[lane] = path_len[i] > 0
        rnd += 1
        if nxt >= end and not any(has):
            return WarpTrace(starts, ends, rnd)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_BOUNCES = 16
RING = 16  # render_bwd.cu grad_tile_kernel<16, ...>: slots of a lane's record ring


def path_lengths(n, seed, dead_share=0.1):
    """Geometric-like lengths in [1, MAX_BOUNCES] (roulette at 0.9 plus
    escapes), 0 for a share of dead rays."""
    r = np.random.default_rng(seed)
    lengths = np.minimum(r.geometric(0.12, size=n), MAX_BOUNCES)
    lengths[r.random(n) < dead_share] = 0
    return lengths.tolist()


def run_grid(n, blocks, lengths):
    return [simulate(n, blocks, w, lengths) for w in range(blocks * WARPS)]


@pytest.mark.parametrize("n, capacity", [(0, 396), (1, 396), (1000, 1), (4099, 396),
                                         (1 << 20, 396), ((1 << 20) + 77, 1 << 20)])
def test_grid_and_warp_ranges_partition_the_launch(n, capacity):
    blocks = persistent_blocks(n, capacity)
    assert blocks == min(capacity, -(-n // BLOCK))
    assert (blocks == 0) == (n == 0)
    if n == 0:
        return
    ranges = [warp_range(n, blocks, w) for w in range(blocks * WARPS)]
    per = -(-n // (blocks * WARPS))
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert lo <= hi == lo2 and hi - lo <= per
    assert sum(hi - lo for lo, hi in ranges) == n


def test_take_ray_hands_out_in_lane_order():
    asks = [False] * LANES
    for lane in (0, 3, 4, 31):
        asks[lane] = True
    got, nxt = take_ray(10, 100, asks)
    assert [got[k] for k in (0, 3, 4, 31)] == [10, 11, 12, 13] and nxt == 14
    assert all(got[k] == -1 for k in range(LANES) if not asks[k])
    got, nxt = take_ray(98, 100, asks)  # the range runs out: the later lanes get none
    assert [got[k] for k in (0, 3, 4, 31)] == [98, 99, -1, -1] and nxt == 100


@pytest.mark.parametrize("n, blocks, seed", [(1000, 1, 0), (4099, 2, 1), (777, 3, 2),
                                             (20000, 5, 3)])
def test_every_ray_is_traced_once(n, blocks, seed):
    lengths = path_lengths(n, seed)
    traces = run_grid(n, blocks, lengths)
    starts = sorted(e.ray for t in traces for e in t.starts)
    assert starts == list(range(n))
    ended = sorted(e.ray for t in traces for e, _ in t.ends)
    assert ended == [i for i in range(n) if lengths[i] > 0]
    for t in traces:
        start_round = {e.ray: e.round for e in t.starts}
        lane_of = {e.ray: e.lane for e in t.starts}
        for e, k in t.ends:
            # One bounce per round from the round after the hand-out; the
            # last one in the round the path ends, on the lane it started on.
            assert k == lengths[e.ray] and e.lane == lane_of[e.ray]
            assert e.round - start_round[e.ray] == k
            # The ring slots of its bounces, read back by the recursion at
            # (round - j) mod RING, are distinct: no slot is overwritten.
            slots = {(e.round - j) % RING for j in range(k)}
            assert len(slots) == k
        # A lane traces one ray at a time.
        busy = {}
        for e in sorted(t.starts):
            assert busy.get(e.lane, -1) <= e.round
            busy[e.lane] = e.round + lengths[e.ray]


def test_dead_lanes_take_no_round_of_their_own():
    n, blocks = 512, 1
    lengths = [0] * n  # alive = 0 everywhere: a range past the last sample
    traces = run_grid(n, blocks, lengths)
    assert sorted(e.ray for t in traces for e in t.starts) == list(range(n))
    assert all(not t.ends for t in traces)
    assert max(t.rounds for t in traces) <= -(-n // (blocks * WARPS * LANES)) + 1


@pytest.mark.parametrize("seed", [4, 5])
def test_a_warps_sum_order_depends_only_on_its_rays_lengths(seed):
    """The order in which a warp's recursions run (the order of its adds)
    is a function of (n, grid, the path lengths of its own rays)."""
    n, blocks = 4099, 2
    lengths = path_lengths(n, seed)
    warp = 5
    lo, hi = warp_range(n, blocks, warp)
    base = simulate(n, blocks, warp, lengths)
    assert simulate(n, blocks, warp, list(lengths)) == base
    others = list(lengths)
    r = np.random.default_rng(seed + 100)
    for i in list(range(0, lo)) + list(range(hi, n)):
        others[i] = int(r.integers(0, MAX_BOUNCES + 1))
    assert simulate(n, blocks, warp, others) == base
    mine = list(lengths)
    k = next(i for i in range(lo, hi) if 0 < mine[i] < MAX_BOUNCES)
    mine[k] += 1
    assert simulate(n, blocks, warp, mine).ends != base.ends


def test_regeneration_takes_fewer_rounds_than_a_ray_a_thread():
    """A warp of whole paths runs as long as the longest of each 32; the
    regenerating warp about the mean path length per ray."""
    n, blocks = 1 << 14, 4
    lengths = path_lengths(n, 6, dead_share=0.0)
    for w in (0, 7, 31):
        lo, hi = warp_range(n, blocks, w)
        whole = sum(max(lengths[j:j + LANES]) for j in range(lo, hi, LANES))
        regen = simulate(n, blocks, w, lengths).rounds
        assert regen < 0.75 * whole


B9_WARPS = 4  # warps per block of B9 (render_bwd.cu kB9Warps)


def b9_warp_lanes(n: int, blocks: int, warp: int, warps_per_block: int = B9_WARPS
                  ) -> List[List[int]]:
    """The chunks of 32 neighbouring lanes that global warp `warp` of a
    grid of `blocks` blocks of `warps_per_block` warps walks, in its order
    (render_common.cuh warp_chunks; B9 runs B9_WARPS warps a block, B7
    B7_THREADS // 32): chunks [w * C / W, (w + 1) * C / W) of the C =
    ceil(n / 32) chunks, W warps in all, cut at n."""
    chunks, total = -(-n // 32), blocks * warps_per_block
    lo = warp * chunks // total * 32
    hi = min((warp + 1) * chunks // total * 32, n)
    return [list(range(base, min(base + 32, hi))) for base in range(lo, hi, 32)]


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4099, (1 << 20) + 77])
@pytest.mark.parametrize("capacity", [396, 1188, 132, 1])
def test_b9_warps_cover_every_lane_once_in_a_fixed_order(n, capacity):
    # The grid of render_bwd.cu ipt_stage_reverse_blocks: at most one block
    # per B9_WARPS * 32 lanes, as persistent_blocks cuts B1-B3's.
    blocks = persistent_blocks(n, capacity, B9_WARPS * LANES)
    assert blocks == min(capacity, -(-n // (B9_WARPS * LANES))) >= 1
    walks = [b9_warp_lanes(n, blocks, w) for w in range(blocks * B9_WARPS)]
    # Every lane once, in the order of the warps and their chunks.
    assert [i for walk in walks for chunk in walk for i in chunk] == list(range(n))
    counts = [len(walk) for walk in walks]
    assert max(counts) - min(counts) <= 1  # whole chunks, balanced over the warps
    for walk in walks:
        for chunk in walk:
            # A chunk is neighbouring lanes from a multiple of 32: its loads coalesce.
            assert chunk[0] % 32 == 0 and chunk == list(range(chunk[0], chunk[-1] + 1))
    # The order depends on (n, the grid) only.
    assert walks == [b9_warp_lanes(n, blocks, w) for w in range(blocks * B9_WARPS)]


B7_THREADS = 512  # threads per block of B7 (render_fwd.cu kInitThreads)


@pytest.mark.parametrize("n", [1, 31, 33, 1000, 4099, (1 << 20) + 77])
@pytest.mark.parametrize("capacity", [264, 528, 132, 1])
def test_b7_warps_cover_every_lane_once_in_a_fixed_order(n, capacity):
    # B7's grid (render_fwd.cu ipt_init_blocks): the blocks that fit, at
    # most one per B7_THREADS lanes, as persistent_blocks cuts B1-B3's.
    blocks = persistent_blocks(n, capacity, B7_THREADS)
    assert blocks == min(capacity, -(-n // B7_THREADS)) >= 1
    warps = B7_THREADS // LANES
    walks = [b9_warp_lanes(n, blocks, w, warps) for w in range(blocks * warps)]
    assert [i for walk in walks for chunk in walk for i in chunk] == list(range(n))
    counts = [len(walk) for walk in walks]
    assert max(counts) - min(counts) <= 1
    assert all(chunk[0] % 32 == 0 for walk in walks for chunk in walk)


@pytest.fixture(scope="module")
def scene0():
    return load_scene(os.path.join(REPO, "scenes", "0.txt"), asset_root=ASSET_ROOT)


def tile(scene, cfg, seed):
    n = cfg.n_samples
    idx = torch.arange(n)
    p, d = camera_rays(scene, cfg, seed, idx)
    alive = torch.ones((1, n))
    alive[0, -5:] = 0.0  # a few dead lanes
    return dict(p=p.T.contiguous(), d=d.T.contiguous(), alive=alive,
                orig=idx.to(torch.int32)[None, :].contiguous(), keys=rng.key_words(seed))


def test_cpu_tensors_take_the_plain_versions(scene0):
    """On the CPU the wrappers of B2 and B3 run their plain versions: the
    same outputs and shapes, no launch counted, no grid recorded."""
    cfg = RenderConfig(width=8, height=8, spp=2, max_bounces=5)
    a = tile(scene0, cfg, 3)
    n = cfg.n_samples
    g = torch.from_numpy(np.random.default_rng(7).random((3, n)).astype(np.float32))
    mats = scene0.diffuse
    before = (render_tile_rec.launches, grad_tile.launches, render_tile_rec.blocks,
              grad_tile.blocks)
    rad, stats, rec = render_tile_rec(mats, scene0, cfg, **a)
    dm = grad_tile(mats, scene0, cfg, g=g, **a)
    assert (render_tile_rec.launches, grad_tile.launches, render_tile_rec.blocks,
            grad_tile.blocks) == before
    assert rad.shape == (3, n) and stats.shape == (2, n)
    assert rec.shape == (cfg.max_bounces * 16, n) and dm.shape == (scene0.n_tri, 3)
    rp, sp, recp = render_tile_rec_plain(mats, scene0, cfg, **a)
    assert torch.equal(rad, rp) and torch.equal(stats, sp) and torch.equal(rec, recp)
    assert torch.equal(dm, grad_tile_plain(mats, scene0, cfg, g=g, **a))
    assert not rad[:, -5:].any() and not stats[:, -5:].any() and not rec[:, -5:].any()
    # The records are zero past each ray's last bounce (its segment count).
    past = torch.arange(cfg.max_bounces)[:, None] >= stats[0].long()[None, :]
    assert not rec.view(cfg.max_bounces, 16, n)[past.unsqueeze(1).expand(-1, 16, -1)].any()


def test_cpu_tensors_take_the_plain_reverse_and_init(scene0):
    """On the CPU the wrappers of B4, B7 and B9 run their plain versions:
    no launch counted, no grid recorded (B7, B9); B4 is B9's recursion over
    the whole record array from a zero carry."""
    from inverse_path_tracer_torch.ops.kernels.render_kernel import reverse_tile, reverse_tile_plain
    from inverse_path_tracer_torch.ops.kernels.staged_kernel import (
        init_tile,
        init_tile_plain,
        stage_reverse_tile,
    )

    cfg = RenderConfig(width=8, height=6, spp=3, max_bounces=7)
    a = tile(scene0, cfg, 4)
    n = cfg.n_samples
    g = torch.from_numpy(np.random.default_rng(8).random((3, n)).astype(np.float32))
    mats = scene0.diffuse
    _, _, rec = render_tile_rec_plain(mats, scene0, cfg, **a)
    wrappers = (reverse_tile, init_tile, stage_reverse_tile)
    before = [(f.launches, getattr(f, "blocks", None)) for f in wrappers]
    d4 = reverse_tile(scene0.n_tri, cfg, rec, g)
    carry = init_tile(mats, scene0, cfg, a["p"], a["d"], a["alive"])
    d9, suf = stage_reverse_tile(scene0.n_tri, cfg, cfg.max_bounces, rec, g, torch.zeros((4, n)))
    assert [(f.launches, getattr(f, "blocks", None)) for f in wrappers] == before
    assert torch.equal(d4, reverse_tile_plain(scene0.n_tri, cfg, rec, g))
    assert torch.equal(d4, d9) and suf.shape == (4, n) and float(d4.abs().sum()) > 0
    assert torch.equal(carry, init_tile_plain(mats, scene0, cfg, a["p"], a["d"], a["alive"]))
    assert not carry[17, -5:].any()  # the dead lanes

