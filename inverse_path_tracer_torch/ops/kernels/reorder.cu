// The staged wavefront's re-sort of the lane carry between stages, for
// Hopper (sm_90a): a stable counting sort of a launch's lanes by bucket.
//
// It replaces no TPU kernel: the JAX package re-sorts with XLA between its
// stage kernels (render/forward.py:620 _alive_first_order, :635
// _binned_order, then gathers), and the port did so in PyTorch
// (ops/kernels/reorder_kernel.py reorder_tile_plain: a key in ~20 tensor
// ops, a 64-bit radix sort, gathers of the carry and orig, a live count).
// The key has few values, so a counting sort does the same work in three
// launches.
//
// A lane's bucket (its sort key) is, on binned (clustered) scenes,
// (dead * 8 + direction octant) * cells^3 + origin cell, with the cell of
// the point in a cells^3 grid over the scene's box, computed by the same
// float32 operations in the same order as _bin_keys (this file is compiled
// with -fmad=false, build.py); elsewhere it is dead alone (alive first).
// Buckets below `live buckets` (8 * cells^3, or 1) hold the live lanes.
//
//   key_kernel    one block per tile of kTile lanes: each lane's bucket to
//                 keys, the tile's histogram (warp-aggregated shared-memory
//                 atomics) to column `block` of the (buckets, blocks) table;
//   scan_kernel   one block per bucket: the exclusive prefix of its row of
//                 the table over the tiles, in place, and the row's total;
//   rank_kernel   one block per tile again: each warp counts its chunk's
//                 lanes per bucket; prefixes over the warps and the buckets
//                 give each warp its first position in the tile's bucket
//                 order, and each lane's rank within its warp's 32-lane step
//                 (__match_any_sync, popc of the lower peers) its position.
//                 A bucket's first column is the totals of the buckets
//                 before it (every block takes that prefix itself; block 0
//                 writes *live, the prefix at the first dead bucket) plus
//                 its row's prefix at the tile.  The carry rows, orig (and,
//                 when the caller keeps it, the old column, order) go
//                 through shared memory in position order, so that
//                 consecutive threads store to a bucket's consecutive
//                 columns.
//
// Lanes of a tile go to warps in contiguous chunks, warps in order, so
// the rank of a lane is the count of lanes before it, in index order, of
// its own bucket plus all lanes of lower buckets: the result is, element
// for element, torch.sort(key, stable=True) and the gathers through it.
//
// Bound: the carry (24 floats) and orig in once and out once, 200 bytes a
// lane, 0.063 ms at 2^20 lanes at 3.35 TB/s; key_kernel's read of the 7 key
// rows and the keys written and read again add 36 bytes a lane.  The loads
// are coalesced.  Stored straight from the lanes, a warp's stores fell
// into as many runs as its step had buckets, and on a stage whose rays had
// scattered (every step holding several octants and cells) the binned
// re-sort took 0.92 ms at 2^20 lanes on the H100; staged through shared
// memory, a store run is a bucket's share of the 2048-lane tile.  One
// block scanning the whole (128, 512) table took most of the rest.  Two
// rows staged at a time ran 6% faster than four (more blocks an SM), tiles
// of 4096 lanes and of 1024 slower.  The per-bucket counts live in shared memory while
// (kWarps + 1) * buckets ints fit beside the staged rows (bin_cells <= 7)
// and in a device scratch beyond; the table and the totals are in device
// memory.

#include "render_common.cuh"

namespace {

// Threads of the key and rank kernels, the shared-memory limits and the
// lane carry's rows (render_common.cuh).
using ipt::kAllLanes;
using ipt::kCarryRows;
using ipt::kMaxSmem;
using ipt::kSmemLimit;
using ipt::kThreads;
using ipt::kWarps;
constexpr int kItems = 8;  // 32-lane steps of each warp
constexpr int kWarpLanes = 32 * kItems;
constexpr int kTile = kThreads * kItems;  // lanes of a block
constexpr int kGroup = 2;  // carry rows staged in shared memory at a time
static_assert(kGroup >= 2 && kCarryRows % kGroup == 0,
              "orig and the old column are staged in the rows' space");
constexpr int kAliveRow = 17;  // the carry's rows: d 0:3, point 3:6, alive 17

int blocks_for(int n) { return (n + kTile - 1) / kTile; }

// The bucket of lane i (see the file's header; lo null: dead alone).
__device__ __forceinline__ int bucket_of(const float* __restrict__ carry, int n, int i,
                                         const float* lo, const float* inv_ext, int cells) {
  const int dead = carry[static_cast<size_t>(kAliveRow) * n + i] <= 0.f;
  if (lo == nullptr) return dead;
  int octant = 0, cell = 0;
#pragma unroll
  for (int a = 2; a >= 0; --a) {
    const float d = carry[static_cast<size_t>(a) * n + i];
    const float p = carry[static_cast<size_t>(3 + a) * n + i];
    octant = 2 * octant + (d > 0.f);
    // ((p - lo) * inv_ext) * cells, truncated toward zero (NaN to 0, out
    // of range saturated) as PyTorch's float32 to int32, then clamped.
    const float x = ((p - lo[a]) * inv_ext[a]) * static_cast<float>(cells);
    const int c = min(max(static_cast<int>(x), 0), cells - 1);
    cell = cells * cell + c;
  }
  return (dead * 8 + octant) * (cells * cells * cells) + cell;
}

// One block per tile: keys, and the tile's histogram into column
// blockIdx.x of the table (added atomically in device memory when
// kGlobal, the table zeroed first).
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
    key_kernel(const float* __restrict__ carry, int n, const float* lo, const float* inv_ext,
               int cells, int buckets, int* __restrict__ keys, int* __restrict__ table) {
  extern __shared__ int hist[];
  if constexpr (!kGlobal) {
    for (int b = threadIdx.x; b < buckets; b += kThreads) hist[b] = 0;
    __syncthreads();
  }
  const int blocks = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int first = blockIdx.x * kTile + threadIdx.x;
  int key[kItems];  // all loads first, then the histogram
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = first + it * kThreads;
    key[it] = i < n ? bucket_of(carry, n, i, lo, inv_ext, cells) : -1;
  }
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = first + it * kThreads, b = key[it];
    if (i < n) keys[i] = b;
    const unsigned peers = __match_any_sync(kAllLanes, b);
    if (b >= 0 && lane == __ffs(peers) - 1) {
      if constexpr (kGlobal) {
        atomicAdd(table + static_cast<size_t>(b) * blocks + blockIdx.x, __popc(peers));
      } else {
        atomicAdd(hist + b, __popc(peers));
      }
    }
  }
  if constexpr (!kGlobal) {
    __syncthreads();
    for (int b = threadIdx.x; b < buckets; b += kThreads)
      table[static_cast<size_t>(b) * blocks + blockIdx.x] = hist[b];
  }
}

// The exclusive prefix of x over the block's threads (kBlock of them), and
// their total in *total; warp_sums holds kBlock / 32 ints of shared memory
// that no other call may use at the same time.
template <int kBlock>
__device__ __forceinline__ int block_exclusive_sum(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kAllLanes, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kBlock / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kAllLanes, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kBlock / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kBlock / 32 - 1];
  return incl - x + (warp ? warp_sums[warp - 1] : 0);
}

// One block per bucket b: row b of the table (blocks entries, one per tile)
// to its exclusive prefix, in place, and its total to totals[b].
__global__ void __launch_bounds__(kThreads)
    scan_kernel(int* __restrict__ table, int blocks, int* __restrict__ totals) {
  __shared__ int warp_sums[kWarps];
  int* row = table + static_cast<size_t>(blockIdx.x) * blocks;
  int run = 0;
  for (int j0 = 0; j0 < blocks; j0 += kThreads) {  // the same trips in every thread
    const int j = j0 + threadIdx.x;
    const int c = j < blocks ? row[j] : 0;
    int chunk;
    const int ex = block_exclusive_sum<kThreads>(c, warp_sums, &chunk);
    if (j < blocks) row[j] = run + ex;
    run += chunk;
    __syncthreads();  // warp_sums again in the next chunk
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = run;
}

// One block per tile: the stable rank of each lane from the scanned table,
// and the scatter of its carry rows, orig and (order not null) old column.
// Warp w of the block holds lanes [tile + w * kWarpLanes, + kWarpLanes) in
// kItems steps of 32.  The block first sorts its lanes locally: each lane's
// position in the tile's bucket order (pos) and the new column of each
// position (dst, contiguous along a bucket's run).  Then kGroup carry rows
// at a time go to shared memory at their position and out from there in
// position order.  Shared memory: kGroup rows of kTile words, dst, pos,
// then base[kWarps * buckets] (warp w's next position of bucket b) and
// delta[buckets] (the new column of position p of bucket b is p +
// delta[b]); those two in the block's part of `counts` instead when
// kGlobal.  live_bucket: the first dead bucket.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
    rank_kernel(const float* __restrict__ carry_in, const int* __restrict__ orig_in, int n,
                const int* __restrict__ keys, const int* __restrict__ table,
                const int* __restrict__ totals, int buckets, int live_bucket, int* counts,
                float* __restrict__ carry_out, int* __restrict__ orig_out,
                long long* __restrict__ order, int* live) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[2][kWarps];
  float* stage = reinterpret_cast<float*>(smem);
  int* dst = smem + kGroup * kTile;
  int* pos = dst + kTile;
  int* base = kGlobal ? counts + static_cast<size_t>(blockIdx.x) * (kWarps + 1) * buckets
                      : pos + kTile;
  int* delta = base + kWarps * buckets;
  for (int j = threadIdx.x; j < kWarps * buckets; j += kThreads) base[j] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x * kTile;
  const int first = warp * kWarpLanes + lane;  // in the tile
  int* mine = base + warp * buckets;
  int key[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int i = tile + first + 32 * it;
    key[it] = i < n ? keys[i] : -1;
  }
  // This warp's count of each bucket.
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const unsigned peers = __match_any_sync(kAllLanes, key[it]);
    if (key[it] >= 0 && lane == __ffs(peers) - 1) mine[key[it]] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per bucket (a contiguous run of them a thread): the prefix over the
  // warps; over the buckets, the tile's counts (each warp's first position)
  // and the totals (the bucket's first column).
  const int per = (buckets + kThreads - 1) / kThreads;
  const int b0 = min(buckets, static_cast<int>(threadIdx.x) * per), b1 = min(buckets, b0 + per);
  int sum = 0, sum_total = 0, all;
  for (int b = b0; b < b1; ++b) {
    int run = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = base[w * buckets + b];
      base[w * buckets + b] = run;
      run += c;
    }
    delta[b] = run;
    sum += run;
    sum_total += totals[b];
  }
  int local = block_exclusive_sum<kThreads>(sum, warp_sums[0], &all);
  int column = block_exclusive_sum<kThreads>(sum_total, warp_sums[1], &all);
  for (int b = b0; b < b1; ++b) {
    const int c = delta[b];
    for (int w = 0; w < kWarps; ++w) base[w * buckets + b] += local;
    if (b == live_bucket && blockIdx.x == 0) *live = column;
    delta[b] = column + table[static_cast<size_t>(b) * gridDim.x + blockIdx.x] - local;
    local += c;
    column += totals[b];
  }
  __syncthreads();
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int b = key[it];
    const unsigned peers = __match_any_sync(kAllLanes, b);
    const int p = b >= 0 ? mine[b] + __popc(peers & lower) : 0;
    __syncwarp();
    if (b >= 0 && lane == __ffs(peers) - 1) mine[b] += __popc(peers);
    __syncwarp();
    if (b >= 0) {
      pos[first + 32 * it] = p;
      dst[p] = p + delta[b];
    }
  }
  __syncthreads();
  const int count = min(kTile, n - tile);
  for (int r0 = 0; r0 < kCarryRows; r0 += kGroup) {
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int j = threadIdx.x + it * kThreads;
      if (j < count) {
        const int p = pos[j];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          stage[g * kTile + p] = carry_in[static_cast<size_t>(r0 + g) * n + tile + j];
      }
    }
    __syncthreads();
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int j = threadIdx.x + it * kThreads;
      if (j >= count) continue;
      const int d = dst[j];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        carry_out[static_cast<size_t>(r0 + g) * n + d] = stage[g * kTile + j];
    }
    __syncthreads();
  }
  int* stage_i = smem;  // orig, then the old column
  for (int j = threadIdx.x; j < count; j += kThreads) {
    stage_i[pos[j]] = orig_in[tile + j];
    stage_i[kTile + pos[j]] = tile + j;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < count; j += kThreads) {
    const int d = dst[j];
    orig_out[d] = stage_i[j];
    if (order != nullptr) order[d] = stage_i[kTile + j];
  }
}

// The buckets of a call: 16 * cells^3 binned (lo not null), else 2; 0 when
// that overflows an int.
long long buckets_of(bool binned, int cells) {
  if (!binned) return 2;
  if (cells < 1) return 0;
  const long long c3 = static_cast<long long>(cells) * cells * cells;
  return cells > 1024 || 16 * c3 > INT_MAX ? 0 : 16 * c3;
}

// rank_kernel's shared memory: the staged rows, dst and pos, and base and delta
// unless they go to device memory (global_counts).
constexpr size_t kStageBytes = sizeof(int) * (kGroup + 2) * kTile;
size_t count_bytes(long long buckets) { return sizeof(int) * (kWarps + 1) * buckets; }
bool global_counts(long long buckets) {
  return kStageBytes + count_bytes(buckets) > static_cast<size_t>(kMaxSmem);
}

}  // namespace

extern "C" {

// The int32 scratch of a call on n lanes: the table (buckets * blocks) and
// the buckets' totals after it, and rank_kernel's per-bucket counts in
// device memory (0 where they fit in shared memory).  binned: the call
// passes lo.  Returns the cudaError_t.
int ipt_reorder_sizes(int n, int binned, int cells, long long* table, long long* counts) {
  const long long buckets = buckets_of(binned != 0, cells);
  if (n < 0 || buckets == 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = blocks_for(n);
  *table = buckets * (blocks + 1);
  *counts = global_counts(buckets) ? blocks * (kWarps + 1) * buckets : 0;
  return 0;
}

// The stable re-sort of carry_in (24, n) and orig_in (1, n) into carry_out
// and orig_out, new column j holding old column order[j] (written when
// order is not null); *live (device) the live lanes, which come first.
// lo, inv_ext (3 device floats each) bin the lanes in cells^3 origin cells,
// or, null, the key is dead alone.  keys (n), table and counts are the
// scratch of ipt_reorder_sizes.  Returns the cudaError_t.
int ipt_reorder_tile(const float* carry_in, const int* orig_in, int n, const float* lo,
                     const float* inv_ext, int cells, int* keys, int* table, int* counts,
                     float* carry_out, int* orig_out, long long* order, int* live,
                     void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool binned = lo != nullptr;
  const long long buckets = buckets_of(binned, cells);
  if (n < 0 || buckets == 0 || (binned && inv_ext == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(live, 0, sizeof(int), s));
  const int blocks = blocks_for(n);
  const bool global = global_counts(buckets);
  if (global && counts == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = static_cast<int>(buckets);
  int* totals = table + buckets * blocks;
  cudaError_t err = cudaSuccess;
  if (global) {
    err = cudaMemsetAsync(table, 0, sizeof(int) * buckets * blocks, s);
    if (err != cudaSuccess) return static_cast<int>(err);
    key_kernel<true><<<blocks, kThreads, 0, s>>>(carry_in, n, lo, inv_ext, cells, nb, keys,
                                                  table);
  } else {
    key_kernel<false><<<blocks, kThreads, sizeof(int) * nb, s>>>(carry_in, n, lo, inv_ext,
                                                                 cells, nb, keys, table);
  }
  scan_kernel<<<nb, kThreads, 0, s>>>(table, blocks, totals);
  const size_t dyn = kStageBytes + (global ? 0 : count_bytes(buckets));
  auto rank = global ? rank_kernel<true> : rank_kernel<false>;
  if (dyn > static_cast<size_t>(kSmemLimit))
    err = cudaFuncSetAttribute(rank, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(dyn));
  if (err != cudaSuccess) return static_cast<int>(err);
  rank<<<blocks, kThreads, dyn, s>>>(carry_in, orig_in, n, keys, table, totals, nb,
                                     binned ? nb / 2 : 1, counts, carry_out, orig_out, order,
                                     live);
  return static_cast<int>(cudaGetLastError());
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
