// Backward kernels of the material gradient for Hopper (sm_90a).
//
// B2, grad_tile_kernel, replaces the JAX package's fused backward
// grad_tile_pallas / _kernel_bwd + _suffix_recursion
// (inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1505, :946, :1007).
// It replays B1's path of each ray (init and bounce steps of
// render_common.cuh, the same code under the same -fmad=false, so the
// replay takes the forward's branches), keeps each reached bounce's record
// in a per-thread ring, and at the path's end runs the suffix recursion
// backwards from the last reached bounce (render/diff.py in the JAX
// package, :94-110):
//     ct  = pm * suf * coeff/pi + [hit] g * pm * nee
//           + [quirks and escape at k+1] g * (pm * f) * nee
//     suf = g * c + f * suf
// and adds ct into d materials[tri] for every bounce that hit.
//
// B4, reverse_tile_kernel, replaces reverse_tile_pallas / _kernel_reverse
// (render_kernel.py:1640, :1065): the recursion alone, on the records that
// B3 (render_fwd.cu render_kernel<true, ...>) wrote to global memory.
//
// B9, stage_reverse_kernel, replaces stage_reverse_tile_pallas /
// _kernel_stage_reverse (render_kernel.py:1780, :1263): the recursion over
// the k slots of one stage's records (B8's), started from the (suf, esc)
// carry of the later stages and returning the carry toward the earlier
// ones; the host re-orders the carry to the previous stage's lanes between
// launches.  Like B4 it is bound by the bytes of the reached records.
//
// Schedules.  B4 runs one thread per ray, the recursion warp by warp to
// the warp's longest path (reverse_path).  Its loads fetch whole 32-byte
// sectors of the records' rows whether or not every lane of the sector
// reached the slot, and with up to 48 warps an SM this kernel streams them
// faster than persistent blocks that load a lane's slots in groups, as B9
// does (PERF.md, B4's row).  B9 runs persistent blocks whose
// warps walk fixed ranges of lanes 32 at a time, each lane loading all of
// its slots (at most 4) before the recursion (stage_reverse_kernel), so
// that a block clears its accumulators once and writes one partial for
// its share of the launch instead of one per 256 lanes.  B2 runs persistent
// blocks
// whose lanes take a new ray when their path ends (render_common.cuh
// warp_rays; grad_tile_kernel): under roulette a path averages about half
// of its 16 bounces, and a warp of whole paths idled about half its lanes.
// Its records sit in the ring slot of the round each bounce ran in, so the
// lanes of a warp address one slot at a time, whatever bounce each is at,
// and its local-memory accesses stay coalesced.
//
// Reduction.  Within a warp, lanes that add to the same triangle are
// grouped with __match_any_sync and summed in a fixed tree over lane order
// (warp_add, warp_sum_by_key); the group's lowest lane adds the sum to the
// warp's own (nT, 3) row of shared memory.  At the end the block sums its
// warps' rows in warp order and writes one (nT, 3) partial; the wrapper
// sums the partials over blocks in a fixed order.  No atomics are used, and B2's
// hand-out of rays to lanes depends only on (n, the grid, the path
// lengths), so every result is bit-reproducible from run to run on one card
// (it does depend on how rays fall into warps and blocks, as any float sum
// depends on its order).  Shared memory holds one (nT, 3) row of
// accumulators per warp and, for B2, when they fit beside them, the scene
// tables.  Where a block's rows do not fit in shared memory (past ~2,400
// triangles for B2 and B4, ~4,800 for B9: acc_in_smem), the kGlobalAcc
// instances keep them in a scratch buffer in global memory, (blocks,
// warps, nT, 3) floats that the wrapper allocates, each warp's row its own,
// so still no atomics: the block clears its rows, its warps add into them,
// and it sums them in warp order into its partial, as in shared memory.
// Those instances run at most kGlobalAccBlocksPerSm blocks per SM, which
// bounds the scratch (B4's then walk their rays block by block), and the
// shared-memory instances are unchanged.
//
// Bound.  B2 does B1's work again (the closest-hit searches, f32 ALU) plus
// the recursion, ~40 f32 operations and a warp sum per reached bounce, and
// moves 2 x 56 bytes per reached bounce through local memory (L1 and L2).
// B4 reads the records of the reached bounces (64 bytes each) and a flag
// pair where a ray stopped early: it is bound by those bytes.

#include "render_common.cuh"

namespace {

using namespace ipt;

constexpr int kLocalFields = 14;  // f(3) c(3) nee(3) pm(3) coeff tri

struct Rec {
  V3 f, c, nee, pm;
  float coeff;
  int tri;
};

// B2's records: the fields the recursion reads, in a per-thread array
// (local memory) of kCap slots, a power of two, used as a ring.
template <int kCap>
struct LocalRecords {
  float v[kCap][kLocalFields];
  __device__ __forceinline__ void put(int b, V3 f, V3 c, V3 nee, V3 pm, float coeff, int tri,
                                      bool, bool) {
    float* r = v[b];
    r[0] = f.x, r[1] = f.y, r[2] = f.z;
    r[3] = c.x, r[4] = c.y, r[5] = c.z;
    r[6] = nee.x, r[7] = nee.y, r[8] = nee.z;
    r[9] = pm.x, r[10] = pm.y, r[11] = pm.z;
    r[12] = coeff;
    r[13] = __int_as_float(tri);
  }
  __device__ __forceinline__ Rec load(int k) const {
    const float* r = v[k];
    return Rec{ld3(r), ld3(r + 3), ld3(r + 6), ld3(r + 9), r[12], __float_as_int(r[13])};
  }
};

// B4's records: B3's rows in global memory.
struct GlobalSource {
  const float* rec;
  int n, i;
  __device__ __forceinline__ float row(int k, int r) const {
    return rec[static_cast<size_t>(k * kRecRows + r) * n + i];
  }
  __device__ __forceinline__ Rec load(int k) const {
    return Rec{v3(row(k, 0), row(k, 1), row(k, 2)), v3(row(k, 3), row(k, 4), row(k, 5)),
               v3(row(k, 6), row(k, 7), row(k, 8)), v3(row(k, 9), row(k, 10), row(k, 11)),
               row(k, 12), static_cast<int>(row(k, 13))};
  }
};

// Adds each lane's ct to acc[key] (key >= 0): all 32 lanes of the warp
// call it together, the lanes that share a key are summed in a fixed tree
// over lane order (warp_sum_by_key) and the lowest of them adds the sum to
// this warp's row.
__device__ __forceinline__ void warp_add(int key, V3 ct, float* acc) {
  float v[3] = {ct.x, ct.y, ct.z};
  int count = 0;
  if (warp_sum_by_key(kAllLanes, key >= 0, key, v, &count)) {
    float* a = acc + 3 * key;
    a[0] += v[0];
    a[1] += v[1];
    a[2] += v[2];
  }
  __syncwarp();
}

// One step of the suffix recursion, on the record x of a reached bounce
// (`esc`: the path escaped there): sets ct, the cotangent to add into
// d materials[key], and moves the carry (suf, esc_next) to the bounce
// before.  Returns key, -1 where the bounce escaped (it adds nothing).
__device__ __forceinline__ int recurse_step(const Rec& x, bool esc, V3 g, int quirks,
                                            float inv_pi, V3& suf, bool& esc_next, V3& ct) {
  int key = -1;
  ct = zero3();
  if (!esc) {
    // d f / d kd = coeff / pi; d l_d / d kd = nee.
    ct = x.pm * suf * (x.coeff * inv_pi) + g * x.pm * x.nee;
    // Q2: the stale l_d re-added on escape at k+1 is bounce k's.
    if (quirks && esc_next) ct = ct + g * (x.pm * x.f) * x.nee;
    key = x.tri;
  }
  suf = g * x.c + x.f * suf;
  esc_next = esc;
  return key;
}

// The suffix recursion of one ray over its n_reached records, warp by
// warp, from the carry (suf, esc_next) of the bounces after the last slot
// (zero for a whole path), which it leaves at the carry toward the bounces
// before slot 0.  Every lane runs the warp's longest path length; a lane's
// unreached slots are zero records, which add nothing and set suf to
// 0 * suf, as in the JAX package's recursion (for a whole path suf is then
// already 0).  acc is this warp's (nT, 3) row.
template <class Records>
__device__ __forceinline__ void reverse_path(const Records& r, int n_slots, int n_reached,
                                             bool escaped, V3 g, int quirks, float inv_pi,
                                             float* acc, V3& suf, bool& esc_next) {
  const int k_top = __reduce_max_sync(kAllLanes, n_reached);
  if (n_reached < n_slots) {
    suf = g * 0.f + suf * 0.f;
    esc_next = false;
  }
  for (int k = k_top - 1; k >= 0; --k) {
    int key = -1;
    V3 ct = zero3();
    if (k < n_reached)
      key = recurse_step(r.load(k), escaped && k == n_reached - 1, g, quirks, inv_pi, suf,
                         esc_next, ct);
    else
      esc_next = false;
    warp_add(key, ct, acc);
  }
}

// The reached slots of a ray in records of `slots` bounces: the leading
// slots with hit or esc set; *escaped says whether the last one escaped.
__device__ __forceinline__ int reached_slots(const GlobalSource& src, int slots, bool* escaped) {
  int n_reached = 0;
  for (int k = 0; k < slots; ++k) {
    const float hit = src.row(k, 14), esc = src.row(k, 15);
    if (hit == 0.f && esc == 0.f) break;
    n_reached = k + 1;
    *escaped = esc != 0.f;
  }
  return n_reached;
}

// Blocks per SM of the kGlobalAcc instances (header comment).
constexpr int kGlobalAccBlocksPerSm = 2;

// Whether `warps` (nT, 3) rows of accumulators fit in a block's shared
// memory.
__host__ __device__ inline bool acc_in_smem(int n_tri, int warps) {
  return ((static_cast<size_t>(warps) * n_tri * 3 + 3) & ~size_t(3)) * sizeof(float) <=
         static_cast<size_t>(kMaxSmem);
}

// The accumulators of this block: its `warps` rows of the scratch buffer
// (kGlobalAcc), or of dynamic shared memory.
template <bool kGlobalAcc>
__device__ __forceinline__ float* block_acc(float* smem, float* scratch, int n_tri, int warps) {
  if constexpr (kGlobalAcc) {
    return scratch + static_cast<size_t>(blockIdx.x) * warps * n_tri * 3;
  } else {
    return smem;
  }
}

// The block's accumulators: `rows` (nT, 3) rows, one per warp.
__device__ __forceinline__ void zero_acc(float* acc, int n_tri, int rows = kWarps) {
  for (int e = threadIdx.x; e < rows * n_tri * 3; e += blockDim.x) acc[e] = 0.f;
}

// The block's (nT, 3) partial: its warps' rows summed in warp order.
__device__ __forceinline__ void write_partial(const float* acc, int n_tri, float* partials,
                                              int rows = kWarps) {
  const int m = n_tri * 3;
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < rows; ++w) s += acc[w * m + e];
    partials[static_cast<size_t>(blockIdx.x) * m + e] = s;
  }
}

__device__ __forceinline__ V3 load_g(const float* g, int n, int i) {
  return v3(g[i], g[n + i], g[2 * n + i]);
}

// Floats of the per-warp accumulators, padded to 16 bytes.
__host__ __device__ inline size_t acc_floats(int n_tri) {
  return (static_cast<size_t>(kWarps) * n_tri * 3 + 3) & ~size_t(3);
}

// The suffix recursion of the lanes whose path ended this round (`done`),
// each over its own n_reached records, the last first, from a zero carry
// (render/diff.py's recursion, as reverse_path).  Every lane of the warp
// calls it; the steps run to the longest of those paths.  The records of a
// path's bounces sit in the ring slots of the rounds they ran in, so step j
// of every recursing lane reads slot (round - j) mod kCap: one slot for the
// whole warp.  acc is this warp's (nT, 3) row.
template <int kCap>
__device__ __forceinline__ void recurse_ended(const LocalRecords<kCap>& recs, bool done,
                                              int n_reached, bool escaped, V3 g, int round,
                                              int quirks, float inv_pi, float* acc) {
  const int steps = __reduce_max_sync(kAllLanes, done ? n_reached : 0);
  V3 suf = zero3();
  bool esc_next = false;
  for (int j = 0; j < steps; ++j) {
    int key = -1;
    V3 ct = zero3();
    if (done && j < n_reached)
      key = recurse_step(recs.load((round - j) & (kCap - 1)), escaped && j == 0, g, quirks,
                         inv_pi, suf, esc_next, ct);
    warp_add(key, ct, acc);
  }
}

// B2: persistent blocks whose lanes regenerate (render_common.cuh
// warp_rays), each lane replaying B1's path of its ray one bounce per
// round, with the bounce's record in slot (round mod kCap) of its ring.
// In the round a path ends, the lanes whose path ended run their
// recursions together (recurse_ended) and then take new rays; every lane
// with a pending ray then sweeps it together.  The hand-out depends only on
// (n, the grid, the path lengths), and every sum has a fixed order, so the
// gradient is the same in every run on one card.  kSweep is the search
// flavour (the BVH route's traversal included); kGlobalAcc keeps the
// accumulators in `scratch` (header comment).
template <int kCap, bool kGlobalAcc, int kSweep>
__global__ void __launch_bounds__(kThreads, min_blocks(kSweep))
    grad_tile_kernel(const TraceParams P, const float* g, float* partials, float* scratch) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* acc = block_acc<kGlobalAcc>(smem, scratch, P.n_tri, kWarps);
  zero_acc(acc, P.n_tri);
  const Tables T = stage_tables<kSweep>(P, kGlobalAcc ? smem : acc + acc_floats(P.n_tri));
  __syncthreads();

  float* warp_acc = acc + static_cast<size_t>(threadIdx.x >> 5) * P.n_tri * 3;
  WarpRays w = warp_rays(P.n);
  LocalRecords<kCap> recs;
  Lane L;
  V3 gi = zero3();
  uint32_t h_orig = 0;
  int i = 0, b = 0;  // the lane's ray, the bounce it enters next
  bool has = false;  // the lane traces a ray
  for (int round = 0;; ++round) {
    bool sweep = false, done = false, escaped = false;
    if (has) {
      float u[6];
      draw6(P, i, h_orig, b, b, u);
      escaped = !L.hit;
      const bool cont = bounce_step<kSweep, true>(P, T, L, b, u, recs, round & (kCap - 1));
      ++b;
      sweep = cont && b < P.max_bounces;
      done = !sweep;
    }
    recurse_ended(recs, done, b, escaped, gi, round, P.quirks, P.inv_pi, warp_acc);
    if (done) has = false;
    const int next = take_ray(w, !has);
    if (next >= 0) {
      i = next;
      L = fresh_lane(P, i);
      b = 0;
      if (L.alive) {
        L.point = ray_origin(P, i);
        h_orig = hash_orig(P, i);
        gi = load_g(g, P.n, i);
        has = sweep = true;
      }
    }
    if (w.next >= w.end && !__any_sync(kAllLanes, has)) break;
    if (sweep) sweep_from<kSweep>(P, T, L, L.point);
  }
  __syncthreads();
  write_partial(acc, P.n_tri, partials);
}

// B4's recursion of ray i (none past n) into this warp's row `acc`.
__device__ __forceinline__ void reverse_ray(const float* rec, const float* g, int n, int i,
                                            int max_bounces, int quirks, float inv_pi,
                                            float* acc) {
  const GlobalSource src{rec, n, i};
  int n_reached = 0;
  bool escaped = false;
  V3 gi = zero3();
  if (i < n) {
    n_reached = reached_slots(src, max_bounces, &escaped);
    gi = load_g(g, n, i);
  }
  V3 suf = zero3();
  bool esc_next = false;
  reverse_path(src, max_bounces, n_reached, escaped, gi, quirks, inv_pi, acc, suf, esc_next);
}

// B4: one thread per ray, one block per kThreads rays; the kGlobalAcc
// instance runs at most kGlobalAccBlocksPerSm blocks per SM, block b taking
// the kThreads-ray blocks b, b + gridDim.x, ... in order.
template <bool kGlobalAcc>
__global__ void __launch_bounds__(kThreads)
    reverse_tile_kernel(const float* rec, const float* g, int n, int n_tri, int max_bounces,
                        int quirks, float inv_pi, float* partials, float* scratch) {
  extern __shared__ float4 smem4[];
  float* acc = block_acc<kGlobalAcc>(reinterpret_cast<float*>(smem4), scratch, n_tri, kWarps);
  zero_acc(acc, n_tri);
  __syncthreads();

  float* warp_acc = acc + static_cast<size_t>(threadIdx.x >> 5) * n_tri * 3;
  if constexpr (kGlobalAcc) {
    for (long long base = static_cast<long long>(blockIdx.x) * kThreads; base < n;
         base += static_cast<long long>(gridDim.x) * kThreads)
      reverse_ray(rec, g, n, static_cast<int>(base) + threadIdx.x, max_bounces, quirks, inv_pi,
                  warp_acc);
  } else {
    reverse_ray(rec, g, n, blockIdx.x * blockDim.x + threadIdx.x, max_bounces, quirks, inv_pi,
                warp_acc);
  }
  __syncthreads();
  write_partial(acc, n_tri, partials);
}

// B9's recursion of one lane over its kPre preloaded slots (k <= kPre):
// reverse_path's steps in its order, on records that every lane loads
// before the first step (the hit and esc flags of all k slots at once,
// then the fields of the reached ones), so that a warp's loads overlap
// instead of waiting one slot at a time.  The slots are unrolled, so the
// records stay in registers.  Every lane of the warp calls it; lanes past
// the warp's range pass valid = false.
template <int kPre>
__device__ __forceinline__ void reverse_preloaded(const GlobalSource& src, bool valid, int k,
                                                  V3 g, int quirks, float inv_pi, float* acc,
                                                  V3& suf, bool& esc_next) {
  float hit[kPre], esc[kPre];
#pragma unroll
  for (int s = 0; s < kPre; ++s) {
    const bool here = valid && s < k;
    hit[s] = here ? src.row(s, 14) : 0.f;
    esc[s] = here ? src.row(s, 15) : 0.f;
  }
  int n_reached = 0;
  bool escaped = false;
#pragma unroll
  for (int s = 0; s < kPre; ++s) {
    if (n_reached == s && (hit[s] != 0.f || esc[s] != 0.f)) {
      n_reached = s + 1;
      escaped = esc[s] != 0.f;
    }
  }
  Rec x[kPre];
#pragma unroll
  for (int s = 0; s < kPre; ++s) {
    if (s < n_reached) x[s] = src.load(s);
  }
  const int k_top = __reduce_max_sync(kAllLanes, n_reached);
  if (n_reached < k) {
    suf = g * 0.f + suf * 0.f;
    esc_next = false;
  }
#pragma unroll
  for (int s = kPre - 1; s >= 0; --s) {
    if (s >= k_top) continue;  // warp-uniform
    int key = -1;
    V3 ct = zero3();
    if (s < n_reached)
      key = recurse_step(x[s], escaped && s == n_reached - 1, g, quirks, inv_pi, suf, esc_next,
                         ct);
    else
      esc_next = false;
    warp_add(key, ct, acc);
  }
}

// B9's blocks of kB9Warps warps: half of kWarps' rows of accumulators, so
// that on the large scene (nT = 1298, 62 KB a block) three blocks share an
// SM where one of kWarps fit.  A stage of at most kB9Preload slots (every
// stage of the staged paths) loads a lane's slots before the recursion
// (reverse_preloaded); more take reverse_path's loop, with the same bits.
constexpr int kB9Warps = 4;
constexpr int kB9Threads = kB9Warps * 32;
constexpr int kB9Preload = 4;

// B9, persistent: the recursion over one stage's records (k slots) from
// the carry suf_in (4, n) = (suf xyz, esc) of the later stages; writes the
// carry toward the earlier stages to suf_out.  As many blocks as fit on the
// card at once (stage_reverse_capacity): each warp walks its fixed range
// of 32-lane chunks in order (render_common.cuh warp_chunks), so its loads
// coalesce.  Each block clears its rows once and writes one (nT, 3)
// partial; no counter is shared between warps, so the sums depend only on
// (n, the grid) and two calls are bit-equal.
template <int kPre, bool kGlobalAcc>
__global__ void __launch_bounds__(kB9Threads)
    stage_reverse_kernel(const float* rec, const float* g, const float* suf_in, int n, int n_tri,
                         int k, int quirks, float inv_pi, float* partials, float* suf_out,
                         float* scratch) {
  extern __shared__ float4 smem4[];
  float* acc = block_acc<kGlobalAcc>(reinterpret_cast<float*>(smem4), scratch, n_tri, kB9Warps);
  zero_acc(acc, n_tri, kB9Warps);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* warp_acc = acc + static_cast<size_t>(warp) * n_tri * 3;
  const LaneRange r = warp_chunks(n, kB9Warps);
  const long long hi = r.hi;
  for (long long base = r.lo; base < hi; base += 32) {  // warp-uniform
    const int i = static_cast<int>(base) + lane;
    const bool valid = i < hi;
    const GlobalSource src{rec, n, i};
    V3 gi = zero3(), suf = zero3();
    bool esc_next = false;
    if (valid) {
      gi = load_g(g, n, i);
      suf = v3(suf_in[i], suf_in[n + i], suf_in[2 * n + i]);
      esc_next = suf_in[3 * n + i] > 0.f;
    }
    if constexpr (kPre > 0) {
      reverse_preloaded<kPre>(src, valid, k, gi, quirks, inv_pi, warp_acc, suf, esc_next);
    } else {
      int n_reached = 0;
      bool escaped = false;
      if (valid) n_reached = reached_slots(src, k, &escaped);
      reverse_path(src, k, n_reached, escaped, gi, quirks, inv_pi, warp_acc, suf, esc_next);
    }
    if (valid) {
      suf_out[i] = suf.x;
      suf_out[n + i] = suf.y;
      suf_out[2 * n + i] = suf.z;
      suf_out[3 * n + i] = esc_next ? 1.f : 0.f;
    }
  }
  __syncthreads();
  write_partial(acc, n_tri, partials, kB9Warps);
}

// The blocks of a kGlobalAcc grid: at most kGlobalAccBlocksPerSm per SM.
cudaError_t global_acc_blocks(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = kGlobalAccBlocksPerSm * sms;
  return err;
}

// The grid of a kernel of `cap` blocks (kGlobalAcc: cut to
// global_acc_blocks) and the scratch floats per block (0: the
// accumulators are in shared memory).
cudaError_t acc_grid(bool global, int cap, int n_tri, int warps, int* blocks,
                     long long* scratch) {
  *blocks = cap;
  *scratch = 0;
  if (!global) return cudaSuccess;
  int most = 0;
  const cudaError_t err = global_acc_blocks(&most);
  *blocks = min(cap, most);
  *scratch = static_cast<long long>(warps) * n_tri * 3;
  return err;
}

// B9's instance for a stage of k slots (preloaded slots or the loop) over
// nT triangles (accumulators in shared or global memory), its dynamic
// shared memory, the blocks that fit on the card at once (cut as acc_grid
// does) and the scratch floats per block.
using StageReverseKernel = void (*)(const float*, const float*, const float*, int, int, int, int,
                                    float, float*, float*, float*);
Capacity g_stage_reverse_capacity[2][2][kMaxDevices] = {};

cudaError_t stage_reverse_capacity(int n_tri, int k, StageReverseKernel* kernel, size_t* dyn,
                                   int* blocks, long long* scratch) {
  const bool preload = k <= kB9Preload;
  const bool global = !acc_in_smem(n_tri, kB9Warps);
  const StageReverseKernel kernels[2][2] = {
      {stage_reverse_kernel<0, false>, stage_reverse_kernel<0, true>},
      {stage_reverse_kernel<kB9Preload, false>, stage_reverse_kernel<kB9Preload, true>}};
  *kernel = kernels[preload][global];
  *dyn = global ? 0
                : ((static_cast<size_t>(kB9Warps) * n_tri * 3 + 3) & ~size_t(3)) * sizeof(float);
  int cap = 0;
  const cudaError_t err = capacity(*kernel, g_stage_reverse_capacity[preload][global], *dyn, &cap,
                                   kB9Threads);
  if (err != cudaSuccess) return err;
  return acc_grid(global, cap, n_tri, kB9Warps, blocks, scratch);
}

// B2's instance for *P (ring of 16 or 64 slots, accumulators in shared or
// global memory, dense, clustered or BVH search), its capacity cache and
// its dynamic shared memory (sets P.use_smem).
using GradKernel = void (*)(const TraceParams, const float*, float*, float*);
Capacity g_grad_capacity[2][2][3][kMaxDevices] = {};

cudaError_t grad_kernel(TraceParams& P, GradKernel* kernel, Capacity** cache, size_t* dyn,
                        bool* global) {
  if (P.max_bounces > 64) return cudaErrorInvalidValue;
  *global = !acc_in_smem(P.n_tri, kWarps);
  const size_t acc = *global ? 0 : acc_floats(P.n_tri) * sizeof(float);
  *dyn = acc + smem_tables(P, acc);
  const int ring = P.max_bounces <= 16 ? 0 : 1, sweep = sweep_of(P);
  const GradKernel kernels[2][2][3] = {
      {{grad_tile_kernel<16, false, kSweepDense>, grad_tile_kernel<16, false, kSweepClustered>,
        grad_tile_kernel<16, false, kSweepBvh>},
       {grad_tile_kernel<16, true, kSweepDense>, grad_tile_kernel<16, true, kSweepClustered>,
        grad_tile_kernel<16, true, kSweepBvh>}},
      {{grad_tile_kernel<64, false, kSweepDense>, grad_tile_kernel<64, false, kSweepClustered>,
        grad_tile_kernel<64, false, kSweepBvh>},
       {grad_tile_kernel<64, true, kSweepDense>, grad_tile_kernel<64, true, kSweepClustered>,
        grad_tile_kernel<64, true, kSweepBvh>}}};
  *kernel = kernels[ring][*global][sweep];
  *cache = g_grad_capacity[ring][*global][sweep];
  return cudaSuccess;
}

// B2's instance and dynamic shared memory for *P, its grid (at most the
// blocks that fit on the card at once, cut as acc_grid does) and its
// scratch floats per block.
cudaError_t grad_grid(TraceParams& P, GradKernel* kernel, size_t* dyn, int* blocks,
                      long long* scratch) {
  Capacity* cache = nullptr;
  bool global = false;
  cudaError_t err = grad_kernel(P, kernel, &cache, dyn, &global);
  int cap = 0;
  if (err == cudaSuccess) err = capacity(*kernel, cache, *dyn, &cap);
  if (err != cudaSuccess) return err;
  return acc_grid(global, cap, P.n_tri, kWarps, blocks, scratch);
}

}  // namespace

extern "C" {

// B2's blocks that fit on the card at once for the scene of *Pin (the
// wrapper launches at most that many: render_kernel.py
// persistent_blocks) and the scratch floats a block needs (0: none).
// Returns the cudaError_t.
int ipt_grad_tile_capacity(const TraceParams* Pin, int* blocks, long long* scratch) {
  TraceParams P = *Pin;
  size_t dyn = 0;
  GradKernel kernel = nullptr;
  return static_cast<int>(grad_grid(P, &kernel, &dyn, blocks, scratch));
}

// B2 on `blocks` persistent blocks: partials (blocks, nT, 3) of d loss / d
// materials for the rays of *Pin and the radiance cotangent g (3, n);
// `scratch` holds blocks times the floats ipt_grad_tile_capacity gives
// (null where that is 0).  Returns the cudaError_t.
int ipt_grad_tile(const TraceParams* Pin, const float* g, float* partials, float* scratch,
                  int blocks, void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  size_t dyn = 0;
  GradKernel kernel = nullptr;
  int cap = 0;
  long long per_block = 0;
  const cudaError_t err = grad_grid(P, &kernel, &dyn, &cap, &per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || blocks > cap || (per_block && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(P, g, partials, scratch);
  return static_cast<int>(cudaGetLastError());
}

// B4's grid for n rays over nT triangles: one block per kThreads rays, cut
// as acc_grid does where the accumulators are in global memory, and the
// scratch floats a block needs (0: none).  Returns the cudaError_t.
int ipt_reverse_tile_blocks(int n, int n_tri, int* blocks, long long* scratch) {
  return static_cast<int>(acc_grid(!acc_in_smem(n_tri, kWarps), (n + kThreads - 1) / kThreads,
                                   n_tri, kWarps, blocks, scratch));
}

// B4 on the grid of ipt_reverse_tile_blocks: partials (blocks, nT, 3) from
// records (max_bounces * 16, n) and g (3, n), with the scratch buffer of
// the global accumulators (null where none).  Returns the cudaError_t.
int ipt_reverse_tile(const float* rec, const float* g, int n, int n_tri, int max_bounces,
                     int quirks, float inv_pi, float* partials, float* scratch, int blocks,
                     void* stream) {
  if (n <= 0) return 0;
  int want = 0;
  long long per_block = 0;
  cudaError_t err = acc_grid(!acc_in_smem(n_tri, kWarps), (n + kThreads - 1) / kThreads, n_tri,
                             kWarps, &want, &per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks != want || (per_block && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per_block) {
    reverse_tile_kernel<true><<<blocks, kThreads, 0, s>>>(rec, g, n, n_tri, max_bounces, quirks,
                                                          inv_pi, partials, scratch);
  } else {
    const size_t dyn = acc_floats(n_tri) * sizeof(float);
    err = allow_smem(reverse_tile_kernel<false>, dyn);
    if (err != cudaSuccess) return static_cast<int>(err);
    reverse_tile_kernel<false><<<blocks, kThreads, dyn, s>>>(rec, g, n, n_tri, max_bounces,
                                                             quirks, inv_pi, partials, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

// B9's grid for n lanes of a stage of k slots over nT triangles: the
// blocks that fit on the card at once (cut as acc_grid does with global
// accumulators), at most one per kB9Threads lanes (render_kernel.py
// persistent_blocks), and the scratch floats a block needs (0: none).
// Returns the cudaError_t.
int ipt_stage_reverse_blocks(int n, int n_tri, int k, int* blocks, long long* scratch) {
  StageReverseKernel kernel = nullptr;
  size_t dyn = 0;
  int cap = 0;
  const cudaError_t err = stage_reverse_capacity(n_tri, k, &kernel, &dyn, &cap, scratch);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = min(cap, (n + kB9Threads - 1) / kB9Threads);
  return 0;
}

// B9 on `blocks` persistent blocks (ipt_stage_reverse_blocks): partials
// (blocks, nT, 3) and the carry suf_out (4, n) from one stage's records
// (k * 16, n), g (3, n) and the carry suf_in (4, n), with the scratch
// buffer of the global accumulators (null where none).  Returns the
// cudaError_t.
int ipt_stage_reverse_tile(const float* rec, const float* g, const float* suf_in, int n,
                           int n_tri, int k, int quirks, float inv_pi, float* partials,
                           float* suf_out, float* scratch, int blocks, void* stream) {
  if (n <= 0) return 0;
  StageReverseKernel kernel = nullptr;
  size_t dyn = 0;
  int cap = 0;
  long long per_block = 0;
  const cudaError_t err = stage_reverse_capacity(n_tri, k, &kernel, &dyn, &cap, &per_block);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || blocks > cap || (per_block && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kB9Threads, dyn, static_cast<cudaStream_t>(stream)>>>(
      rec, g, suf_in, n, n_tri, k, quirks, inv_pi, partials, suf_out, scratch);
  return static_cast<int>(cudaGetLastError());
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
