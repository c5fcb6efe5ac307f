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
// B3 (render_fwd.cu render_rec_kernel) wrote to global memory.
//
// B9, stage_reverse_kernel, replaces stage_reverse_tile_pallas /
// _kernel_stage_reverse (render_kernel.py:1780, :1263): the recursion over
// the k slots of one stage's records (B8's), started from the (suf, esc)
// carry of the later stages and returning the carry toward the earlier
// ones; the host re-orders the carry to the previous stage's lanes between
// launches.  Like B4 it is bound by the bytes of the reached records.
//
// Schedules.  B4 and B9 run one thread per ray, the recursion warp by warp
// to the warp's longest path (reverse_path).  B2 runs persistent blocks
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
// depends on its order).  Shared memory holds kWarps * nT * 3 floats of
// accumulators (up to the wrapper's limit) and, when they fit beside them
// in 48 KB, the scene tables.
//
// Bound.  B2 does B1's work again (the closest-hit sweeps, f32 ALU) plus
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

__device__ __forceinline__ void zero_acc(float* acc, int n_tri) {
  for (int e = threadIdx.x; e < kWarps * n_tri * 3; e += blockDim.x) acc[e] = 0.f;
}

// The block's (nT, 3) partial: its warps' rows summed in warp order.
__device__ __forceinline__ void write_partial(const float* acc, int n_tri, float* partials) {
  const int m = n_tri * 3;
  for (int e = threadIdx.x; e < m; e += blockDim.x) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += acc[w * m + e];
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
// gradient is the same in every run on one card.
template <int kCap, bool kClustered>
__global__ void __launch_bounds__(kThreads, min_blocks(kClustered))
    grad_tile_kernel(const TraceParams P, const float* g, float* partials) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  zero_acc(acc, P.n_tri);
  const Tables T = stage_tables<kClustered>(P, acc + acc_floats(P.n_tri));
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
      const bool cont = bounce_step<kClustered, true>(P, T, L, b, u, recs, round & (kCap - 1));
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
    if (sweep) sweep_from<kClustered>(P, T, L, L.point);
  }
  __syncthreads();
  write_partial(acc, P.n_tri, partials);
}

__global__ void __launch_bounds__(kThreads)
    reverse_tile_kernel(const float* rec, const float* g, int n, int n_tri, int max_bounces,
                        int quirks, float inv_pi, float* partials) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  zero_acc(acc, n_tri);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const GlobalSource src{rec, n, i};
  int n_reached = 0;
  bool escaped = false;
  V3 gi = zero3();
  if (i < n) {
    n_reached = reached_slots(src, max_bounces, &escaped);
    gi = load_g(g, n, i);
  }
  const int warp = threadIdx.x >> 5;
  V3 suf = zero3();
  bool esc_next = false;
  reverse_path(src, max_bounces, n_reached, escaped, gi, quirks, inv_pi,
               acc + static_cast<size_t>(warp) * n_tri * 3, suf, esc_next);
  __syncthreads();
  write_partial(acc, n_tri, partials);
}

// B9: the recursion over one stage's records (k slots) from the carry
// suf_in (4, n) = (suf xyz, esc) of the later stages; writes the carry
// toward the earlier stages to suf_out.
__global__ void __launch_bounds__(kThreads)
    stage_reverse_kernel(const float* rec, const float* g, const float* suf_in, int n, int n_tri,
                         int k, int quirks, float inv_pi, float* partials, float* suf_out) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  zero_acc(acc, n_tri);
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const GlobalSource src{rec, n, i};
  int n_reached = 0;
  bool escaped = false;
  V3 gi = zero3(), suf = zero3();
  bool esc_next = false;
  if (i < n) {
    n_reached = reached_slots(src, k, &escaped);
    gi = load_g(g, n, i);
    suf = v3(suf_in[i], suf_in[n + i], suf_in[2 * n + i]);
    esc_next = suf_in[3 * n + i] > 0.f;
  }
  const int warp = threadIdx.x >> 5;
  reverse_path(src, k, n_reached, escaped, gi, quirks, inv_pi,
               acc + static_cast<size_t>(warp) * n_tri * 3, suf, esc_next);
  if (i < n) {
    suf_out[i] = suf.x;
    suf_out[n + i] = suf.y;
    suf_out[2 * n + i] = suf.z;
    suf_out[3 * n + i] = esc_next ? 1.f : 0.f;
  }
  __syncthreads();
  write_partial(acc, n_tri, partials);
}

// B2's instance for *P (ring of 16 or 64 slots, dense or clustered), its
// capacity cache and its dynamic shared memory (sets P.use_smem).
using GradKernel = void (*)(const TraceParams, const float*, float*);
Capacity g_grad_capacity[4][kMaxDevices] = {};

cudaError_t grad_kernel(TraceParams& P, GradKernel* kernel, Capacity** cache, size_t* dyn) {
  if (P.max_bounces > 64) return cudaErrorInvalidValue;
  const size_t acc = acc_floats(P.n_tri) * sizeof(float);
  *dyn = acc + smem_tables(P, acc);
  const int k = (P.cluster_k ? 2 : 0) + (P.max_bounces <= 16 ? 0 : 1);
  const GradKernel kernels[4] = {grad_tile_kernel<16, false>, grad_tile_kernel<64, false>,
                                 grad_tile_kernel<16, true>, grad_tile_kernel<64, true>};
  *kernel = kernels[k];
  *cache = g_grad_capacity[k];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// B2's blocks that fit on the card at once for the scene of *Pin (the
// wrapper launches at most that many: render_kernel.py
// persistent_blocks).  Returns the cudaError_t.
int ipt_grad_tile_capacity(const TraceParams* Pin, int* blocks) {
  TraceParams P = *Pin;
  size_t dyn = 0;
  GradKernel kernel = nullptr;
  Capacity* cache = nullptr;
  const cudaError_t err = grad_kernel(P, &kernel, &cache, &dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(capacity(kernel, cache, dyn, blocks));
}

// B2 on `blocks` persistent blocks: partials (blocks, nT, 3) of d loss / d
// materials for the rays of *Pin and the radiance cotangent g (3, n).
// Returns the cudaError_t.
int ipt_grad_tile(const TraceParams* Pin, const float* g, float* partials, int blocks,
                  void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  size_t dyn = 0;
  GradKernel kernel = nullptr;
  Capacity* cache = nullptr;
  cudaError_t err = grad_kernel(P, &kernel, &cache, &dyn);
  int cap = 0;
  if (err == cudaSuccess) err = capacity(kernel, cache, dyn, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || blocks > cap) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(P, g, partials);
  return static_cast<int>(cudaGetLastError());
}

// B4: partials (ceil(n / 256), nT, 3) from records (max_bounces * 16, n)
// and g (3, n).  Returns the cudaError_t.
int ipt_reverse_tile(const float* rec, const float* g, int n, int n_tri, int max_bounces,
                     int quirks, float inv_pi, float* partials, void* stream) {
  if (n <= 0) return 0;
  const size_t dyn = acc_floats(n_tri) * sizeof(float);
  cudaError_t err = allow_smem(reverse_tile_kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  reverse_tile_kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      rec, g, n, n_tri, max_bounces, quirks, inv_pi, partials);
  return static_cast<int>(cudaGetLastError());
}

// B9: partials (ceil(n / 256), nT, 3) and the carry suf_out (4, n) from
// one stage's records (k * 16, n), g (3, n) and the carry suf_in (4, n).
int ipt_stage_reverse_tile(const float* rec, const float* g, const float* suf_in, int n,
                           int n_tri, int k, int quirks, float inv_pi, float* partials,
                           float* suf_out, void* stream) {
  if (n <= 0) return 0;
  const size_t dyn = acc_floats(n_tri) * sizeof(float);
  cudaError_t err = allow_smem(stage_reverse_kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (n + kThreads - 1) / kThreads;
  stage_reverse_kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(
      rec, g, suf_in, n, n_tri, k, quirks, inv_pi, partials, suf_out);
  return static_cast<int>(cudaGetLastError());
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
