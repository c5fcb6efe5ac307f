// Backward kernels of the material gradient for Hopper (sm_90a).
//
// B2, grad_tile_kernel, replaces the JAX package's fused backward
// grad_tile_pallas / _kernel_bwd + _suffix_recursion
// (inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1505, :946, :1007).
// Pass 1 replays B1's bounce loop (trace_path in render_common.cuh, the
// same code under the same -fmad=false, so the replay takes the forward's
// branches) and keeps each reached bounce's record in a per-thread array.
// Pass 2 runs the suffix recursion backwards from the last reached bounce
// (render/diff.py in the JAX package, :94-110):
//     ct  = pm * suf * coeff/pi + [hit] g * pm * nee
//           + [quirks and escape at k+1] g * (pm * f) * nee
//     suf = g * c + f * suf
// and adds ct into d materials[tri] for every bounce that hit.
//
// B4, reverse_tile_kernel, replaces reverse_tile_pallas / _kernel_reverse
// (render_kernel.py:1640, :1065): pass 2 alone, on the records that B3
// (render_fwd.cu, kRecords = true) wrote to global memory.
//
// B9, stage_reverse_kernel, replaces stage_reverse_tile_pallas /
// _kernel_stage_reverse (render_kernel.py:1780, :1263): pass 2 over the k
// slots of one stage's records (B8's), started from the (suf, esc) carry of
// the later stages and returning the carry toward the earlier ones; the
// host re-orders the carry to the previous stage's lanes between launches.
// Like B4 it is bound by the bytes of the reached records.
//
// Reduction.  Within a warp, lanes that hit the same triangle are grouped
// with __match_any_sync and summed in lane order through shuffles; the
// group's lowest lane adds the sum to the warp's own (nT, 3) row of shared
// memory.  At the end the block sums its warps' rows in warp order and
// writes one (nT, 3) partial; the wrapper sums the partials over blocks in
// a fixed order.  No atomics are used, so the result is bit-reproducible
// from run to run for the same launch shape (it does depend on how rays
// fall into warps and blocks, as any float sum depends on its order).
// Shared memory holds kWarps * nT * 3 floats of accumulators (up to the
// wrapper's limit) and, when they fit beside them in 48 KB, the scene
// tables.
//
// Bound.  B2 does B1's work again (the closest-hit sweeps, f32 ALU) plus
// the recursion, ~40 f32 operations and a 96-shuffle warp sum per reached
// bounce, and moves ~1 KB per ray through local memory (L2-resident in
// part).  B4 reads the records of the reached bounces (64 bytes each) and
// a flag pair where a ray stopped early: it is bound by those bytes.

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
// (local memory), kCap bounces at most.
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

// Adds each lane's ct to acc[key] (key >= 0), summing the lanes that share
// a key in lane order.  All 32 lanes of the warp must call it together.
__device__ __forceinline__ void warp_scatter(int key, V3 ct, float* acc) {
  const unsigned full = 0xffffffffu;
  const unsigned peers = __match_any_sync(full, key);
  V3 sum = zero3();
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    const V3 x = v3(__shfl_sync(full, ct.x, j), __shfl_sync(full, ct.y, j),
                    __shfl_sync(full, ct.z, j));
    if (peers & (1u << j)) sum = sum + x;
  }
  if (key >= 0 && __ffs(peers) - 1 == static_cast<int>(threadIdx.x & 31)) {
    float* a = acc + 3 * key;
    a[0] += sum.x;
    a[1] += sum.y;
    a[2] += sum.z;
  }
  __syncwarp();
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
  const int k_top = __reduce_max_sync(0xffffffffu, n_reached);
  if (n_reached < n_slots) {
    suf = g * 0.f + suf * 0.f;
    esc_next = false;
  }
  for (int k = k_top - 1; k >= 0; --k) {
    int key = -1;
    V3 ct = zero3();
    bool esc = false;
    if (k < n_reached) {
      const Rec x = r.load(k);
      esc = escaped && k == n_reached - 1;
      if (!esc) {
        // d f / d kd = coeff / pi; d l_d / d kd = nee.
        ct = x.pm * suf * (x.coeff * inv_pi) + g * x.pm * x.nee;
        // Q2: the stale l_d re-added on escape at k+1 is bounce k's.
        if (quirks && esc_next) ct = ct + g * (x.pm * x.f) * x.nee;
        key = x.tri;
      }
      suf = g * x.c + x.f * suf;
    }
    esc_next = esc;
    if (__any_sync(0xffffffffu, key >= 0)) warp_scatter(key, ct, acc);
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

template <int kCap, bool kClustered>
__global__ void __launch_bounds__(kThreads, min_blocks(kClustered))
    grad_tile_kernel(const TraceParams P, const float* g, float* partials) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  zero_acc(acc, P.n_tri);
  const Tables T = stage_tables<kClustered>(P, acc + acc_floats(P.n_tri));
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  LocalRecords<kCap> recs;
  PathOut o{};
  V3 gi = zero3();
  if (i < P.n) {
    o = trace_path<kClustered>(P, T, i, recs);
    gi = load_g(g, P.n, i);
  }
  const int warp = threadIdx.x >> 5;
  V3 suf = zero3();
  bool esc_next = false;
  reverse_path(recs, P.max_bounces, o.n_reached, o.escaped, gi, P.quirks, P.inv_pi,
               acc + static_cast<size_t>(warp) * P.n_tri * 3, suf, esc_next);
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

}  // namespace

extern "C" {

// B2: partials (ceil(n / 256), nT, 3) of d loss / d materials for the rays
// of *Pin and the radiance cotangent g (3, n).  Returns the cudaError_t.
int ipt_grad_tile(const TraceParams* Pin, const float* g, float* partials, void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  if (P.max_bounces > 64) return static_cast<int>(cudaErrorInvalidValue);
  const size_t acc = acc_floats(P.n_tri) * sizeof(float);
  const size_t dyn = acc + smem_tables(P, acc);
  auto kernel = P.cluster_k
      ? (P.max_bounces <= 16 ? grad_tile_kernel<16, true> : grad_tile_kernel<64, true>)
      : (P.max_bounces <= 16 ? grad_tile_kernel<16, false> : grad_tile_kernel<64, false>);
  cudaError_t err = allow_smem(kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (P.n + kThreads - 1) / kThreads;
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
