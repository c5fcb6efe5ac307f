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
// warp: every lane runs the warp's longest path length, lanes past their
// own last bounce contribute nothing.  acc is this warp's (nT, 3) row.
template <class Records>
__device__ __forceinline__ void reverse_path(const Records& r, int n_reached, bool escaped, V3 g,
                                             int quirks, float inv_pi, float* acc) {
  const int k_top = __reduce_max_sync(0xffffffffu, n_reached);
  V3 suf = zero3();
  bool esc_next = false;
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

template <int kCap>
__global__ void __launch_bounds__(kThreads)
    grad_tile_kernel(const TraceParams P, const float* g, float* partials) {
  extern __shared__ float4 smem4[];
  float* acc = reinterpret_cast<float*>(smem4);
  zero_acc(acc, P.n_tri);
  const Tables T = stage_tables(P, acc + acc_floats(P.n_tri));
  __syncthreads();

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  LocalRecords<kCap> recs;
  PathOut o{};
  V3 gi = zero3();
  if (i < P.n) {
    o = trace_path(P, T, i, recs);
    gi = load_g(g, P.n, i);
  }
  const int warp = threadIdx.x >> 5;
  reverse_path(recs, o.n_reached, o.escaped, gi, P.quirks, P.inv_pi,
               acc + static_cast<size_t>(warp) * P.n_tri * 3);
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
    // A ray's reached bounces are the leading slots with hit or esc set.
    for (int k = 0; k < max_bounces; ++k) {
      const float hit = src.row(k, 14), esc = src.row(k, 15);
      if (hit == 0.f && esc == 0.f) break;
      n_reached = k + 1;
      escaped = esc != 0.f;
    }
    gi = load_g(g, n, i);
  }
  const int warp = threadIdx.x >> 5;
  reverse_path(src, n_reached, escaped, gi, quirks, inv_pi,
               acc + static_cast<size_t>(warp) * n_tri * 3);
  __syncthreads();
  write_partial(acc, n_tri, partials);
}

// Opts a kernel into more than 48 KB of dynamic shared memory when needed.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmemLimit)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
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
  const size_t tabs =
      static_cast<size_t>(table_floats(P.n_tri, P.has_vn, P.n_emissive, P.etab_stride)) *
      sizeof(float);
  P.use_smem = acc + tabs <= static_cast<size_t>(kSmemLimit);
  const size_t dyn = acc + (P.use_smem ? tabs : 0);
  auto kernel = P.max_bounces <= 16 ? grad_tile_kernel<16> : grad_tile_kernel<64>;
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

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
