// Forward path-tracing kernels for Hopper (sm_90a): the megakernel with and
// without records (B1, B3), the staged wavefront's init and stage kernels
// (B7, B8) and the clustered sweep launched on its own (B10).
//
// B1 replaces the JAX package's Pallas TPU kernel render_tile_pallas /
// _kernel_fwd (inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1440,
// :883; bounce body _make_bounce :602).  It computes the same function:
// for each ray, up to max_bounces bounces of closest-hit intersection,
// first-hit emission, next-event estimation with an area-CDF light pick,
// sqrt-barycentric point sample and shadow ray, Russian roulette, cosine or
// Phong direction sampling, the reference quirks Q1/Q2 (or the quirk-free
// estimator), and barycentric smooth shading on vertex-normal scenes.
//
// B3 (kRecords = true) replaces render_tile_pallas_rec (render_kernel.py
// :1571): the same loop, which also writes every bounce's record to a
// (max_bounces * 16, n) array in global memory (layout in
// render_common.cuh) and zeroes the slots past the ray's last bounce, so
// that reverse_tile (render_bwd.cu) needs no replay.  Its radiance and
// counts are B1's, bit for bit: the record stores touch no arithmetic.
//
// Design.  One thread per ray, the bounce loop in registers (trace_path in
// render_common.cuh), exit as soon as the ray dies (the TPU kernel pays
// every bounce slot of a masked block).  The closest hit is a brute-force
// sweep over all triangles with a strict `<`, so ties keep the lowest
// triangle index; the per-triangle plane rows (16 floats: face plane, 3
// edge planes), the per-triangle material table and the emitter table are
// staged in shared memory when they fit in 48 KB and otherwise read
// through the L1 cache from global memory, so any triangle count is
// correct.  Every thread of a warp reads the same plane row at the same
// time, which is a shared-memory broadcast.  t is an exact IEEE divide.
// The file is compiled with -fmad=false so that every sum rounds exactly
// as in the plain PyTorch version (render_kernel.py render_tile_plain),
// which lets the two agree bit for bit on geometry.
//
// B7, init_kernel, replaces init_tile_pallas / _kernel_init
// (render_kernel.py:1677, :1098): the bounce-0 intersection of each live
// ray written into the lane carry (render_common.cuh, kCarryRows rows).
// B8, stage_kernel, replaces stage_tile_pallas / _kernel_stage (:1711,
// :1141): from a carry, at most k bounces of each live lane starting at a
// runtime global bounce `start`, with B1's bounce step (bounce_step); the
// fused hash takes the global bounce, the external uniforms and the records
// the local one.  A thread stops where its lane dies or its global bounce
// reaches max_bounces, and zeroes the record slots it did not reach (the
// partial last stage).  The host sorts the lanes between stages, live ones
// first (render/forward.py), so trailing blocks hold dead lanes only: each
// of their threads copies its carry, zeroes its records and exits.  B10's
// standalone kernel, intersect_kernel, runs intersect() for one ray per
// thread, so that the clustered sweep can be checked and timed alone.
//
// Bound.  Per live (ray, bounce) the kernel sweeps nT triangles twice (the
// shadow ray and the next ray share the hit point as origin) at ~30 f32
// operations each plus a divide: B1's work is f32 ALU, far above the 52
// bytes per ray that it reads and writes.  B3 adds max_bounces * 64 bytes
// of record stores per ray (1 GiB per 2^20-ray launch at 16 bounces),
// which at 3.35 TB/s is about a tenth of B1's time.  Warp divergence from
// rays dying at different bounces is the main loss; B7 and B8 are the ray
// compaction the JAX package uses on large scenes.  B8 moves its carry (96
// bytes in and 96 out per lane) and k * 64 bytes of records per lane; its
// sweeps dominate as B1's do.

#include "render_common.cuh"

namespace {

using namespace ipt;

template <bool kRecords, bool kClustered>
__global__ void __launch_bounds__(kThreads)
    render_fwd_kernel(const TraceParams P, float* rad, float* stats, float* rec) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables(P, reinterpret_cast<float*>(smem4));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const int n = P.n;

  PathOut o;
  if constexpr (kRecords) {
    GlobalRecords sink{rec, n, i};
    o = trace_path<kClustered>(P, T, i, sink);
    sink.zero_from(o.n_reached, P.max_bounces);
  } else {
    NoRecords sink;
    o = trace_path<kClustered>(P, T, i, sink);
  }
  rad[i] = o.rad.x;
  rad[n + i] = o.rad.y;
  rad[2 * n + i] = o.rad.z;
  stats[i] = o.segs;
  stats[n + i] = o.shadows;
}

template <bool kClustered>
__global__ void __launch_bounds__(kThreads) init_kernel(const TraceParams P, float* carry) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables(P, reinterpret_cast<float*>(smem4));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  store_lane(carry, P.n, i, init_lane<kClustered>(P, T, i));
}

template <bool kRecords, bool kClustered>
__global__ void __launch_bounds__(kThreads)
    stage_kernel(const TraceParams P, const float* carry_in, float* carry_out, float* rec,
                 int start, int k) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables(P, reinterpret_cast<float*>(smem4));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  Lane L = load_lane(carry_in, P.n, i);
  const uint32_t h_orig = hash_orig(P, i);
  int reached = 0;
  if constexpr (kRecords) {
    GlobalRecords sink{rec, P.n, i};
    for (int b = 0; L.alive && b < k && start + b < P.max_bounces; ++b) {
      float u[6];
      draw6(P, i, h_orig, start + b, b, u);
      bounce_step<kClustered>(P, T, L, start + b, u, sink, b);
      reached = b + 1;
    }
    sink.zero_from(reached, k);
  } else {
    NoRecords sink;
    for (int b = 0; L.alive && b < k && start + b < P.max_bounces; ++b) {
      float u[6];
      draw6(P, i, h_orig, start + b, b, u);
      bounce_step<kClustered>(P, T, L, start + b, u, sink, b);
    }
  }
  store_lane(carry_out, P.n, i, L);
}

template <bool kClustered>
__global__ void __launch_bounds__(kThreads)
    intersect_kernel(const TraceParams P, float* t_out, int* idx_out) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables(P, reinterpret_cast<float*>(smem4));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const int n = P.n;
  const Hit h = intersect<kClustered>(P, T, v3(P.p[i], P.p[n + i], P.p[2 * n + i]),
                                      v3(P.d[i], P.d[n + i], P.d[2 * n + i]));
  t_out[i] = h.t;
  idx_out[i] = h.idx;
}

// The tables go to shared memory when they fit in 48 KB (as B1's).
size_t prepare(TraceParams& P) {
  const size_t smem =
      static_cast<size_t>(table_floats(P.n_tri, P.has_vn, P.n_emissive, P.etab_stride)) *
      sizeof(float);
  P.use_smem = smem <= static_cast<size_t>(kSmemLimit);
  return P.use_smem ? smem : 0;
}

}  // namespace

extern "C" {

// Launches B1 (rec == null) or B3 (records into rec) on `stream` for the
// rays and scene of *Pin; returns the cudaError_t of the launch.
int ipt_render_fwd(const TraceParams* Pin, float* rad, float* stats, float* rec, void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  const size_t dyn = prepare(P);
  const int blocks = (P.n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    if (rec == nullptr) {
      render_fwd_kernel<false, true><<<blocks, kThreads, dyn, s>>>(P, rad, stats, nullptr);
    } else {
      render_fwd_kernel<true, true><<<blocks, kThreads, dyn, s>>>(P, rad, stats, rec);
    }
  } else if (rec == nullptr) {
    render_fwd_kernel<false, false><<<blocks, kThreads, dyn, s>>>(P, rad, stats, nullptr);
  } else {
    render_fwd_kernel<true, false><<<blocks, kThreads, dyn, s>>>(P, rad, stats, rec);
  }
  return static_cast<int>(cudaGetLastError());
}

// B7: the initial carry (kCarryRows, n) of the rays of *Pin.
int ipt_init_tile(const TraceParams* Pin, float* carry, void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  const size_t dyn = prepare(P);
  const int blocks = (P.n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    init_kernel<true><<<blocks, kThreads, dyn, s>>>(P, carry);
  } else {
    init_kernel<false><<<blocks, kThreads, dyn, s>>>(P, carry);
  }
  return static_cast<int>(cudaGetLastError());
}

// B8: at most k bounces from global bounce `start` of the lanes of
// carry_in (kCarryRows, n) into carry_out, and records (k * 16, n) unless
// rec is null.  P.uniforms, when not null, holds the stage's k * 8 rows.
int ipt_stage_tile(const TraceParams* Pin, const float* carry_in, float* carry_out, float* rec,
                   int start, int k, void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  const size_t dyn = prepare(P);
  const int blocks = (P.n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    if (rec == nullptr) {
      stage_kernel<false, true><<<blocks, kThreads, dyn, s>>>(P, carry_in, carry_out, nullptr,
                                                             start, k);
    } else {
      stage_kernel<true, true><<<blocks, kThreads, dyn, s>>>(P, carry_in, carry_out, rec, start,
                                                            k);
    }
  } else if (rec == nullptr) {
    stage_kernel<false, false><<<blocks, kThreads, dyn, s>>>(P, carry_in, carry_out, nullptr,
                                                            start, k);
  } else {
    stage_kernel<true, false><<<blocks, kThreads, dyn, s>>>(P, carry_in, carry_out, rec, start, k);
  }
  return static_cast<int>(cudaGetLastError());
}

// B10: t (n,) and the internal triangle index (n,) of the closest hit of
// each ray of *Pin.
int ipt_intersect_tile(const TraceParams* Pin, float* t, int* idx, void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  const size_t dyn = prepare(P);
  const int blocks = (P.n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    intersect_kernel<true><<<blocks, kThreads, dyn, s>>>(P, t, idx);
  } else {
    intersect_kernel<false><<<blocks, kThreads, dyn, s>>>(P, t, idx);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
