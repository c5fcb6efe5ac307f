// Forward path-tracing megakernel for Hopper (sm_90a), with and without
// records.
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
// Bound.  Per live (ray, bounce) the kernel sweeps nT triangles twice (the
// shadow ray and the next ray share the hit point as origin) at ~30 f32
// operations each plus a divide: B1's work is f32 ALU, far above the 52
// bytes per ray that it reads and writes.  B3 adds max_bounces * 64 bytes
// of record stores per ray (1 GiB per 2^20-ray launch at 16 bounces),
// which at 3.35 TB/s is about a tenth of B1's time.  Warp divergence from
// rays dying at different bounces is the main loss, left to later tuning
// (persistent threads with ray compaction, a BVH for large scenes).

#include "render_common.cuh"

namespace {

using namespace ipt;

template <bool kRecords>
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
    o = trace_path(P, T, i, sink);
    sink.zero_from(o.n_reached, P.max_bounces);
  } else {
    NoRecords sink;
    o = trace_path(P, T, i, sink);
  }
  rad[i] = o.rad.x;
  rad[n + i] = o.rad.y;
  rad[2 * n + i] = o.rad.z;
  stats[i] = o.segs;
  stats[n + i] = o.shadows;
}

}  // namespace

extern "C" {

// Launches B1 (rec == null) or B3 (records into rec) on `stream` for the
// rays and scene of *Pin; returns the cudaError_t of the launch.
int ipt_render_fwd(const TraceParams* Pin, float* rad, float* stats, float* rec, void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  const size_t smem =
      static_cast<size_t>(table_floats(P.n_tri, P.has_vn, P.n_emissive, P.etab_stride)) *
      sizeof(float);
  P.use_smem = smem <= static_cast<size_t>(kSmemLimit);
  const int blocks = (P.n + kThreads - 1) / kThreads;
  const size_t dyn = P.use_smem ? smem : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rec == nullptr) {
    render_fwd_kernel<false><<<blocks, kThreads, dyn, s>>>(P, rad, stats, nullptr);
  } else {
    render_fwd_kernel<true><<<blocks, kThreads, dyn, s>>>(P, rad, stats, rec);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
