// Forward path-tracing kernels for Hopper (sm_90a): the megakernel (B1),
// the megakernel with records on a regenerating schedule (B3), the staged
// wavefront's init and stage kernels (B7, B8) and the clustered sweep
// launched on its own (B10).
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
// B3 replaces render_tile_pallas_rec (render_kernel.py :1571): the same
// bounce steps, which also write every bounce's record to a (max_bounces *
// 16, n) array in global memory (layout in render_common.cuh), zero past
// the ray's last bounce, so that reverse_tile (render_bwd.cu) needs no
// replay.  Its radiance and counts are B1's, bit for bit: the record stores
// touch no arithmetic.  B1 and B3 are one kernel template, render_kernel
// <kRecords, kSweep>.
//
// Design.  B1 and B3: persistent blocks whose lanes take a new ray as soon
// as their path ends (render_common.cuh warp_rays), one round per bounce,
// so a warp's lanes stay busy under roulette (one ray a thread idled the
// finished lanes of a warp until its longest path ended); the rays a warp
// holds come from one contiguous range, in order, so B3's record stores of
// a round fall on neighbouring columns and L2 merges their partial sectors.
// In camera mode (TraceParams.camera, the fused paths) a lane makes its
// primary ray itself (render_common.cuh camera_ray) instead of reading it.
// The closest hit is a brute-force sweep over all
// triangles with a strict `<`, so ties keep the lowest triangle index; the
// per-triangle plane rows (16 floats: face plane, 3 edge planes), the
// per-triangle material table and the emitter table are staged in shared
// memory when they fit in 48 KB and otherwise read
// through the L1 cache from global memory, so any triangle count is
// correct (on clustered tables, the plane rows and boxes go to shared
// memory by TMA up to a block's 227 KB: render_common.cuh stage_tables).
// Every thread of a warp reads the same plane row at the same time, which
// is a shared-memory broadcast.  t is an exact IEEE divide, behind a
// divide-free pre-test that rejects most pairs (render_common.cuh sweep).
// The file is compiled with -fmad=false so that every sum rounds exactly
// as in the plain PyTorch version (render_kernel.py render_tile_plain),
// which lets the two agree bit for bit on geometry.
//
// B7, init_kernel, replaces init_tile_pallas / _kernel_init
// (render_kernel.py:1677, :1098): the bounce-0 intersection of each live
// ray written into the lane carry (render_common.cuh, kCarryRows rows).
// It is bound by the bytes of the carry it writes (96 per lane; the rays
// are made in the kernel in camera mode).  It runs persistent blocks, as
// many as fit with the tables' shared memory, each staging the tables once
// and its warps walking fixed ranges of 32-lane chunks (warp_chunks):
// with one block per 256 rays, every block copied the ~86 KB of the large
// scene's sweep tables from L2 to sweep 256 primary rays.
//
// B8, stage_kernel, replaces stage_tile_pallas / _kernel_stage (:1711,
// :1141): from a carry, at most k bounces of each live lane starting at a
// runtime global bounce `start`, with B1's bounce step (bounce_step); the
// fused hash takes the global bounce, the external uniforms and the records
// the local one.  A thread stops where its lane dies or its global bounce
// reaches max_bounces, and zeroes the record slots it did not reach (the
// partial last stage).  The host sorts the lanes between stages, live ones
// first (render/forward.py), and counts them on the device; B8 is a
// persistent kernel whose warps take 32-lane chunks of that live prefix
// from a global counter and then copy the dead lanes' carry and zero their
// records with 16-byte stores (stage_kernel).  B10's
// standalone kernel, intersect_kernel, runs intersect() for one ray per
// thread, so that the clustered sweep, or the BVH traversal, can be
// checked and timed alone.
//
// The BVH route (render_common.cuh traverse): B1 and B3 are also
// instantiated on it (render_kernel<kRecords, kSweepBvh>), for every
// search of a path: the segment, the shadow ray and the deferred next hit.
// B7 and B8 are not: the route is one unstaged wavefront, as in the JAX
// package, and their launchers refuse BVH tables.
//
// Bound.  Per live (ray, bounce) the kernel sweeps nT triangles twice (the
// shadow ray and the next ray share the hit point as origin) at ~30 f32
// operations each plus a divide: B1's work is f32 ALU, far above the 52
// bytes per ray that it reads and writes.  B3 adds max_bounces * 64 bytes
// of record stores per ray (1 GiB per 2^20-ray launch at 16 bounces),
// which at 3.35 TB/s is about a tenth of B1's time; its memset writes the
// whole array and the kernel the reached slots again (about half of it).
// Warp divergence from rays dying at different bounces was B1's main loss
// with one ray a thread, which the regenerating lanes remove; B7 and B8
// are the ray compaction the JAX package uses on large scenes.  B8 moves its carry (96 bytes in
// and 96 out per lane) and k * 64 bytes of records per lane; its sweeps
// dominate as B1's do.

#include "render_common.cuh"

namespace {

using namespace ipt;

__device__ __forceinline__ void store_out(float* rad, float* stats, int n, int i, V3 r, float segs,
                                          float shadows) {
  rad[i] = r.x;
  rad[n + i] = r.y;
  rad[2 * n + i] = r.z;
  stats[i] = segs;
  stats[n + i] = shadows;
}

// B1 and B3: persistent blocks whose lanes regenerate (render_common.cuh
// warp_rays).  Each round a lane that traces a ray runs one bounce
// (bounce_step with the next sweep deferred) and, for B3, writes its
// record; a lane whose path ends writes its radiance and counts and takes
// the next ray of its warp's range; then every lane with a pending ray
// sweeps it together, the next ray of a path or a new primary ray.  The
// lane carries its ray index i, which keys the fused hash, the external
// uniforms' column, the camera ray and the output columns, so each ray's
// arithmetic is one thread's: B3's radiance and counts are B1's, bit for
// bit, and both are those of a thread that runs a ray's path to its end
// (the next ray is swept only where the path goes on; a sweep after
// roulette ends a path counts nothing).  B3's slots that a path does not
// reach must read zero: the launch clears the record array with a memset
// first, and the kernel stores the reached slots only.  Zeroing them in the
// kernel, by each lane at its path's end (a divergent loop of scattered
// stores) or by the warps before they hand out rays (coalesced), measured
// slower on the H100 (PERF.md §6).
template <bool kRecords, int kSweep>
__global__ void __launch_bounds__(kThreads, min_blocks(kSweep))
    render_kernel(const TraceParams P, float* rad, float* stats, float* rec) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables<kSweep>(P, reinterpret_cast<float*>(smem4));
  const int n = P.n;
  WarpRays w = warp_rays(n);
  std::conditional_t<kRecords, GlobalRecords, NoRecords> sink;
  if constexpr (kRecords) sink = GlobalRecords{rec, n, 0};  // sink.i: the lane's ray
  Lane L;
  uint32_t h_orig = 0;
  int i = 0;         // the lane's ray
  int b = 0;         // the bounce the lane enters next
  bool has = false;  // the lane traces a ray
  for (;;) {
    bool sweep = false;
    if (has) {
      float u[6];
      draw6(P, i, h_orig, b, b, u);
      const bool cont = bounce_step<kSweep, true>(P, T, L, b, u, sink, b);
      ++b;
      if (cont && b < P.max_bounces) {
        sweep = true;
      } else {
        store_out(rad, stats, n, i, L.rad, L.segs, L.shadows);
        has = false;
      }
    }
    const int next = take_ray(w, !has);
    if (next >= 0) {
      i = next;
      L = fresh_lane(P, i);
      if constexpr (kRecords) sink.i = i;
      b = 0;
      if (L.alive) {
        L.point = ray_origin(P, i);
        h_orig = hash_orig(P, i);
        has = sweep = true;
      } else {
        store_out(rad, stats, n, i, L.rad, 0.f, 0.f);
      }
    }
    if (w.next >= w.end && !__any_sync(kAllLanes, has)) break;
    if (sweep) sweep_from<kSweep>(P, T, L, L.point);
  }
}

// B7's blocks: kInitWarps warps.
constexpr int kInitThreads = 512;
constexpr int kInitWarps = kInitThreads / 32;

// B7, persistent: as many blocks as fit on the card with the tables'
// shared memory, each staging the tables once; warp w walks its fixed
// range of 32-lane chunks (render_common.cuh warp_chunks) and writes each
// lane's carry, a row at a time, lane-contiguous.  Each lane's arithmetic
// is init_lane's whatever its place, so the carry is the one-thread-a-ray
// kernel's, bit for bit.
template <bool kClustered>
__global__ void __launch_bounds__(kInitThreads, min_blocks(kClustered))
    init_kernel(const TraceParams P, float* carry) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables<kClustered>(P, reinterpret_cast<float*>(smem4));
  const LaneRange r = warp_chunks(P.n, kInitWarps);
  for (long long base = r.lo; base < r.hi; base += 32) {
    const int i = static_cast<int>(base) + (threadIdx.x & 31);
    if (i < r.hi) store_lane(carry, P.n, i, init_lane<kClustered>(P, T, i));
  }
}

// Lane i of a stage: its carry in, at most k bounces, its carry out and,
// with kRecords, its records (zero past its last bounce of the stage).
template <bool kRecords, bool kClustered>
__device__ __forceinline__ void stage_lane(const TraceParams& P, const Tables& T,
                                           const float* carry_in, float* carry_out, float* rec,
                                           int start, int k, int i) {
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

// dst[lo:hi] = src[lo:hi] (or 0 where src is null), shared by `workers`
// threads, this one `worker`: 16-byte loads and stores between a scalar
// head and tail where both pointers are 16-byte aligned.
__device__ __forceinline__ void copy_span(const float* src, float* dst, size_t lo, size_t hi,
                                          size_t worker, size_t workers) {
  const bool vec = ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  size_t lo4 = (lo + 3) & ~size_t(3), hi4 = hi & ~size_t(3);
  if (!vec || lo4 >= hi4) lo4 = hi4 = hi;  // all scalar
  for (size_t j = lo + worker; j < lo4; j += workers) dst[j] = src ? src[j] : 0.f;
  for (size_t j = lo4 / 4 + worker; j < hi4 / 4; j += workers) {
    reinterpret_cast<float4*>(dst)[j] =
        src ? reinterpret_cast<const float4*>(src)[j] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (size_t j = hi4 + worker; j < hi; j += workers) dst[j] = src ? src[j] : 0.f;
}

// B8, persistent: as many blocks as fit on the card at once, each staging
// the scene tables once.  The host sorts the carry live lanes first and
// passes the length of that prefix in *live (a device int; null: every
// lane may be alive).  Warps take 32-lane chunks of the prefix from the
// global counter *next (zero at launch) and run stage_lane on them; a warp
// that finds the queue empty copies its share of the carry of the lanes
// past the prefix, which are dead, and zeroes their records.  Each lane's
// arithmetic is stage_lane's whatever its place, so the result is the
// per-lane kernel's.
template <bool kRecords, bool kClustered>
__global__ void __launch_bounds__(kThreads, min_blocks(kClustered))
    stage_kernel(const TraceParams P, const float* carry_in, float* carry_out, float* rec,
                 int start, int k, const int* live, int* next) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables<kClustered>(P, reinterpret_cast<float*>(smem4));
  const int n = P.n;
  const int n_live = live == nullptr ? n : min(max(*live, 0), n);
  const int lane = threadIdx.x & 31;
  for (;;) {
    int base = 0;
    if (lane == 0) base = atomicAdd(next, 32);
    base = __shfl_sync(0xffffffffu, base, 0);
    if (base >= n_live) break;
    const int i = base + lane;
    if (i < n_live) stage_lane<kRecords, kClustered>(P, T, carry_in, carry_out, rec, start, k, i);
  }
  const size_t worker = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t workers = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (int r = 0; r < kCarryRows; ++r) {
    const size_t row = static_cast<size_t>(r) * n;
    copy_span(carry_in, carry_out, row + n_live, row + n, worker, workers);
  }
  if constexpr (kRecords) {
    for (int r = 0; r < k * kRecRows; ++r) {
      const size_t row = static_cast<size_t>(r) * n;
      copy_span(nullptr, rec, row + n_live, row + n, worker, workers);
    }
  }
}

// B10 (or the BVH traversal) alone, one ray a thread.  On the BVH route
// with `counts` not null, the traversal also counts its work, summed per
// warp and added to counts[0..3) (nodes popped, box tests, triangle tests).
template <int kSweep>
__global__ void __launch_bounds__(kThreads, min_blocks(kSweep))
    intersect_kernel(const TraceParams P, float* t_out, int* idx_out,
                     unsigned long long* counts) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables<kSweep>(P, reinterpret_cast<float*>(smem4));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const int n = P.n;
  if constexpr (kSweep == kSweepBvh) {
    if (counts != nullptr) {  // the same for the whole grid
      int c[3] = {0, 0, 0};
      if (i < n) {
        const Hit h = traverse<true>(P, T, v3(P.p[i], P.p[n + i], P.p[2 * n + i]),
                                     v3(P.d[i], P.d[n + i], P.d[2 * n + i]), c);
        t_out[i] = h.t;
        idx_out[i] = h.idx;
      }
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const unsigned sum = __reduce_add_sync(kAllLanes, static_cast<unsigned>(c[j]));
        if ((threadIdx.x & 31) == 0) atomicAdd(counts + j, static_cast<unsigned long long>(sum));
      }
      return;
    }
  }
  if (i >= n) return;
  const Hit h = intersect<kSweep>(P, T, v3(P.p[i], P.p[n + i], P.p[2 * n + i]),
                                  v3(P.d[i], P.d[n + i], P.d[2 * n + i]));
  t_out[i] = h.t;
  idx_out[i] = h.idx;
}

// B1's and B3's blocks that fit on the card at once, per instance
// ([kRecords][kSweep]) and device; B7's per [kClustered] and device.
Capacity g_render_capacity[2][3][kMaxDevices] = {};
Capacity g_init_capacity[2][kMaxDevices] = {};

cudaError_t init_capacity(TraceParams& P, int* blocks) {
  const size_t dyn = smem_tables(P, 0);
  Capacity* c = g_init_capacity[P.cluster_k ? 1 : 0];
  return P.cluster_k ? capacity(init_kernel<true>, c, dyn, blocks, kInitThreads)
                     : capacity(init_kernel<false>, c, dyn, blocks, kInitThreads);
}

// B1's (kRecords false) or B3's instance for the search flavour `sweep`.
using RenderKernel = void (*)(const TraceParams, float*, float*, float*);

template <bool kRecords>
RenderKernel render_instance(int sweep) {
  if (sweep == kSweepBvh) return render_kernel<kRecords, kSweepBvh>;
  if (sweep == kSweepClustered) return render_kernel<kRecords, kSweepClustered>;
  return render_kernel<kRecords, kSweepDense>;
}

cudaError_t render_capacity(TraceParams& P, bool records, int* blocks) {
  const size_t dyn = smem_tables(P, 0);
  const int sweep = sweep_of(P);
  Capacity* c = g_render_capacity[records][sweep];
  return records ? capacity(render_instance<true>(sweep), c, dyn, blocks)
                 : capacity(render_instance<false>(sweep), c, dyn, blocks);
}

// B1 (rec null) or B3 on `blocks` persistent blocks, at most the capacity.
cudaError_t launch_render(const TraceParams* Pin, float* rad, float* stats, float* rec, int blocks,
                          cudaStream_t s) {
  TraceParams P = *Pin;
  if (P.n <= 0) return cudaSuccess;
  int cap = 0;
  const bool records = rec != nullptr;
  const cudaError_t err = render_capacity(P, records, &cap);  // opts the kernel into its smem
  if (err != cudaSuccess) return err;
  if (blocks < 1 || blocks > cap) return cudaErrorInvalidValue;
  const size_t dyn = smem_tables(P, 0);
  if (records) {
    const size_t bytes = static_cast<size_t>(P.max_bounces) * kRecRows * P.n * sizeof(float);
    const cudaError_t e = cudaMemsetAsync(rec, 0, bytes, s);
    if (e != cudaSuccess) return e;
  }
  const RenderKernel kernel =
      records ? render_instance<true>(sweep_of(P)) : render_instance<false>(sweep_of(P));
  kernel<<<blocks, kThreads, dyn, s>>>(P, rad, stats, rec);
  return cudaGetLastError();
}

// Launches `kernel` on blocks of kThreads threads with `dyn` bytes of
// dynamic shared memory (opted into above 48 KB); returns the cudaError_t.
template <class K, class... Args>
int launch(K kernel, int blocks, size_t dyn, void* stream, Args... args) {
  cudaError_t err = allow_smem(kernel, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// B8's persistent launch: as many blocks as fit on the card at once with
// `dyn` bytes of dynamic shared memory, at most one per kThreads lanes.
template <class K>
int launch_persistent(K kernel, size_t dyn, void* stream, const TraceParams& P,
                      const float* carry_in, float* carry_out, float* rec, int start, int k,
                      const int* live, int* next) {
  cudaError_t err = allow_smem(kernel, dyn);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int blocks = min(per_sm * sms, blocks_for(P.n));
  kernel<<<blocks, kThreads, dyn, static_cast<cudaStream_t>(stream)>>>(P, carry_in, carry_out, rec,
                                                                      start, k, live, next);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// B1's (records 0) or B3's (records 1) blocks that fit on the card at once
// for the scene of *Pin (the wrapper launches at most that many:
// render_kernel.py persistent_blocks).  Returns the cudaError_t.
int ipt_render_capacity(const TraceParams* Pin, int records, int* blocks) {
  TraceParams P = *Pin;
  return static_cast<int>(render_capacity(P, records != 0, blocks));
}

// B1 on `blocks` persistent blocks: radiance (3, n) and counts (2, n) of
// the rays of *Pin.  Returns the cudaError_t.
int ipt_render_fwd(const TraceParams* Pin, float* rad, float* stats, int blocks, void* stream) {
  return static_cast<int>(
      launch_render(Pin, rad, stats, nullptr, blocks, static_cast<cudaStream_t>(stream)));
}

// B3 on `blocks` persistent blocks: radiance, counts and records
// (max_bounces * 16, n) into rec, which a memset clears first.
// Returns the cudaError_t.
int ipt_render_rec(const TraceParams* Pin, float* rad, float* stats, float* rec, int blocks,
                   void* stream) {
  if (rec == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      launch_render(Pin, rad, stats, rec, blocks, static_cast<cudaStream_t>(stream)));
}

// B7's grid for the rays of *Pin: the blocks that fit on the card at once,
// at most one per kInitThreads rays (none for n = 0).  Returns the
// cudaError_t.
int ipt_init_blocks(const TraceParams* Pin, int* blocks) {
  TraceParams P = *Pin;
  if (P.n_nodes) return static_cast<int>(cudaErrorInvalidValue);  // no staged BVH route
  int cap = 0;
  const cudaError_t err = init_capacity(P, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = min(cap, (P.n + kInitThreads - 1) / kInitThreads);
  return 0;
}

// B7 on `blocks` persistent blocks (ipt_init_blocks): the initial carry
// (kCarryRows, n) of the rays of *Pin.  Returns the cudaError_t.
int ipt_init_tile(const TraceParams* Pin, float* carry, int blocks, void* stream) {
  TraceParams P = *Pin;
  if (P.n_nodes) return static_cast<int>(cudaErrorInvalidValue);
  if (P.n <= 0) return 0;
  int cap = 0;
  const cudaError_t err = init_capacity(P, &cap);  // opts the kernel into its smem
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || blocks > cap) return static_cast<int>(cudaErrorInvalidValue);
  const size_t dyn = smem_tables(P, 0);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    init_kernel<true><<<blocks, kInitThreads, dyn, s>>>(P, carry);
  } else {
    init_kernel<false><<<blocks, kInitThreads, dyn, s>>>(P, carry);
  }
  return static_cast<int>(cudaGetLastError());
}

// B8: at most k bounces from global bounce `start` of the lanes of
// carry_in (kCarryRows, n) into carry_out, and records (k * 16, n) unless
// rec is null.  P.uniforms, when not null, holds the stage's k * 8 rows.
// *live (device; null: n) bounds the lanes that may be alive, all of them
// first; *next is a device int set to 0, the kernel's work counter.
int ipt_stage_tile(const TraceParams* Pin, const float* carry_in, float* carry_out, float* rec,
                   int start, int k, const int* live, int* next, void* stream) {
  TraceParams P = *Pin;
  if (P.n_nodes) return static_cast<int>(cudaErrorInvalidValue);
  if (P.n <= 0) return 0;
  const size_t dyn = smem_tables(P, 0);
  auto go = [&](auto kernel) {
    return launch_persistent(kernel, dyn, stream, P, carry_in, carry_out, rec, start, k, live,
                             next);
  };
  if (P.cluster_k) {
    return rec == nullptr ? go(stage_kernel<false, true>) : go(stage_kernel<true, true>);
  }
  return rec == nullptr ? go(stage_kernel<false, false>) : go(stage_kernel<true, false>);
}

// B10, or the BVH traversal on BVH tables: t (n,) and the internal triangle
// index (n,) of the closest hit of each ray of *Pin; on BVH tables with
// `counts` (3 zeroed device uint64s) not null, the traversal's work added
// to them.  Returns the cudaError_t.
int ipt_intersect_tile(const TraceParams* Pin, float* t, int* idx, unsigned long long* counts,
                       void* stream) {
  TraceParams P = *Pin;
  if (P.n <= 0) return 0;
  const size_t dyn = smem_tables(P, 0);
  const int b = blocks_for(P.n);
  switch (sweep_of(P)) {
    case kSweepBvh:
      return launch(intersect_kernel<kSweepBvh>, b, dyn, stream, P, t, idx, counts);
    case kSweepClustered:
      return launch(intersect_kernel<kSweepClustered>, b, dyn, stream, P, t, idx, counts);
    default:
      return launch(intersect_kernel<kSweepDense>, b, dyn, stream, P, t, idx, counts);
  }
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
