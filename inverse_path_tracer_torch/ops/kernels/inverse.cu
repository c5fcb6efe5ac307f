// Transport-graph extraction kernels for Hopper (sm_90a).
//
// B5, inverse_grid_kernel, replaces the JAX package's inverse_tile_pallas
// (inverse_path_tracer_tpu/ops/pallas/inverse_kernel.py:271) and B6,
// inverse_global_kernel and inverse_rec_kernel, replaces
// inverse_tile_pallas_rec (:338).  Both Pallas kernels run one body,
// _kernel_inv (:59), whose rec_mode flag picks where the edges go; here one
// segment of the bounce loop (inverse_segment) takes a sink.  Per ray and
// bounce (:135-249):
//   - the indirect edge dst -> src with weight w and f0 = 1, recorded
//     before the roulette test, so a path's last vertex still adds an edge;
//   - roulette on slot 4, a cosine direction about the face normal (slots
//     5, 6), `cosine` against the shading normal, w_next = w*cosine*pi/p_rr;
//   - NEE with the CDF pick on slot 1, the sqrt(r1) point (slots 2, 3) and
//     a shadow ray: nee_w = w cos(theta) cos(theta') / t^2 / p_light on the
//     edge src -> emitter with f0 = 1/pi and light = the emitter's emission;
//   - barycentric smooth shading on vertex-normal scenes.
// The eye is node nT, the first dst.  On clustered scenes (B10 in
// render_common.cuh) every triangle index of a record or of the grid is
// internal; the wrappers and the records reduction map them back.  p_spec
// must be 0 (the wrappers check), so the path is always diffuse and slot 0
// is never read.  The loop is not the forward's bounce_step
// (render_common.cuh): the slot map, the scalar weight and the edge order
// differ; it shares its helpers (the primary ray too, which camera mode
// makes in the kernel under the extraction's camera key), and -fmad=false,
// so the plain PyTorch version (inverse_kernel.py) takes the same
// branches.
//
// The sinks.  Each edge's quantities are [w, w*f0, w*f0*pix(3),
// w*f0*light(3), 1], formed in float32.
//   - B5 (GridSink<float>): each block keeps a (nT+1, nT, 9) float32 grid in
//     shared memory beside the scene tables (33,480 bytes at nT = 30; the
//     wrapper admits scenes whose grid and tables fit in 227 KB, about nT
//     <= 78) and writes it once to its slot of a partials array, which the
//     wrapper sums in float64.
//   - B6's global-grid sink (GridSink<double>): float64 atomic adds into one
//     (nT+1, nT, 9) grid in global memory, which the caller carries over
//     the launches of a range: the extraction's reduction, in the kernel.
//     The TPU cannot scatter, so the JAX package streams records and sorts
//     them; Hopper adds float64 in L2.  A per-block float64 copy of the eye
//     row in shared memory measured 0.5% slower than these adds once the
//     warp sums them (PERF.md), so there is none.
//   - B6's records sink (RecordSink): the 8 record rows of each reached
//     bounce, lane-contiguous ((max_bounces*8, n), rows dst, src, hit, w,
//     nee_ok, nee_w, e_idx, 0), zero past the ray's last bounce.
// The grid sinks first sum the lanes of a warp that add to one bin
// (warp_sum_by_key): a warp's 32 lanes are neighbouring samples, most of
// one pixel, whose first edges share the eye-row bin.  Atomics add in no
// fixed order, so the grids are not bit-reproducible; visit counts are
// exact.
//
// The schedules.  The records sink traces one ray per thread
// (trace_inverse): its stores stay lane-contiguous.  The grid sinks run
// persistent blocks whose lanes take a new ray as soon as their path ends
// (trace_persistent): with roulette at p_rr = 0.9 a path averages about 8
// of 16 bounces, and a warp of whole paths idles about half its lanes.
//
// Bound.  All run closest-hit sweeps, one per segment (the primary ray, or
// the next ray of a path that passed roulette) and one per shadow ray: f32
// ALU, as B1.  The records sink adds 16 * 8 * 4 bytes of record stores per
// ray (512 MiB per 2^20-ray launch); the global sink 9 float64 adds per
// edge, before the warp sums them.

#include "render_common.cuh"

namespace {

using namespace ipt;

constexpr int kQuant = 9;
constexpr int kInvRows = 8;

__host__ __device__ inline int grid_floats(int n_tri) { return (n_tri + 1) * n_tri * kQuant; }

// Adds one edge's quantities to g, the 9 entries of bin `bin`, for every
// lane that passes `valid`: the lanes of the warp that hit one bin are
// summed first in F (warp_sum_by_key) and one of them adds the sums.
template <class F>
__device__ __forceinline__ void add_edge(bool valid, int bin, F* g, float w, float wf, bool nee,
                                         V3 pix, V3 light) {
  int count = 0;
  if (!nee) {  // the indirect edge: w*f0 = w, no light
    F v[4] = {w, wf * pix.x, wf * pix.y, wf * pix.z};
    if (!warp_sum_by_key(__activemask(), valid, bin, v, &count)) return;
    atomicAdd(g + 0, v[0]);
    atomicAdd(g + 1, v[0]);
    atomicAdd(g + 2, v[1]);
    atomicAdd(g + 3, v[2]);
    atomicAdd(g + 4, v[3]);
  } else {
    F v[8] = {w, wf, wf * pix.x, wf * pix.y,
              wf * pix.z, wf * light.x, wf * light.y, wf * light.z};
    if (!warp_sum_by_key(__activemask(), valid, bin, v, &count)) return;
#pragma unroll
    for (int k = 0; k < 8; ++k) atomicAdd(g + k, v[k]);
  }
  atomicAdd(g + 8, static_cast<F>(count));
}

// The grid sinks: each edge's quantities, formed in float32 as RecordSink's
// reduction forms them (inverse_kernel.py _quantities), added to the
// (nT+1, nT, 9) grid at `grid` and summed in F.  B5: GridSink<float>, the
// block's grid in shared memory; B6's global-grid sink: GridSink<double>,
// the grid in global memory.
template <class F>
struct GridSink {
  F* grid;
  int n_tri;
  V3 pix;
  __device__ __forceinline__ void edge(bool valid, int dst, int src, float w, float wf, bool nee,
                                       V3 light) const {
    const int bin = dst * n_tri + src;
    add_edge(valid, bin, grid + static_cast<size_t>(bin) * kQuant, w, wf, nee, pix, light);
  }
  __device__ __forceinline__ void record(int, int, int, bool, float, bool, float, int) const {}
};

// B6's records sink: writes each reached bounce's record rows to global
// memory.
struct RecordSink {
  float* rec;
  int n, i;
  __device__ __forceinline__ void row(int b, int r, float v) const {
    rec[static_cast<size_t>(b * kInvRows + r) * n + i] = v;
  }
  __device__ __forceinline__ void edge(bool, int, int, float, float, bool, V3) const {}
  __device__ __forceinline__ void record(int b, int dst, int src, bool hit, float w, bool ok,
                                         float nee_w, int e_tri) const {
    const float v[kInvRows] = {static_cast<float>(dst), static_cast<float>(src), hit ? 1.f : 0.f,
                               w, ok ? 1.f : 0.f, nee_w, static_cast<float>(e_tri), 0.f};
#pragma unroll
    for (int r = 0; r < kInvRows; ++r) row(b, r, v[r]);
  }
  __device__ __forceinline__ void zero_from(int b0, int max_bounces) const {
    for (int b = b0; b < max_bounces; ++b) {
#pragma unroll
      for (int r = 0; r < kInvRows; ++r) row(b, r, 0.f);
    }
  }
};

// One lane of the inverse bounce loop: the ray it traces and where its path
// stands.
struct InvLane {
  int i;            // the ray (column of the inputs)
  uint32_t h_orig;  // the fused RNG's per-sample hash
  int b;            // the bounce of the pending segment
  int dst;          // the node the pending segment left (nT: the eye)
  float w;          // the path weight entering it
  Hit cur;          // its closest hit
  V3 point;         // and the hit point
  float segs, shadows;
};

// The lane of ray i before its primary sweep; *o and *dir are the primary
// ray (render_common.cuh fresh_lane: read, or made in camera mode).
__device__ __forceinline__ InvLane start_lane(const TraceParams& P, int i, V3* o, V3* dir) {
  *o = ray_origin(P, i);
  *dir = primary_dir(P, i);
  InvLane L;
  L.i = i;
  L.h_orig = hash_orig(P, i);
  L.b = 0;
  L.dst = P.n_tri;
  L.w = 1.f;
  L.segs = L.shadows = 0.f;
  return L;
}

// Segment L.b of lane L (the body of _kernel_inv's bounce loop, :135-249):
// its edges to sink.edge, its record to sink.record.  Returns true where
// the path goes on to bounce L.b + 1 (L then holds that bounce's weight,
// node and index) along *next_dir from L.point, which the caller sweeps.
template <bool kClustered, class Sink>
__device__ __forceinline__ bool inverse_segment(const TraceParams& P, const Tables& T, InvLane& L,
                                                const Sink& sink, V3* next_dir_out) {
  const int b = L.b;
  float u[7];
#pragma unroll
  for (int s = 0; s < 7; ++s) {
    if (P.fused) {
      const uint32_t ctr = static_cast<uint32_t>(b * 8 + s);
      u[s] = unit_from_bits(fmix32((L.h_orig + ctr * kGolden) ^ P.k1));
    } else {
      u[s] = P.uniforms[static_cast<size_t>(b * 8 + s) * P.n + L.i];
    }
  }
  L.segs += 1.f;
  const float w = L.w;
  const int dst = L.dst;
  const V3 point = L.point;
  if (!is_hit(L.cur)) {
    sink.record(b, dst, 0, false, w, false, 0.f, 0);
    return false;
  }
  const int src = L.cur.idx;
  const V3 face_n = ld3(T.table + kTableStride * src + 7);
  const V3 shade_n = P.has_vn
      ? smooth_at(point, T.vtab + kVtabStride * src, T.vtab + kVtabStride * src + 9,
                  T.vtab[kVtabStride * src + 18])
      : face_n;
  // The indirect edge, before the roulette test (inv_path_trace.cu:128).
  sink.edge(true, dst, src, w, w, false, zero3());

  const bool cont = u[4] < P.p_rr;
  const float phi = P.two_pi * u[5];
  const float cos_t = sqrtf(u[6]);
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
  const V3 next_dir = normalize3(rotate_z_to(face_n, v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t)));
  const float cosine = dot3(next_dir, shade_n);
  const float w_next = w * cosine * P.cos_scale;  // / pdf (1/pi) / p_rr

  bool ok = false;
  float nee_w = 0.f;
  int e_tri = 0;
  if (P.n_emissive > 0) {
    L.shadows += 1.f;
    int e = P.n_emissive - 1;  // u past cdf[-1] clamps to the last emitter
    for (int k = 0; k < P.n_emissive; ++k) {
      if (T.cdf[k] >= u[1]) {
        e = k;
        break;
      }
    }
    const float* er = T.etab + P.etab_stride * e;
    e_tri = static_cast<int>(er[15]);
    const float sq = sqrtf(u[2]);
    const float r2 = u[3];
    const V3 v0 = ld3(er), v1 = ld3(er + 3), v2 = ld3(er + 6);
    const V3 emm = v3((1.f - sq) * v0.x + sq * (1.f - r2) * v1.x + r2 * sq * v2.x,
                      (1.f - sq) * v0.y + sq * (1.f - r2) * v1.y + r2 * sq * v2.y,
                      (1.f - sq) * v0.z + sq * (1.f - r2) * v1.z + r2 * sq * v2.z);
    const V3 to_light = normalize3(emm - point);
    const float cos_theta = dot3(shade_n, to_light);
    const Hit sh = intersect<kClustered>(P, T, point, to_light);
    ok = cos_theta >= 0.f && is_hit(sh);
    const V3 light_n = P.has_vn
        ? smooth_at(hit_point(point, to_light, sh), er, er + 17, er[26])
        : ld3(er + 12);
    const float cos_theta_p = -dot3(light_n, to_light);
    ok = ok && cos_theta_p >= 0.f && sh.idx == e_tri;
    if (ok) nee_w = w * cos_theta * cos_theta_p / (sh.t * sh.t) / er[16];
    sink.edge(ok, src, e_tri, nee_w, nee_w * P.inv_pi, true, ld3(er + 9));
  }
  sink.record(b, dst, src, true, w, ok, nee_w, e_tri);
  // The next ray is swept only where the path goes on to another bounce.
  if (!cont || b + 1 == P.max_bounces) return false;
  L.w = w_next;
  L.dst = src;
  L.b = b + 1;
  *next_dir_out = next_dir;
  return true;
}

// The closest hit of lane L's pending segment, along dir from o.
template <bool kClustered>
__device__ __forceinline__ void sweep_segment(const TraceParams& P, const Tables& T, InvLane& L,
                                              V3 o, V3 dir) {
  L.cur = intersect<kClustered>(P, T, o, dir);
  L.point = hit_point(o, dir, L.cur);
}

// The whole path of ray i, one thread to the ray (B6's records sink).
// Returns the bounces it entered; the counts go to stats.
template <bool kClustered, class Sink>
__device__ __forceinline__ int trace_inverse(const TraceParams& P, const Tables& T, int i,
                                             const Sink& sink, float* stats) {
  if (!lane_alive(P, i)) {
    stats[i] = stats[P.n + i] = 0.f;
    return 0;
  }
  V3 o, dir;
  InvLane L = start_lane(P, i, &o, &dir);
  sweep_segment<kClustered>(P, T, L, o, dir);
  while (inverse_segment<kClustered>(P, T, L, sink, &dir))
    sweep_segment<kClustered>(P, T, L, L.point, dir);
  stats[i] = L.segs;
  stats[P.n + i] = L.shadows;
  return L.b + 1;
}

// The observed colour of ray i's pixel: column i of pix (3, n), or in
// camera mode row clip(g / spp, 0, W*H - 1) of the image pix (W*H, 3),
// g = base + i (render/inverse.py's pixel of a sample).
__device__ __forceinline__ V3 lane_pix(const TraceParams& P, const float* pix, int i) {
  if (!P.camera) return v3(pix[i], pix[P.n + i], pix[2 * P.n + i]);
  const long long last = static_cast<long long>(P.width) * P.height - 1;
  const long long q = pixel_of(P, P.base + i);
  return ld3(pix + 3 * (q > last ? last : q));
}

// The persistent schedule of the grid sinks (B5 and B6's global sink):
// each lane traces rays until the launch has none left, and a lane whose
// path ends takes the next unstarted ray, so that a warp's lanes stay busy
// under roulette.  A warp takes rays 32 at a time from the launch's counter
// `next_ray` (one atomicAdd per 32 rays) and hands them out in lane order
// to the lanes that ask (__ballot_sync).  Each round is one segment of
// every lane: its edges and shadow sweep, then one sweep, of its next
// segment or of its new ray's primary ray.  A ray's arithmetic and its
// counts are those of trace_inverse.  `sink` is copied per lane and takes
// the pixel colour of the lane's ray.
template <bool kClustered, class Sink>
__device__ __forceinline__ void trace_persistent(const TraceParams& P, const Tables& T,
                                                 const float* pix, float* stats, int* next_ray,
                                                 Sink sink) {
  constexpr unsigned kAll = 0xffffffffu;
  const int n = P.n;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  int pool = 0, pool_left = 0;  // the warp's unstarted rays [pool, pool + pool_left)
  bool has = false;             // the lane traces a ray
  bool more = true;             // the launch may still have rays for it
  InvLane L;
  for (;;) {
    V3 o = zero3(), dir = zero3();
    bool sweep = false;
    if (has) {
      sweep = inverse_segment<kClustered>(P, T, L, sink, &dir);
      if (sweep) {
        o = L.point;
      } else {
        stats[L.i] = L.segs;
        stats[n + L.i] = L.shadows;
        has = false;
      }
    }
    const unsigned need = __ballot_sync(kAll, !has && more);
    if (need != 0u) {
      const int k = __popc(need);
      int fresh = 0;
      if (k > pool_left) {
        const int leader = __ffs(need) - 1;
        if (lane == leader) fresh = atomicAdd(next_ray, 32);
        fresh = __shfl_sync(kAll, fresh, leader);
      }
      if (!has && more) {
        const int r = __popc(need & below);
        const int i = r < pool_left ? pool + r : fresh + (r - pool_left);
        if (i >= n) {
          more = false;
        } else if (!lane_alive(P, i)) {
          stats[i] = stats[n + i] = 0.f;
        } else {
          L = start_lane(P, i, &o, &dir);
          sink.pix = lane_pix(P, pix, i);
          has = sweep = true;
        }
      }
      if (k > pool_left) {
        pool = fresh + (k - pool_left);
        pool_left = 32 - (k - pool_left);
      } else {
        pool += k;
        pool_left -= k;
      }
    }
    if (!__any_sync(kAll, has || more)) break;
    if (sweep) sweep_segment<kClustered>(P, T, L, o, dir);
  }
}

template <bool kClustered>
__global__ void __launch_bounds__(kThreads, min_blocks(kClustered))
    inverse_grid_kernel(const TraceParams P, const float* pix, float* partials, float* stats,
                        int* next_ray) {
  extern __shared__ float4 smem4[];
  float* grid = reinterpret_cast<float*>(smem4);
  const int g_count = grid_floats(P.n_tri);
  for (int e = threadIdx.x; e < g_count; e += blockDim.x) grid[e] = 0.f;
  const Tables T = stage_tables<kClustered>(P, grid + ((g_count + 3) & ~3));
  __syncthreads();
  trace_persistent<kClustered>(P, T, pix, stats, next_ray,
                               GridSink<float>{grid, P.n_tri, zero3()});
  __syncthreads();
  float* out = partials + static_cast<size_t>(blockIdx.x) * g_count;
  for (int e = threadIdx.x; e < g_count; e += blockDim.x) out[e] = grid[e];
}

// B6 with the global-grid sink: persistent blocks, as B5's, adding every
// edge into `grid` (the (nT+1, nT, 9) float64 grid the caller zeroed or
// carries over launches).
template <bool kClustered>
__global__ void __launch_bounds__(kThreads, min_blocks(kClustered))
    inverse_global_kernel(const TraceParams P, const float* pix, double* grid, float* stats,
                          int* next_ray) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables<kClustered>(P, reinterpret_cast<float*>(smem4));
  trace_persistent<kClustered>(P, T, pix, stats, next_ray,
                               GridSink<double>{grid, P.n_tri, zero3()});
}

template <bool kClustered>
__global__ void __launch_bounds__(kThreads, min_blocks(kClustered))
    inverse_rec_kernel(const TraceParams P, float* rec, float* stats) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables<kClustered>(P, reinterpret_cast<float*>(smem4));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const RecordSink sink{rec, P.n, i};
  sink.zero_from(trace_inverse<kClustered>(P, T, i, sink, stats), P.max_bounces);
}

// B5's dynamic shared memory: the padded grid, then the tables.
size_t grid_smem_bytes(const TraceParams& P) {
  return static_cast<size_t>((grid_floats(P.n_tri) + 3) & ~3) * sizeof(float) +
         smem_table_bytes(P);
}

// Per kernel instance and device: render_common.cuh capacity().
Capacity g_grid_capacity[2][kMaxDevices] = {};
Capacity g_global_capacity[2][kMaxDevices] = {};

cudaError_t grid_capacity(const TraceParams& P, int* blocks) {
  const size_t smem = grid_smem_bytes(P);
  return P.cluster_k ? capacity(inverse_grid_kernel<true>, g_grid_capacity[1], smem, blocks)
                     : capacity(inverse_grid_kernel<false>, g_grid_capacity[0], smem, blocks);
}

// The global-grid sink's dynamic shared memory is the tables' where
// smem_tables admits them (it sets P.use_smem).
cudaError_t global_capacity(TraceParams& P, int* blocks) {
  const size_t smem = smem_tables(P, 0);
  return P.cluster_k ? capacity(inverse_global_kernel<true>, g_global_capacity[1], smem, blocks)
                     : capacity(inverse_global_kernel<false>, g_global_capacity[0], smem, blocks);
}

// A persistent kernel's blocks for n rays: as many as fit on the card at
// once, at most one per kThreads rays.
int persistent_blocks(int n, int capacity) {
  const int by_rays = (n + kThreads - 1) / kThreads;
  return by_rays < capacity ? (by_rays > 0 ? by_rays : 1) : capacity;
}

}  // namespace

extern "C" {

// B5's block count for the rays of *Pin.  Returns the cudaError_t.
int ipt_inverse_grid_blocks(const TraceParams* Pin, int* blocks) {
  TraceParams P = *Pin;
  if (P.n_nodes) return static_cast<int>(cudaErrorInvalidValue);  // no BVH flavour
  P.use_smem = 1;
  int cap = 0;
  const cudaError_t err = grid_capacity(P, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = persistent_blocks(P.n, cap);
  return 0;
}

// B5: partials (blocks, nT+1, nT, 9) and stats (2, n) for the rays of *Pin
// and their pixel colours pix (3, n), or in camera mode the target image
// pix (W*H, 3).  Returns the cudaError_t.
int ipt_inverse_grid(const TraceParams* Pin, const float* pix, float* partials, float* stats,
                     int* next_ray, int blocks, void* stream) {
  TraceParams P = *Pin;
  if (P.n_nodes) return static_cast<int>(cudaErrorInvalidValue);
  P.use_smem = 1;
  if (P.cluster_k && !(aligned16(P.planes) && aligned16(P.cab) && aligned16(P.gab)))
    return static_cast<int>(cudaErrorMisalignedAddress);  // the TMA copy's sources
  int cap = 0;
  const cudaError_t err = grid_capacity(P, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = grid_smem_bytes(P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    inverse_grid_kernel<true><<<blocks, kThreads, smem, s>>>(P, pix, partials, stats, next_ray);
  } else {
    inverse_grid_kernel<false><<<blocks, kThreads, smem, s>>>(P, pix, partials, stats, next_ray);
  }
  return static_cast<int>(cudaGetLastError());
}

// B6 with the global-grid sink: adds the edges of the rays of *Pin, with
// their pixel colours pix (3, n; camera mode: the image (W*H, 3)), to grid
// ((nT+1) * nT * 9 float64) and
// writes stats (2, n); next_ray is a zeroed int.  Returns the cudaError_t.
int ipt_inverse_global(const TraceParams* Pin, const float* pix, double* grid, float* stats,
                       int* next_ray, void* stream) {
  TraceParams P = *Pin;
  if (P.n_nodes) return static_cast<int>(cudaErrorInvalidValue);
  if (P.n <= 0) return 0;
  int cap = 0;
  const cudaError_t err = global_capacity(P, &cap);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = persistent_blocks(P.n, cap);
  const size_t smem = smem_tables(P, 0);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    inverse_global_kernel<true><<<blocks, kThreads, smem, s>>>(P, pix, grid, stats, next_ray);
  } else {
    inverse_global_kernel<false><<<blocks, kThreads, smem, s>>>(P, pix, grid, stats, next_ray);
  }
  return static_cast<int>(cudaGetLastError());
}

// B6 with the records sink: records (max_bounces * 8, n) and stats (2, n)
// for the rays of *Pin.  The tables go to shared memory as B1's
// (render_common.cuh smem_tables).
int ipt_inverse_rec(const TraceParams* Pin, float* rec, float* stats, void* stream) {
  TraceParams P = *Pin;
  if (P.n_nodes) return static_cast<int>(cudaErrorInvalidValue);
  if (P.n <= 0) return 0;
  const size_t dyn = smem_tables(P, 0);
  const int blocks = (P.n + kThreads - 1) / kThreads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = P.cluster_k ? allow_smem(inverse_rec_kernel<true>, dyn)
                                : allow_smem(inverse_rec_kernel<false>, dyn);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (P.cluster_k) {
    inverse_rec_kernel<true><<<blocks, kThreads, dyn, s>>>(P, rec, stats);
  } else {
    inverse_rec_kernel<false><<<blocks, kThreads, dyn, s>>>(P, rec, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
