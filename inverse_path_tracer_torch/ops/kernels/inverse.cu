// Transport-graph extraction kernels for Hopper (sm_90a).
//
// B5, inverse_grid_kernel, replaces the JAX package's inverse_tile_pallas
// (inverse_path_tracer_tpu/ops/pallas/inverse_kernel.py:271) and B6,
// inverse_rec_kernel, replaces inverse_tile_pallas_rec (:338).  Both Pallas
// kernels run one body, _kernel_inv (:59), whose rec_mode flag picks where
// the edges go; here one bounce loop (trace_inverse) takes a sink.  Per ray
// and bounce (:135-249):
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
// internal; the wrapper and the records reduction map them back.  p_spec
// must be 0 (the wrapper checks),
// so the path is always diffuse and slot 0 is never read.  The loop is not
// trace_path (render_common.cuh): the slot map, the scalar weight and the
// edge order differ; it shares its helpers, and -fmad=false, so the plain
// PyTorch version (inverse_kernel.py) takes the same branches.
//
// B5's sink.  Each block keeps a (nT+1, nT, 9) float32 grid in shared
// memory beside the scene tables (33,480 bytes of grid at nT = 30; the
// wrapper admits scenes whose grid and tables fit in 227 KB, about nT <=
// 78) and adds each edge's quantities [w, w*f0, w*f0*pix(3), w*f0*light(3),
// 1] with shared-memory atomicAdd.  The grid is persistent: as many blocks
// as fit on the card at once loop over the rays, then each writes its grid
// once to its own slot of a partials array, which the wrapper sums in
// float64.  Shared atomics add in no fixed order, so B5 is not
// bit-reproducible; visit counts are exact (integers far below 2^24 per
// block).
//
// B6's sink writes the 8 record rows of each reached bounce, lane-
// contiguous ((max_bounces*8, n), rows dst, src, hit, w, nee_ok, nee_w,
// e_idx, 0), and zeroes the slots past the ray's last bounce.
//
// Bound.  Both run closest-hit sweeps: one per segment (the primary ray, or
// the next ray of a path that passed roulette) and one per shadow ray: f32
// ALU, as B1.  B6 adds 16 * 8 * 4 bytes of record
// stores per ray (512 MiB per 2^20-ray launch), a tenth of B1's time at
// 3.35 TB/s.  B5's grid traffic stays on chip; its shared atomics collide
// where a warp's lanes hit one triangle (the eye row above all).

#include "render_common.cuh"

namespace {

using namespace ipt;

constexpr int kQuant = 9;
constexpr int kInvRows = 8;

__host__ __device__ inline int grid_floats(int n_tri) { return (n_tri + 1) * n_tri * kQuant; }

// B5: adds edges to the block's grid in shared memory.
struct GridSink {
  float* grid;
  int n_tri;
  V3 pix;
  __device__ __forceinline__ void edge(int dst, int src, float w, float wf, bool nee,
                                       V3 light) const {
    float* g = grid + (dst * n_tri + src) * kQuant;
    atomicAdd(g + 0, w);
    atomicAdd(g + 1, wf);
    atomicAdd(g + 2, wf * pix.x);
    atomicAdd(g + 3, wf * pix.y);
    atomicAdd(g + 4, wf * pix.z);
    if (nee) {  // the indirect edge carries no light
      atomicAdd(g + 5, wf * light.x);
      atomicAdd(g + 6, wf * light.y);
      atomicAdd(g + 7, wf * light.z);
    }
    atomicAdd(g + 8, 1.f);
  }
  __device__ __forceinline__ void record(int, int, int, bool, float, bool, float, int) const {}
};

// B6: writes each reached bounce's record rows to global memory.
struct RecordSink {
  float* rec;
  int n, i;
  __device__ __forceinline__ void row(int b, int r, float v) const {
    rec[static_cast<size_t>(b * kInvRows + r) * n + i] = v;
  }
  __device__ __forceinline__ void edge(int, int, float, float, bool, V3) const {}
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

struct InvOut {
  float segs, shadows;
  int n_reached;
};

// The inverse bounce loop of ray i (_kernel_inv :135-249).
template <bool kClustered, class Sink>
__device__ __forceinline__ InvOut trace_inverse(const TraceParams& P, const Tables& T, int i,
                                                const Sink& sink) {
  InvOut out{0.f, 0.f, 0};
  if (!(P.alive[i] > 0.f)) return out;
  const int n = P.n;
  const uint32_t h_orig = P.fused ? fmix32(static_cast<uint32_t>(P.orig[i]) ^ P.k0) : 0u;
  const V3 o = v3(P.p[i], P.p[n + i], P.p[2 * n + i]);
  const V3 d = v3(P.d[i], P.d[n + i], P.d[2 * n + i]);
  Hit cur = intersect<kClustered>(P, T, o, d);
  V3 point = hit_point(o, d, cur);
  float w = 1.f;
  int dst = P.n_tri;  // the eye

  for (int b = 0; b < P.max_bounces; ++b) {
    float u[7];
#pragma unroll
    for (int s = 0; s < 7; ++s) {
      if (P.fused) {
        const uint32_t ctr = static_cast<uint32_t>(b * 8 + s);
        u[s] = unit_from_bits(fmix32((h_orig + ctr * kGolden) ^ P.k1));
      } else {
        u[s] = P.uniforms[static_cast<size_t>(b * 8 + s) * n + i];
      }
    }
    out.segs += 1.f;
    out.n_reached = b + 1;
    if (!is_hit(cur)) {
      sink.record(b, dst, 0, false, w, false, 0.f, 0);
      break;
    }
    const int src = cur.idx;
    const V3 face_n = ld3(T.table + kTableStride * src + 7);
    const V3 shade_n = P.has_vn
        ? smooth_at(point, T.vtab + kVtabStride * src, T.vtab + kVtabStride * src + 9,
                    T.vtab[kVtabStride * src + 18])
        : face_n;
    // The indirect edge, before the roulette test (inv_path_trace.cu:128).
    sink.edge(dst, src, w, w, false, zero3());

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
      out.shadows += 1.f;
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
      if (ok) {
        nee_w = w * cos_theta * cos_theta_p / (sh.t * sh.t) / er[16];
        sink.edge(src, e_tri, nee_w, nee_w * P.inv_pi, true, ld3(er + 9));
      }
    }
    sink.record(b, dst, src, true, w, ok, nee_w, e_tri);
    // The next ray is swept only where the path goes on to another bounce.
    if (!cont || b + 1 == P.max_bounces) break;
    w = w_next;
    dst = src;
    cur = intersect<kClustered>(P, T, point, next_dir);
    point = hit_point(point, next_dir, cur);
  }
  return out;
}

template <bool kClustered>
__global__ void __launch_bounds__(kThreads)
    inverse_grid_kernel(const TraceParams P, const float* pix, float* partials, float* stats) {
  extern __shared__ float4 smem4[];
  float* grid = reinterpret_cast<float*>(smem4);
  const int g_count = grid_floats(P.n_tri);
  for (int e = threadIdx.x; e < g_count; e += blockDim.x) grid[e] = 0.f;
  const Tables T = stage_tables<kClustered>(P, grid + ((g_count + 3) & ~3));
  __syncthreads();

  const int n = P.n;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const GridSink sink{grid, P.n_tri, v3(pix[i], pix[n + i], pix[2 * n + i])};
    const InvOut o = trace_inverse<kClustered>(P, T, i, sink);
    stats[i] = o.segs;
    stats[n + i] = o.shadows;
  }
  __syncthreads();
  float* out = partials + static_cast<size_t>(blockIdx.x) * g_count;
  for (int e = threadIdx.x; e < g_count; e += blockDim.x) out[e] = grid[e];
}

template <bool kClustered>
__global__ void __launch_bounds__(kThreads, min_blocks(kClustered))
    inverse_rec_kernel(const TraceParams P, float* rec, float* stats) {
  extern __shared__ float4 smem4[];
  const Tables T = stage_tables<kClustered>(P, reinterpret_cast<float*>(smem4));
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const RecordSink sink{rec, P.n, i};
  const InvOut o = trace_inverse<kClustered>(P, T, i, sink);
  sink.zero_from(o.n_reached, P.max_bounces);
  stats[i] = o.segs;
  stats[P.n + i] = o.shadows;
}

// B5's dynamic shared memory: the padded grid, then the tables.
size_t grid_smem_bytes(const TraceParams& P) {
  return static_cast<size_t>((grid_floats(P.n_tri) + 3) & ~3) * sizeof(float) +
         smem_table_bytes(P);
}

// Per device and sweep, the dynamic shared memory inverse_grid_kernel was
// last opted into and the blocks that then fit on the card at once; the
// attribute and the occupancy query are redone only when a scene changes
// the size.
struct GridCapacity {
  size_t smem;
  int blocks;
};
constexpr int kMaxDevices = 64;
GridCapacity g_capacity[2][kMaxDevices] = {};

// Opts inverse_grid_kernel<kClustered> into `smem` bytes on the current
// device and returns in *blocks how many of its blocks fit on the card at
// once.
template <bool kClustered>
cudaError_t grid_capacity(size_t smem, int* blocks) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  GridCapacity& c = g_capacity[kClustered][dev];
  if (c.smem != smem) {
    err = cudaFuncSetAttribute(inverse_grid_kernel<kClustered>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inverse_grid_kernel<kClustered>,
                                                          kThreads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    c = GridCapacity{smem, per_sm * sms};
  }
  *blocks = c.blocks;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// B5's block count for the rays of *Pin: as many blocks as fit on the card
// at once, at most one per 256 rays.  Returns the cudaError_t.
int ipt_inverse_grid_blocks(const TraceParams* Pin, int* blocks) {
  const TraceParams& P = *Pin;
  int capacity = 0;
  const size_t smem = grid_smem_bytes(P);
  const cudaError_t err =
      P.cluster_k ? grid_capacity<true>(smem, &capacity) : grid_capacity<false>(smem, &capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int by_rays = (P.n + kThreads - 1) / kThreads;
  *blocks = by_rays < capacity ? (by_rays > 0 ? by_rays : 1) : capacity;
  return 0;
}

// B5: partials (blocks, nT+1, nT, 9) and stats (2, n) for the rays of *Pin
// and their pixel colours pix (3, n).  Returns the cudaError_t.
int ipt_inverse_grid(const TraceParams* Pin, const float* pix, float* partials, float* stats,
                     int blocks, void* stream) {
  TraceParams P = *Pin;
  P.use_smem = 1;
  if (P.cluster_k && !(aligned16(P.planes) && aligned16(P.cab) && aligned16(P.gab)))
    return static_cast<int>(cudaErrorMisalignedAddress);  // the TMA copy's sources
  const size_t smem = grid_smem_bytes(P);
  int capacity = 0;
  const cudaError_t err =
      P.cluster_k ? grid_capacity<true>(smem, &capacity) : grid_capacity<false>(smem, &capacity);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P.cluster_k) {
    inverse_grid_kernel<true><<<blocks, kThreads, smem, s>>>(P, pix, partials, stats);
  } else {
    inverse_grid_kernel<false><<<blocks, kThreads, smem, s>>>(P, pix, partials, stats);
  }
  return static_cast<int>(cudaGetLastError());
}

// B6: records (max_bounces * 8, n) and stats (2, n) for the rays of *Pin.
// The tables go to shared memory as B1's (render_common.cuh smem_tables).
int ipt_inverse_rec(const TraceParams* Pin, float* rec, float* stats, void* stream) {
  TraceParams P = *Pin;
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
