// Device code shared by render_fwd.cu (B1, B3, B7, B8, B10),
// render_bwd.cu (B2, B4, B9) and inverse.cu (B5, B6): the vector helpers,
// the counter-hash RNG, the closest-hit sweep with its clustered form
// (B10), the shading helpers and the bounce loop of one ray as a lane state
// (Lane), an init step (init_lane) and a bounce step (bounce_step), and the
// persistent schedules: regenerating lanes (warp_rays: B1, B2, B3) and
// fixed chunk ranges (warp_chunks: B7, B9).
//
// The regenerating loops of B1, B2 and B3 (warp_rays below) and the stage
// kernel run the same steps, templated on a record sink, so that B1 (no
// records), B3 and B8 (records to global memory) and B2 (records in a
// per-thread ring) run one copy of the arithmetic.  Every
// file that includes this header is built with -fmad=false (build.py), so
// B2's replay takes exactly the branches of B1's forward, a staged render
// equals a mega one lane for lane, and all of them round exactly as the
// plain PyTorch versions do.
//
// Records: kRecRows rows per bounce, row-major (slots * kRecRows, n),
// lane-contiguous so that stores and loads coalesce.  The rows of bounce b
// are f(3) c(3) nee(3) pm_in(3) coeff tri hit esc, the layout of the JAX
// package's REC_ROWS (ops/pallas/render_kernel.py:118, :922-926):
//   f      throughput factor bsdf * coeff (0 when roulette ends the path);
//   c      the bounce's contribution l_e + l_d (the stale l_d on escape
//          under quirk Q2, else 0 on escape);
//   nee    the material-independent NEE factor l_o * geo (0 unless the
//          shadow ray reached the light);
//   pm_in  the throughput entering the bounce;
//   coeff  cosine / pdf / p_rr (0 when roulette ends the path);
//   tri    the hit triangle (0 on a miss), as a float;
//   hit    1 where the bounce hit, esc 1 where the ray escaped.
// Slots past a ray's last bounce are zero.
//
// The lane carry of the staged kernels: kCarryRows rows, lane-contiguous,
// the JAX package's CARRY_ROWS layout (render_kernel.py:120-123): d 0:3,
// point 3:6, hit 6, idx 7, l_e 8:11, l_d 11:14, prev_mult 14:17, alive 17,
// radiance 18:21, segments 21, shadow rays 22, pad 23.
//
// B10, the clustered sweep (replaces the cluster-chunked sweep of the JAX
// package's _make_geom, render_kernel.py:358-527).  On scenes of at least
// CLUSTER_MIN_TP padded triangles (ops/kernels/clusters.py: 128 on the H100,
// 512 in the JAX package) the tables are in an internal order whose
// contiguous runs of cluster_k triangles are spatially compact clusters
// (ops/kernels/clusters.py; 16 by default on this card), and runs of
// cluster_group clusters 1.. have a group box, the union of theirs.
// intersect() sweeps cluster 0 (the largest triangles) for every ray; then
// it tests each group's box and, where this thread's ray enters it no later
// than its closest hit so far, the boxes of the group's clusters, sweeping
// a cluster where the ray enters its margin-padded box no later than its
// closest hit: a per-ray skip where the TPU kernel skips a cluster for a
// whole ray block.  Clusters go in ascending order and a hit replaces the
// running one only when strictly closer, so the result is the dense
// sweep's, ties to the lowest internal index.  The plane rows and the boxes
// are copied into shared memory by TMA where they fit (stage_tables).
// Bound: the (ray, triangle) tests swept and the (ray, box) tests, f32 ALU
// as the dense sweep; a box test is 6 mul, 6 sub and 10 min/max.
//
// The BVH traversal (the BVH route, RenderConfig.intersect="bvh" on a scene
// with a BVH; no Pallas counterpart: the JAX package's route is XLA code,
// its ops/bvh.py intersect_bvh).  The tables are in the tree's leaf order
// (ops/kernels/clusters.py kernel_view), so a leaf's triangles are the
// contiguous plane rows [start, start + n_prims); P.nodes holds one 32-byte
// row per node: the box padded as the cluster boxes are, then, as int bits,
// a leaf's first row or an inner node's right-child offset (its left child
// is the next row), and the leaf's triangle count (0 for an inner node).
// traverse() pops one node at a time from a per-thread stack of kMaxStack
// nodes (local memory), tests its box against the closest hit so far, and
// either tests a leaf's triangles with the sweep's arithmetic or tests both
// children's boxes and pushes those the ray enters, the farther first:
// ops/bvh.py intersect_bvh's steps, ray by ray.  A node is culled only
// where the ray enters its box strictly after the closest hit, and a hit
// replaces the running one when it is closer or, at an equal t, has a lower
// global triangle index (P.tri_index), so the result is the dense sweep's
// in global order, bit for bit.  The host refuses a tree deeper than the
// stack (ops/bvh.py check_bvh), so the stack cannot overflow; the kernel
// traps if it would.  The node table stays in global memory, read through
// L1.  Bound: the (ray, box) tests and the (ray, triangle) tests of this
// run's rays, f32 ALU as B10's.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace ipt {

constexpr int kPlaneStride = 16;  // n, -c.n, out0, d0, out1, d1, out2, d2
constexpr int kTableStride = 16;  // emission 0:3 spec 3:6 shin 6 face_n 7:10 kd 10:13
constexpr int kVtabStride = 20;   // verts 0:9 vertex normals 9:18 area 18
// Emitter rows: verts 0:9 emission 9:12 face_n 12:15 tri 15 p 16
// (+ vertex normals 17:26, area 26 on vertex-normal scenes).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 48 * 1024;  // shared memory without an opt-in
constexpr int kMaxSmem = 232448;       // a block's opt-in dynamic shared memory
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kMaxStack = 64;  // BVH traversal stack (ops/bvh.py MAX_STACK)

// The flavours of the closest-hit search, a template parameter of every
// kernel that searches (a bool kClustered converts to the first two).
enum Sweep : int { kSweepDense = 0, kSweepClustered = 1, kSweepBvh = 2 };

// The register budget of a kernel, __launch_bounds__'s minimum blocks per
// SM: two blocks of kThreads for the clustered kernels, whose sweep tables
// (~85 KB of shared memory on the large scene) let two blocks share an SM,
// which leaves 128 registers a thread; 0 (none) for the dense and BVH
// kernels, which keep ptxas's own choice (a minimum of 1 made ptxas give B1
// 98 registers, and it ran 25% slower on scene 0).
__host__ __device__ constexpr int min_blocks(int sweep) { return sweep == kSweepClustered ? 2 : 0; }
constexpr int kRecRows = 16;
constexpr int kCarryRows = 24;

// The inputs of the bounce loop.  Pointers to the scene tables are the
// global copies; stage_tables returns the ones a block reads.  The primary
// rays come from p, d, alive and orig, or, in camera mode (camera = 1),
// from camera_ray: lane i then traces global sample base + i, and those
// four pointers are not read.
struct TraceParams {
  const float* p;         // (3, n)
  const float* d;         // (3, n)
  const float* alive;     // (n,)
  const int32_t* orig;    // (n,) global sample index
  const float* uniforms;  // (max_bounces*8, n), or null in fused mode
  const float* planes;    // (nT, 16)
  const float* table;     // (nT, 16)
  const float* vtab;      // (nT, 20), or null on flat scenes
  const float* etab;      // (nE, etab_stride)
  const float* cdf;       // (nE,)
  const float* cab;       // (n_clusters, 8) cluster boxes, or null (dense sweep)
  const float* gab;       // (n_groups, 8) boxes of the groups of clusters 1..
  uint32_t k0, k1;
  int n, n_tri, n_emissive, etab_stride;
  int has_vn, no_spec, quirks, fused, max_bounces, use_smem;
  int cluster_k, n_clusters;  // 0, 0: the dense sweep
  int cluster_group, n_groups;  // clusters per group box, group boxes
  float p_rr, min_dot, epsilon;
  float two_pi, inv_pi, inv_2pi, cos_scale, inv_p_rr;
  // Camera mode: the launch's first global sample, the render's sample
  // count (a lane past it is dead), the image and its samples per pixel,
  // the (3, 3) row-major camera matrix and the camera jitter's key words.
  long long base, n_samples;
  const float* cam;
  int camera, width, height, spp;
  uint32_t ck0, ck1;
  // The BVH route (n_nodes > 0; the tables in the tree's leaf order): the
  // node rows (header comment) and the global triangle index of each plane
  // row, which breaks ties.
  const float* nodes;         // (n_nodes, 8)
  const int32_t* tri_index;   // (n_tri,)
  int n_nodes;
};

struct Tables {
  const float* planes;
  const float* table;
  const float* vtab;
  const float* etab;
  const float* cdf;
  const float* cab;
  const float* gab;
  const float* nodes;
  const int32_t* tri_index;
};

// The search flavour of the tables of *P.
inline int sweep_of(const TraceParams& P) {
  return P.n_nodes ? kSweepBvh : P.cluster_k ? kSweepClustered : kSweepDense;
}

// Floats the scene tables take in shared memory, each array padded to 16
// bytes.
inline long long table_floats(int n_tri, int has_vn, int n_emissive, int etab_stride) {
  auto padded = [](long long c) { return (c + 3) & ~3LL; };
  return padded((long long)n_tri * kPlaneStride) + padded((long long)n_tri * kTableStride) +
         (has_vn ? padded((long long)n_tri * kVtabStride) : 0) +
         padded((long long)n_emissive * etab_stride) + padded(n_emissive);
}

// Bytes of the tables a block keeps in shared memory: every table on the
// dense sweep; on clustered tables the sweep's own, the plane rows (64
// bytes each) and the cluster and group boxes (32 bytes each), which it
// reads once per (ray, triangle) or (ray, box) test.  The material,
// vertex-normal and emitter tables are read once per hit and stay in
// global memory.
inline size_t smem_table_bytes(const TraceParams& P) {
  if (!P.cluster_k)
    return static_cast<size_t>(table_floats(P.n_tri, P.has_vn, P.n_emissive, P.etab_stride)) * 4;
  return (static_cast<size_t>(P.n_tri) * kPlaneStride +
          static_cast<size_t>(P.n_clusters + P.n_groups) * 8) * 4;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Sets P.use_smem for a kernel that needs `other` bytes of shared memory
// besides the tables, and returns the table bytes it then adds (0: the
// block reads the tables through L1).  Dense: every table, where the total
// fits in 48 KB.  Clustered: the sweep's tables, copied by TMA, where the
// total fits in a block's 227 KB and the sources are 16-byte aligned (torch
// allocations are); a larger scene (above ~3,500 triangles) reads its
// planes through L1, the same function at a lower speed.  BVH: none.
inline size_t smem_tables(TraceParams& P, size_t other) {
  if (P.n_nodes) {
    P.use_smem = 0;
    return 0;
  }
  const size_t bytes = smem_table_bytes(P);
  if (P.cluster_k) {
    P.use_smem = other + bytes <= static_cast<size_t>(kMaxSmem) && aligned16(P.planes) &&
                 aligned16(P.cab) && aligned16(P.gab);
  } else {
    P.use_smem = other + bytes <= static_cast<size_t>(kSmemLimit);
  }
  return P.use_smem ? bytes : 0;
}

// Opts a kernel into more than 48 KB of dynamic shared memory when needed.
template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kSmemLimit)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One TMA bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to shared memory, completing on mbarrier `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The scene tables a block reads, staged at `s` when P.use_smem (the block
// is then synchronised); otherwise the global copies, read through L1.
// Every thread of the block must call it.  Dense: every table, copied by
// the block's threads.  Clustered: the plane rows and the cluster and group
// boxes, by one thread's TMA bulk copies on an mbarrier that every thread
// waits on.  BVH: the global copies.
template <int kSweep>
__device__ __forceinline__ Tables stage_tables(const TraceParams& P, float* s) {
  Tables T{P.planes, P.table, P.vtab, P.etab, P.cdf, P.cab, P.gab, P.nodes, P.tri_index};
  if (kSweep == kSweepBvh || !P.use_smem) return T;
  if constexpr (kSweep == kSweepClustered) {
    __shared__ alignas(8) uint64_t bar_storage;
    const uint32_t bar = smem_u32(&bar_storage);
    float* planes = s;
    float* cab = planes + static_cast<size_t>(P.n_tri) * kPlaneStride;
    float* gab = cab + static_cast<size_t>(P.n_clusters) * 8;
    const uint32_t b_planes = static_cast<uint32_t>(P.n_tri) * kPlaneStride * 4;
    const uint32_t b_cab = static_cast<uint32_t>(P.n_clusters) * 32;
    const uint32_t b_gab = static_cast<uint32_t>(P.n_groups) * 32;
    if (threadIdx.x == 0) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1u) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   ::"r"(bar), "r"(b_planes + b_cab + b_gab)
                   : "memory");
      bulk_load(planes, P.planes, b_planes, bar);
      if (b_cab) bulk_load(cab, P.cab, b_cab, bar);
      if (b_gab) bulk_load(gab, P.gab, b_gab, bar);
    }
    __syncthreads();  // the barrier is initialised before anyone waits on it
    uint32_t done = 0;
    do {
      asm volatile(
          "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          "selp.b32 %0, 1, 0, p;\n}"
          : "=r"(done)
          : "r"(bar), "r"(0u)
          : "memory");
    } while (!done);
    T.planes = planes;
    T.cab = cab;
    T.gab = gab;
  } else if constexpr (kSweep == kSweepDense) {
    auto stage = [&](const float* src, int count) {
      for (int k = threadIdx.x; k < count; k += blockDim.x) s[k] = src[k];
      const float* out = s;
      s += (count + 3) & ~3;  // keep 16-byte alignment for the next array
      return out;
    };
    T.planes = stage(P.planes, P.n_tri * kPlaneStride);
    T.table = stage(P.table, P.n_tri * kTableStride);
    if (P.has_vn) T.vtab = stage(P.vtab, P.n_tri * kVtabStride);
    T.etab = stage(P.etab, P.n_emissive * P.etab_stride);
    T.cdf = stage(P.cdf, P.n_emissive);
    __syncthreads();
  }
  return T;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
__device__ __forceinline__ V3 zero3() { return V3{0.f, 0.f, 0.f}; }
__device__ __forceinline__ V3 ld3(const float* a) { return V3{a[0], a[1], a[2]}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
__device__ __forceinline__ float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
__device__ __forceinline__ V3 normalize3(V3 v) {
  float n = sqrtf(dot3(v, v));
  float s = n > 0.f ? n : 1.f;
  return v3(v.x / s, v.y / s, v.z / s);
}

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float unit_from_bits(uint32_t bits) {
  return __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
}

struct Hit {
  float t;  // +inf on miss
  int idx;  // 0 on miss
};

// Relative margins of the divide-free pre-test of sweep(): wide against
// the 2^-24 rounding of one product or quotient (see sweep()).
constexpr float kPretestLo = 0.999f;
constexpr float kPretestHi = 1.001f;

// Sweeps triangles [lo, hi) for the ray o + t*dir, updating the closest
// hit (t_best, best); strict `<` keeps the lowest index on exact ties.
//
// Most pairs are rejected, so a divide-free pre-test keeps the exact IEEE
// divide t = a0 / -b0 off their path.  With s = |b0| and a = a0 signed so
// that t = a / s, a pair goes on to the exact test only where s >= min_dot,
// a >= (eps * kPretestLo) * s and a <= (t_best * s) * kPretestHi.  This
// never drops a pair the exact test accepts: accepted, fl(a / s) >= eps and
// fl(a / s) < t_best give a >= eps * s / (1 + u) and a < t_best * s (u =
// 2^-24), and each product above rounds once, at most by a factor 1 +- u
// while it stays normal, which the margins 1 -+ 1e-3 cover many times over.
// The products stay normal because eps and min_dot are positive and eps *
// min_dot >= 1e-30 (every product is at least that, t_best being an
// accepted t >= eps): the kernels' wrappers refuse other values
// (render_kernel.py _trace_params), since a run-time switch around the
// pre-test took back most of its gain.  Survivors then take the exact test,
// so the result is bit for bit that of the exact test alone.  Tested by a
// float32 mirror in tests/test_torch_cluster.py.
__device__ __forceinline__ void sweep(const float* __restrict__ planes, int lo, int hi,
                                      float min_dot, float eps, V3 o, V3 dir, float& t_best,
                                      int& best) {
  const float eps_lo = eps * kPretestLo;
  for (int k = lo; k < hi; ++k) {
    const float4* q = reinterpret_cast<const float4*>(planes + kPlaneStride * k);
    const float4 f = q[0];
    const float b0 = dir.x * f.x + dir.y * f.y + dir.z * f.z;
    const float a0 = o.x * f.x + o.y * f.y + o.z * f.z + f.w;
    const float s = fabsf(b0);
    const float a = b0 < 0.f ? a0 : -a0;
    if (!(s >= min_dot && a >= eps_lo * s && a <= (t_best * s) * kPretestHi)) continue;
    const float t = a0 / (-b0);
    if (fabsf(b0) >= min_dot && t >= eps && t < t_best) {
      bool inside = true;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float4 e = q[j];
        const float a = o.x * e.x + o.y * e.y + o.z * e.z + e.w;
        const float b = dir.x * e.x + dir.y * e.y + dir.z * e.z;
        inside = inside && (a + t * b <= 0.f);
      }
      if (inside) {
        t_best = t;
        best = k;
      }
    }
  }
}

// The slab test's reciprocal direction: components below 1e-20 in
// magnitude become +-1e-20 (the JAX package's _inv_dir, render_kernel.py
// :377), so the interval stays finite and conservative.
__device__ __forceinline__ float inv_component(float c) {
  const float tiny = c < 0.f ? -1e-20f : 1e-20f;
  return 1.f / (fabsf(c) < 1e-20f ? tiny : c);
}

// True where the ray's [0, inf) enters the box [lo xyz, hi xyz] at or
// before t_best (the JAX package's _slab_rows, render_kernel.py:384).  A
// box row is 8 floats, 32-byte aligned: two 16-byte loads.
__device__ __forceinline__ bool enters(const float* __restrict__ box, V3 o, V3 inv,
                                       float t_best) {
  const float4 a = reinterpret_cast<const float4*>(box)[0];  // lo xyz, hi x
  const float4 b = reinterpret_cast<const float4*>(box)[1];  // hi yz
  const float tx1 = (a.x - o.x) * inv.x, tx2 = (a.w - o.x) * inv.x;
  const float ty1 = (a.y - o.y) * inv.y, ty2 = (b.x - o.y) * inv.y;
  const float tz1 = (a.z - o.z) * inv.z, tz2 = (b.y - o.z) * inv.z;
  const float t_min = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float t_max = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return t_max >= fmaxf(t_min, 0.f) && t_min <= t_best;
}

// The slab test of enters() on a box row held in (a, b), also giving the
// distance at which the ray enters the box.
__device__ __forceinline__ bool slab(float4 a, float4 b, V3 o, V3 inv, float t_best,
                                     float& t_min) {
  const float tx1 = (a.x - o.x) * inv.x, tx2 = (a.w - o.x) * inv.x;
  const float ty1 = (a.y - o.y) * inv.y, ty2 = (b.x - o.y) * inv.y;
  const float tz1 = (a.z - o.z) * inv.z, tz2 = (b.y - o.z) * inv.z;
  t_min = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
  const float t_max = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  return t_max >= fmaxf(t_min, 0.f) && t_min <= t_best;
}

// sweep() over a BVH leaf's rows [lo, hi) with the global tie rule: a hit
// replaces the running one (t_best, best, best_g) where it is closer or, at
// an equal t, has a lower global index tri_index[k].  The same arithmetic
// and pre-test as sweep(), whose `<=` margin keeps the equal-t pairs.
__device__ __forceinline__ void leaf_sweep(const float* __restrict__ planes,
                                           const int32_t* __restrict__ tri_index, int lo, int hi,
                                           float min_dot, float eps, V3 o, V3 dir, float& t_best,
                                           int& best, int& best_g) {
  const float eps_lo = eps * kPretestLo;
  for (int k = lo; k < hi; ++k) {
    const float4* q = reinterpret_cast<const float4*>(planes + kPlaneStride * k);
    const float4 f = q[0];
    const float b0 = dir.x * f.x + dir.y * f.y + dir.z * f.z;
    const float a0 = o.x * f.x + o.y * f.y + o.z * f.z + f.w;
    const float s = fabsf(b0);
    const float a = b0 < 0.f ? a0 : -a0;
    if (!(s >= min_dot && a >= eps_lo * s && a <= (t_best * s) * kPretestHi)) continue;
    const float t = a0 / (-b0);
    if (fabsf(b0) >= min_dot && t >= eps && t <= t_best) {
      bool inside = true;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float4 e = q[j];
        const float a = o.x * e.x + o.y * e.y + o.z * e.z + e.w;
        const float b = dir.x * e.x + dir.y * e.y + dir.z * e.z;
        inside = inside && (a + t * b <= 0.f);
      }
      if (inside) {
        const int g = tri_index[k];
        if (t < t_best || g < best_g) {
          t_best = t;
          best = k;
          best_g = g;
        }
      }
    }
  }
}

// The BVH traversal (header comment) of the ray o + t*dir.  With kCount,
// counts[0..3) gain the nodes popped, the (ray, box) tests and the (ray,
// triangle) tests.
template <bool kCount>
__device__ __forceinline__ Hit traverse(const TraceParams& P, const Tables& T, V3 o, V3 dir,
                                        int* counts) {
  const V3 inv = v3(inv_component(dir.x), inv_component(dir.y), inv_component(dir.z));
  float t_best = INFINITY;
  int best = 0, best_g = INT_MAX;
  int stack[kMaxStack];
  int sp = 1;
  stack[0] = 0;  // the root
  while (sp > 0) {
    const int node = stack[--sp];
    const float4* row = reinterpret_cast<const float4*>(T.nodes + 8 * node);
    const float4 b = row[1];
    float t_in;
    if constexpr (kCount) counts[0] += 1, counts[1] += 1;
    if (!slab(row[0], b, o, inv, t_best, t_in)) continue;
    const int link = __float_as_int(b.z), count = __float_as_int(b.w);
    if (count > 0) {
      if constexpr (kCount) counts[2] += count;
      leaf_sweep(T.planes, T.tri_index, link, link + count, P.min_dot, P.epsilon, o, dir, t_best,
                 best, best_g);
      continue;
    }
    const int left = node + 1, right = node + link;
    const float4* lr = reinterpret_cast<const float4*>(T.nodes + 8 * left);
    const float4* rr = reinterpret_cast<const float4*>(T.nodes + 8 * right);
    float t_l, t_r;
    const bool h_l = slab(lr[0], lr[1], o, inv, t_best, t_l);
    const bool h_r = slab(rr[0], rr[1], o, inv, t_best, t_r);
    if constexpr (kCount) counts[1] += 2;
    const bool near_left = t_l <= t_r;
    const bool h_near = near_left ? h_l : h_r, h_far = near_left ? h_r : h_l;
    if (sp + static_cast<int>(h_near) + static_cast<int>(h_far) > kMaxStack) __trap();
    if (h_far) stack[sp++] = near_left ? right : left;
    if (h_near) stack[sp++] = near_left ? left : right;
  }
  return Hit{t_best, best};
}

// intersect() of the dense and clustered flavours.
template <bool kClustered>
__device__ __forceinline__ Hit sweep_hit(const TraceParams& P, const Tables& T, V3 o, V3 dir) {
  float t_best = INFINITY;
  int best = 0;
  if constexpr (!kClustered) {
    sweep(T.planes, 0, P.n_tri, P.min_dot, P.epsilon, o, dir, t_best, best);
  } else {
    const V3 inv = v3(inv_component(dir.x), inv_component(dir.y), inv_component(dir.z));
    sweep(T.planes, 0, min(P.cluster_k, P.n_tri), P.min_dot, P.epsilon, o, dir, t_best, best);
    for (int g = 0; g < P.n_groups; ++g) {
      if (!enters(T.gab + 8 * g, o, inv, t_best)) continue;
      const int c_lo = 1 + g * P.cluster_group;
      const int c_hi = min(c_lo + P.cluster_group, P.n_clusters);
      for (int c = c_lo; c < c_hi; ++c) {
        if (!enters(T.cab + 8 * c, o, inv, t_best)) continue;
        const int lo = c * P.cluster_k;
        sweep(T.planes, lo, min(lo + P.cluster_k, P.n_tri), P.min_dot, P.epsilon, o, dir, t_best,
              best);
      }
    }
  }
  return Hit{t_best, best};
}

// Closest hit of the ray o + t*dir: the dense sweep over all triangles,
// B10's clustered sweep (header comment) on clustered tables, or the BVH
// traversal.  kSweep is a template parameter, not a branch on the tables,
// so that each kernel compiles without the other flavours' registers (with
// the clustered loop, the dense B1 spilled under its 80-register
// allocation and ran 5% slower).
template <int kSweep>
__device__ __forceinline__ Hit intersect(const TraceParams& P, const Tables& T, V3 o, V3 dir) {
  if constexpr (kSweep == kSweepBvh) {
    return traverse<false>(P, T, o, dir, nullptr);
  } else {
    return sweep_hit<kSweep == kSweepClustered>(P, T, o, dir);
  }
}

__device__ __forceinline__ bool is_hit(Hit h) { return h.t != INFINITY; }

__device__ __forceinline__ V3 hit_point(V3 o, V3 dir, Hit h) {
  return o + dir * (is_hit(h) ? h.t : 0.f);
}

// Minimal rotation taking +z to n, applied to v; R = -I when n.z == -1.
__device__ __forceinline__ V3 rotate_z_to(V3 n, V3 v) {
  float w = 1.f + n.z, x = -n.y, y = n.x;
  const float qn2 = w * w + x * x + y * y;
  const bool degenerate = qn2 <= 1e-12f;
  const float qn = sqrtf(degenerate ? 1.f : qn2);
  w = w / qn;
  x = x / qn;
  y = y / qn;
  if (degenerate) return v3(-v.x, -v.y, -v.z);
  return v3((1.f - 2.f * y * y) * v.x + (2.f * x * y) * v.y + (2.f * y * w) * v.z,
            (2.f * x * y) * v.x + (1.f - 2.f * x * x) * v.y + (-2.f * x * w) * v.z,
            (-2.f * y * w) * v.x + (2.f * x * w) * v.y + (1.f - 2.f * (x * x + y * y)) * v.z);
}

// Barycentric shading normal (Triangle::getNormal); v9/n9 are the packed
// corners and corner normals.
__device__ __forceinline__ V3 smooth_at(V3 point, const float* v9, const float* n9,
                                        float area) {
  const float a_safe = area > 0.f ? area : 1.f;
  V3 acc = zero3();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const V3 c = cross3(ld3(v9 + 3 * ((i + 1) % 3)) - point, ld3(v9 + 3 * ((i + 2) % 3)) - point);
    const float w = 0.5f * sqrtf(dot3(c, c)) / a_safe;
    acc = acc + w * ld3(n9 + 3 * i);
  }
  return normalize3(acc);
}

// Phong lobe (n+2)/(2 pi) max(refl.w, 0)^n.
__device__ __forceinline__ float spec_coeff(float inv_2pi, float shin, V3 n, V3 w, V3 wi) {
  const float dn = 2.f * dot3(n, wi);
  const V3 refl = v3(-wi.x + dn * n.x, -wi.y + dn * n.y, -wi.z + dn * n.z);
  const float base = dot3(refl, w);
  const float powed = shin == 0.f ? 1.f : (base > 0.f ? powf(fmaxf(base, 0.f), shin) : 0.f);
  return (shin + 2.f) * inv_2pi * powed;
}

// Record sinks of bounce_step.  put() receives bounce b's record fields.
struct NoRecords {
  __device__ __forceinline__ void put(int, V3, V3, V3, V3, float, int, bool, bool) {}
};

// Writes records to global memory in the (max_bounces * kRecRows, n) layout.
struct GlobalRecords {
  float* rec;
  int n, i;
  __device__ __forceinline__ void row(int b, int r, float v) const {
    rec[static_cast<size_t>(b * kRecRows + r) * n + i] = v;
  }
  __device__ __forceinline__ void put(int b, V3 f, V3 c, V3 nee, V3 pm, float coeff, int tri,
                                      bool hit, bool esc) const {
    const float v[kRecRows] = {f.x,  f.y,  f.z,  c.x,   c.y,                     c.z,
                               nee.x, nee.y, nee.z, pm.x, pm.y,                    pm.z,
                               coeff, static_cast<float>(tri), hit ? 1.f : 0.f, esc ? 1.f : 0.f};
#pragma unroll
    for (int r = 0; r < kRecRows; ++r) row(b, r, v[r]);
  }
  // Zeroes the slots of the bounces the ray never reached.
  __device__ __forceinline__ void zero_from(int b0, int max_bounces) const {
    for (int b = b0; b < max_bounces; ++b) {
#pragma unroll
      for (int r = 0; r < kRecRows; ++r) row(b, r, 0.f);
    }
  }
};

// The state of one lane of the bounce loop (the carry's rows).
struct Lane {
  V3 dir, point, l_e, l_d, pm, rad;
  float segs, shadows;
  int idx;     // the pending ray's hit triangle (0 on a miss)
  bool hit;    // the pending ray hit
  bool alive;
};

__device__ __forceinline__ V3 ld_rows3(const float* a, int n, int row, int i) {
  return v3(a[static_cast<size_t>(row) * n + i], a[static_cast<size_t>(row + 1) * n + i],
            a[static_cast<size_t>(row + 2) * n + i]);
}

__device__ __forceinline__ void st_rows3(float* a, int n, int row, int i, V3 v) {
  a[static_cast<size_t>(row) * n + i] = v.x;
  a[static_cast<size_t>(row + 1) * n + i] = v.y;
  a[static_cast<size_t>(row + 2) * n + i] = v.z;
}

__device__ __forceinline__ Lane load_lane(const float* carry, int n, int i) {
  Lane L;
  L.dir = ld_rows3(carry, n, 0, i);
  L.point = ld_rows3(carry, n, 3, i);
  L.hit = carry[static_cast<size_t>(6) * n + i] > 0.f;
  L.idx = static_cast<int>(carry[static_cast<size_t>(7) * n + i]);
  L.l_e = ld_rows3(carry, n, 8, i);
  L.l_d = ld_rows3(carry, n, 11, i);
  L.pm = ld_rows3(carry, n, 14, i);
  L.alive = carry[static_cast<size_t>(17) * n + i] > 0.f;
  L.rad = ld_rows3(carry, n, 18, i);
  L.segs = carry[static_cast<size_t>(21) * n + i];
  L.shadows = carry[static_cast<size_t>(22) * n + i];
  return L;
}

__device__ __forceinline__ void store_lane(float* carry, int n, int i, const Lane& L) {
  st_rows3(carry, n, 0, i, L.dir);
  st_rows3(carry, n, 3, i, L.point);
  carry[static_cast<size_t>(6) * n + i] = L.hit ? 1.f : 0.f;
  carry[static_cast<size_t>(7) * n + i] = static_cast<float>(L.idx);
  st_rows3(carry, n, 8, i, L.l_e);
  st_rows3(carry, n, 11, i, L.l_d);
  st_rows3(carry, n, 14, i, L.pm);
  carry[static_cast<size_t>(17) * n + i] = L.alive ? 1.f : 0.f;
  st_rows3(carry, n, 18, i, L.rad);
  carry[static_cast<size_t>(21) * n + i] = L.segs;
  carry[static_cast<size_t>(22) * n + i] = L.shadows;
  carry[static_cast<size_t>(23) * n + i] = 0.f;
}

// a / b for a >= 0, b > 0, in 32-bit arithmetic where a fits (a 64-bit
// divide is a long emulated sequence).
__device__ __forceinline__ long long div_nonneg(long long a, int b) {
  if (a < (1LL << 32)) return static_cast<uint32_t>(a) / static_cast<uint32_t>(b);
  return a / b;
}

// g / spp: the pixel of global sample g, row-major.
__device__ __forceinline__ long long pixel_of(const TraceParams& P, long long g) {
  return div_nonneg(g, P.spp);
}

// The primary ray of global sample g (camera mode), the plain version's
// ops/camera.py camera_rays operation for operation: pixel row r and column
// c (r = g / (spp W) = (g / spp) / W), the jitter of slots 6 and 7 of
// bounce 0 under the camera key words, x = 2(c + u1)/W - 1, y = 1 - 2(r +
// u2)/H, normalize(x, y, 1), the camera matrix, normalize; the origin is 0.
// The hash takes g's low 32 bits, as rng.hash_orig does.
__device__ __forceinline__ V3 camera_ray(const TraceParams& P, long long g) {
  const long long q = pixel_of(P, g);
  const long long r = div_nonneg(q, P.width);
  const long long c = q - r * P.width;
  const uint32_t h = fmix32(static_cast<uint32_t>(g) ^ P.ck0);
  const float u1 = unit_from_bits(fmix32((h + 6u * kGolden) ^ P.ck1));
  const float u2 = unit_from_bits(fmix32((h + 7u * kGolden) ^ P.ck1));
  const float x = 2.f * (static_cast<float>(c) + u1) / static_cast<float>(P.width) - 1.f;
  const float y = 1.f - 2.f * (static_cast<float>(r) + u2) / static_cast<float>(P.height);
  const V3 d = normalize3(v3(x, y, 1.f));
  const float* m = P.cam;
  return normalize3(v3(d.x * m[0] + d.y * m[1] + d.z * m[2],
                       d.x * m[3] + d.y * m[4] + d.z * m[5],
                       d.x * m[6] + d.y * m[7] + d.z * m[8]));
}

// The direction of ray i's primary ray: read, or made in camera mode.
__device__ __forceinline__ V3 primary_dir(const TraceParams& P, int i) {
  if (P.camera) return camera_ray(P, P.base + i);
  return v3(P.d[i], P.d[P.n + i], P.d[2 * P.n + i]);
}

// Whether ray i of the launch is a sample of the render.
__device__ __forceinline__ bool lane_alive(const TraceParams& P, int i) {
  return P.camera ? P.base + i < P.n_samples : P.alive[i] > 0.f;
}

// Ray i's lane before its primary sweep: a miss at point 0.
__device__ __forceinline__ Lane fresh_lane(const TraceParams& P, int i) {
  Lane L;
  L.dir = primary_dir(P, i);
  L.rad = L.l_e = L.l_d = L.point = zero3();
  L.pm = v3(1.f, 1.f, 1.f);
  L.segs = L.shadows = 0.f;
  L.alive = lane_alive(P, i);
  L.hit = false;
  L.idx = 0;
  return L;
}

__device__ __forceinline__ V3 ray_origin(const TraceParams& P, int i) {
  return P.camera ? zero3() : v3(P.p[i], P.p[P.n + i], P.p[2 * P.n + i]);
}

// The pending ray's closest hit, from origin o along L.dir.
template <int kSweep>
__device__ __forceinline__ void sweep_from(const TraceParams& P, const Tables& T, Lane& L, V3 o) {
  const Hit h = intersect<kSweep>(P, T, o, L.dir);
  L.hit = is_hit(h);
  L.idx = h.idx;
  L.point = hit_point(o, L.dir, h);
}

// The initial lane of ray i: the bounce-0 intersection of a live ray (a
// dead lane keeps a miss at point 0).
template <int kSweep>
__device__ __forceinline__ Lane init_lane(const TraceParams& P, const Tables& T, int i) {
  Lane L = fresh_lane(P, i);
  if (L.alive) sweep_from<kSweep>(P, T, L, ray_origin(P, i));
  return L;
}

// The per-sample half of the fused RNG's hash.
__device__ __forceinline__ uint32_t hash_orig(const TraceParams& P, int i) {
  if (!P.fused) return 0u;
  const uint32_t g = P.camera ? static_cast<uint32_t>(P.base + i) : static_cast<uint32_t>(P.orig[i]);
  return fmix32(g ^ P.k0);
}

// Slots 0-5 of the uniforms of global bounce b_global: the fused hash of
// (sample, b_global, slot), or row b_local*8 + slot of P.uniforms.
__device__ __forceinline__ void draw6(const TraceParams& P, int i, uint32_t h_orig, int b_global,
                                      int b_local, float u[6]) {
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    if (P.fused) {
      const uint32_t ctr = static_cast<uint32_t>(b_global * 8 + s);
      u[s] = unit_from_bits(fmix32((h_orig + ctr * kGolden) ^ P.k1));
    } else {
      u[s] = P.uniforms[static_cast<size_t>(b_local * 8 + s) * P.n + i];
    }
  }
}

// One bounce of a live lane at global bounce b (B1's bounce, JAX
// _make_bounce, render_kernel.py:602), its record handed to sink slot
// `slot`.  The lane dies on escape (f = 0, nee = 0, c = the stale l_e +
// l_d with quirks, else 0) and where roulette ends the path (f = 0, coeff
// = 0); a dead lane keeps the rest of its state.  Returns L.alive.
// kDefer leaves the next ray's sweep to the caller: a lane that goes on
// keeps its hit point in L.point as the next ray's origin, and the caller
// runs sweep_from(L, L.point), the same arithmetic, only where it needs the
// hit (the regenerating kernels sweep every lane of a warp together).
template <int kSweep, bool kDefer = false, class Sink>
__device__ __forceinline__ bool bounce_step(const TraceParams& P, const Tables& T, Lane& L, int b,
                                            const float u[6], Sink& sink, int slot) {
  L.segs += 1.f;
  if (!L.hit) {
    // Escape.  Q2: the loop body still adds the stale L_d (and L_e).
    V3 c = zero3();
    if (P.quirks) {
      c = L.l_e + L.l_d;
      L.rad = L.rad + L.pm * c;
    }
    sink.put(slot, zero3(), c, zero3(), L.pm, 0.f, 0, false, true);
    L.alive = false;
    return false;
  }
  const int idx = L.idx;
  const V3 point = L.point, dir = L.dir, pm = L.pm;
  const float* row = T.table + kTableStride * idx;
  const V3 emission = ld3(row);
  const V3 spec = ld3(row + 3);
  const float shin = row[6];
  const V3 face_n = ld3(row + 7);
  const V3 kd = ld3(row + 10);
  const V3 shade_n = P.has_vn
      ? smooth_at(point, T.vtab + kVtabStride * idx, T.vtab + kVtabStride * idx + 9,
                  T.vtab[kVtabStride * idx + 18])
      : face_n;
  // Q1: first-hit emission is kept and re-added every bounce.
  if (b == 0) {
    L.l_e = emission;
  } else if (!P.quirks) {
    L.l_e = zero3();
  }

  // Russian roulette and the next direction, about the FACE normal.
  const bool cont = u[3] < P.p_rr;
  const float phi = P.two_pi * u[4];
  bool is_spec = false;
  float cos_t;
  if (P.no_spec) {
    cos_t = sqrtf(u[5]);
  } else {
    is_spec = (spec.x != 0.f || spec.y != 0.f || spec.z != 0.f) && shin != 0.f;
    cos_t = powf(u[5], is_spec ? 1.f / (shin + 1.f) : 0.5f);
  }
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
  const V3 next_dir = normalize3(rotate_z_to(face_n, v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t)));
  const float cosine = dot3(next_dir, shade_n);

  // Next-event estimation; the shadow ray and the next ray share `point`.
  // l_d = bsdf_direct * nee, and d l_d / d kd = nee (no 1/pi: the
  // reference's direct BSDF is kd + spec * phong).
  V3 nee = zero3();
  V3 l_d_fresh = zero3();
  [[maybe_unused]] Hit nxt;  // unused under kDefer
  if (P.n_emissive > 0) {
    L.shadows += 1.f;
    int e = P.n_emissive - 1;  // u past cdf[-1] clamps to the last emitter
    for (int k = 0; k < P.n_emissive; ++k) {
      if (T.cdf[k] >= u[0]) {
        e = k;
        break;
      }
    }
    const float* er = T.etab + P.etab_stride * e;
    const float sq = sqrtf(u[1]);
    const float r2 = u[2];
    const V3 v0 = ld3(er), v1 = ld3(er + 3), v2 = ld3(er + 6);
    const V3 emm = v3((1.f - sq) * v0.x + sq * (1.f - r2) * v1.x + r2 * sq * v2.x,
                      (1.f - sq) * v0.y + sq * (1.f - r2) * v1.y + r2 * sq * v2.y,
                      (1.f - sq) * v0.z + sq * (1.f - r2) * v1.z + r2 * sq * v2.z);
    const V3 to_light = normalize3(emm - point);
    const float cos_theta = dot3(shade_n, to_light);
    const Hit sh = intersect<kSweep>(P, T, point, to_light);
    if constexpr (!kDefer) nxt = intersect<kSweep>(P, T, point, next_dir);
    bool ok = cos_theta >= 0.f && is_hit(sh);
    const V3 light_n = P.has_vn
        ? smooth_at(hit_point(point, to_light, sh), er, er + 17, er[26])
        : ld3(er + 12);
    const float cos_theta_p = -dot3(light_n, to_light);
    ok = ok && cos_theta_p >= 0.f && static_cast<float>(sh.idx) == er[15];
    if (ok) {
      const float geo = cos_theta * cos_theta_p / (sh.t * sh.t) / er[16];
      V3 bsdf_direct = kd;
      if (!P.no_spec) bsdf_direct = kd + spec * spec_coeff(P.inv_2pi, shin, shade_n, dir, to_light);
      nee = ld3(er + 9) * geo;
      l_d_fresh = bsdf_direct * nee;
    }
  } else if constexpr (!kDefer) {
    nxt = intersect<kSweep>(P, T, point, next_dir);
  }
  L.l_d = l_d_fresh;
  const V3 c = L.l_e + L.l_d;
  L.rad = L.rad + pm * c;

  if (!cont) {
    sink.put(slot, zero3(), c, nee, pm, 0.f, idx, true, false);
    L.alive = false;
    return false;
  }
  V3 bsdf;
  float coeff;
  if (P.no_spec) {
    bsdf = kd * P.inv_pi;
    coeff = cosine * P.cos_scale;  // cosine / pdf(=1/pi) / p_RR
  } else {
    const float pdf = is_spec ? powf((shin + 1.f) * cos_t, shin) : P.inv_pi;
    bsdf = kd * P.inv_pi + spec * spec_coeff(P.inv_2pi, shin, shade_n, dir, next_dir);
    coeff = pdf > 0.f ? cosine / pdf * P.inv_p_rr : 0.f;
  }
  const V3 f = bsdf * coeff;
  sink.put(slot, f, c, nee, pm, coeff, idx, true, false);
  L.pm = pm * f;
  L.dir = next_dir;
  if constexpr (!kDefer) {
    L.hit = is_hit(nxt);
    L.idx = nxt.idx;
    L.point = hit_point(point, next_dir, nxt);
  }
  return true;
}

// --- The regenerating schedule (B1, B2, B3) ------------------------------
//
// Persistent blocks, as many as fit on the card (capacity below).  Warp w of
// the grid owns the contiguous rays [w * per, (w + 1) * per) of the launch,
// per = ceil(n / warps), cut at n, and hands them out in order to the lanes
// that ask, lowest lane first (take_ray).  The loop is warp-uniform, one
// round per bounce: a lane whose path ends takes the next ray of its warp's
// range at once, so a warp does not idle its lanes until its longest path
// under roulette ends.  Which rays a lane traces, and when, depends only on
// (n, the grid, the rays' path lengths); no counter is shared between
// warps, so B2's sums are the same in every run on one card.
// tests/test_torch_regen.py mirrors it for the CPU tests.

constexpr unsigned kAllLanes = 0xffffffffu;

struct WarpRays {
  int next, end;  // the warp's unstarted rays [next, end)
};

__device__ __forceinline__ WarpRays warp_rays(int n) {
  const long long warps = static_cast<long long>(gridDim.x) * kWarps;
  const long long per = (n + warps - 1) / warps;
  const long long lo = (static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) * per;
  return WarpRays{static_cast<int>(lo < n ? lo : n), static_cast<int>(lo + per < n ? lo + per : n)};
}

// --- Fixed chunk ranges (B7, B9) -------------------------------------------
//
// Persistent blocks of `warps_per_block` warps, as many as fit on the card.
// Warp w of the grid owns the contiguous chunks of 32 neighbouring lanes
// [w * C / W, (w + 1) * C / W) (C = ceil(n / 32) chunks, W warps in all;
// the range is cut at n) and walks them in order, so its loads and stores
// coalesce.  No counter is shared between warps: which lanes a warp runs,
// and in what order, depends only on (n, the grid).
// tests/test_torch_regen.py mirrors it.
struct LaneRange {
  long long lo, hi;  // the warp's lanes [lo, hi), lo a multiple of 32
};

__device__ __forceinline__ LaneRange warp_chunks(int n, int warps_per_block) {
  const long long chunks = (n + 31) / 32;
  const long long warps = static_cast<long long>(gridDim.x) * warps_per_block;
  const long long w = static_cast<long long>(blockIdx.x) * warps_per_block + (threadIdx.x >> 5);
  return LaneRange{w * chunks / warps * 32,
                   min((w + 1) * chunks / warps * 32, static_cast<long long>(n))};
}

// Every lane of the warp calls it.  A lane that asks gets the next ray of
// the warp's range (lanes in order), or -1 once the range is used up.
__device__ __forceinline__ int take_ray(WarpRays& w, bool ask) {
  const unsigned asks = __ballot_sync(kAllLanes, ask);
  const int lane = threadIdx.x & 31;
  const int i = w.next + __popc(asks & ((1u << lane) - 1u));
  w.next = min(w.next + __popc(asks), w.end);
  return ask && i < w.end ? i : -1;
}

// Sums v[0..N) over the lanes of `lanes` that pass `valid` with the same
// `key`; every lane of `lanes` calls it.  Returns true on one lane per key,
// the lowest, which then holds the sums in v and the lane count in *count.
// The loop is E. Westphal's warp-aggregated atomics ("Voting and shuffling
// to optimize atomic operations", 2015): each round a lane adds the values
// of the next remaining lane of its key, and every other remaining lane of
// a key drops out, so a key held by k lanes takes ceil(log2 k) rounds.  The
// sums are a fixed tree over the key's lanes in lane order, so they depend
// only on (lanes, keys, values).  B5 and B6 pass the converged lanes
// (__activemask()), B2, B4 and B9 all 32 (render_bwd.cu warp_add).
template <int N, class F>
__device__ __forceinline__ bool warp_sum_by_key(unsigned lanes, bool valid, int key, F (&v)[N],
                                                int* count) {
  const unsigned want = __ballot_sync(lanes, valid);
  if (!valid) return false;
  const unsigned peers = __match_any_sync(want, key);
  const int lane = threadIdx.x & 31;
  *count = __popc(peers);
  int rel = __popc(peers & ((1u << lane) - 1u));
  unsigned rest = peers & ~((2u << lane) - 1u);  // the key's lanes above this one
  while (__any_sync(want, rest != 0u)) {
    const int next = __ffs(rest) - 1;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const F t = __shfl_sync(want, v[k], next < 0 ? lane : next);
      if (next >= 0) v[k] += t;
    }
    rest &= __ballot_sync(want, (rel & 1) == 0);
    rel >>= 1;
  }
  return lane == __ffs(peers) - 1;
}

// Per kernel instance and device, the dynamic shared memory the kernel was
// last opted into and the blocks that then fit on the card at once; the
// attribute and the occupancy query are redone only when a scene changes
// the size.
struct Capacity {
  size_t smem;
  int blocks;
};
constexpr int kMaxDevices = 64;

// Opts `kernel` into `smem` bytes on the current device and returns in
// *blocks how many of its blocks of `threads` fit on the card at once;
// `cache` holds one entry per device.
template <class K>
cudaError_t capacity(K kernel, Capacity* cache, size_t smem, int* blocks,
                     int threads = kThreads) {
  if (smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  Capacity& c = cache[dev];
  if (c.smem != smem || c.blocks == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    c = Capacity{smem, per_sm * sms};
  }
  *blocks = c.blocks;
  return cudaSuccess;
}

}  // namespace ipt
