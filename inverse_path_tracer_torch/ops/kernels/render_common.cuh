// Device code shared by render_fwd.cu (B1, B3, B7, B8, B10),
// render_bwd.cu (B2, B4, B9) and inverse.cu (B5, B6): the vector helpers,
// the counter-hash RNG, the closest-hit sweep with its clustered form
// (B10), the shading helpers, the lane state of a path (PathLane, Lane), a
// sweep step (sweep_lanes), a path-vertex step (vertex_lanes) with B1's
// bounce (bounce_lanes), and the persistent schedules: regenerating lanes
// (warp_rays: B1, B2, B3) and fixed chunk ranges (warp_chunks: B7, B9).
//
// The regenerating loops of B1, B2 and B3 (warp_rays below) and the stage
// kernel run the same steps, templated on a record sink, so that B1 (no
// records), B3 and B8 (records to global memory) and B2 (records in a
// per-thread ring) run one copy of the arithmetic (inverse.cu's loops too,
// with their own weights).  Every file that includes this header is built
// with -fmad=false (build.py), so B2's replay takes exactly the branches of
// B1's forward, a staged render equals a mega one lane for lane, and all of
// them round exactly as the plain PyTorch versions do.
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
// cluster_hit() sweeps cluster 0 (the largest triangles) for every ray;
// then, 32 groups at a time, each lane tests the groups' boxes against its
// ray's closest hit at the start of the 32, and the warp shares out the
// rest, one item a lane: the (ray, group) items that entered, whose taker
// tests the group's cluster boxes against the same t (t_cull) and queues
// the (ray, cluster) items that entered in the warp's queue in shared
// memory, and the queued items, whose taker sweeps the cluster's rows for
// the owner ray (its origin, direction and closest hit read with
// shuffles).  A lane thus works on its neighbours' rays instead of idling
// while they sweep clusters it does not enter, the cost of a per-lane loop
// on incoherent rays.  Where a warp's rays are coherent and meet nearer
// clusters first, a per-lane loop culls more (B7 on the sphere); culling
// against the owner's running hit, or handing each ray's groups out one a
// pass with the queue swept between, measured no faster or slower on the
// cells' rays (PERF.md §6, PR 20).  A box skipped is a per-ray skip where
// the TPU kernel skips a cluster for a whole ray block.  An owner keeps the least (t, internal index) over its
// items (a 64-bit atomicMin in shared memory), so the result is the dense
// sweep's, ties to the lowest internal index, in whatever order the items
// run: a box test is inclusive against a closest hit that is never below
// the final one.  A last cluster of fewer than cluster_k rows is swept by
// each ray itself, where it enters its box: queued, its items would take
// whole passes of cluster_k rows.  The lanes that call together share the
// work (__activemask()).  The kernels call it from every lane of a
// converged warp, a lane without a ray with `active` false, so that it
// takes its neighbours' items (intersect_lanes: the next and the shadow
// rays of B1, B2, B3 and B8, B7's rays, B10 alone, and both sweeps of B5's
// and B6's segments).  The plane rows and the boxes are copied into shared
// memory by TMA where they fit (stage_tables).
// Bound: the (ray, triangle) tests swept and the (ray, box) tests, f32 ALU
// as the dense sweep; a box test is 6 mul, 6 sub and 10 min/max.
//
// The BVH traversal (the BVH route, RenderConfig.intersect="bvh" on a scene
// with a BVH; no Pallas counterpart: the JAX package's route is XLA code,
// its ops/bvh.py intersect_bvh).  The tables are in the tree's leaf order
// (ops/kernels/clusters.py kernel_view), so a leaf's triangles are the
// contiguous plane rows [start, start + n_prims).  P.nodes (ops/bvh.py
// node_rows) holds one 64-byte row per inner node: both children's boxes,
// padded as the cluster boxes are, and a reference to each, as int bits an
// inner child's row or, with the sign bit set, a leaf's first plane row
// << kLeafBits | its triangle count; row 0 holds the root's box and
// reference.  traverse() tests the root's box, then visits a node with one
// row of four 16-byte loads: it tests both children's boxes against the
// closest hit so far, goes on to the nearer one the ray enters and pushes
// the farther with the distance at which the ray enters it on a
// per-thread stack of kMaxStack entries (local memory), and at a leaf
// tests its triangles with the sweep's arithmetic.  A pop culls where
// that distance lies past the closest hit, which is the whole of a second
// test of the box (its other half cannot change).  The nodes are ops/bvh.py
// intersect_bvh's, visited in its order, ray by ray; the lanes of a warp
// take their inner nodes, and then their leaves, in passes together
// (traverse's comment).  A node is culled only where the ray enters its
// box strictly after the closest hit, and a hit replaces the running one
// when it is closer or, at an equal t, has a lower global triangle index
// (P.tri_index), so the result is the dense sweep's in global order, bit
// for bit.  The host refuses a tree deeper than the stack (ops/bvh.py
// check_bvh), so the stack cannot overflow; the kernel traps if it would.
// The node table stays in global memory, read through L1.  Bound: the
// (ray, box) tests and the (ray, triangle) tests of this run's rays, f32
// ALU as B10's.

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
constexpr int kLeafBits = 5;   // a leaf reference's count bits (ops/bvh.py LEAF_BITS)

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
  const float* nodes;         // (n_nodes, 16)
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
// The clustered sweep's static shared memory in a block of `warps` warps:
// a warp's SweepScratch (kSweepScratchBytes, below) and stage_tables' TMA
// barrier, 16 bytes with its alignment.
constexpr size_t kSweepScratchBytes = 1408;
constexpr size_t cluster_static_smem(int warps) { return warps * kSweepScratchBytes + 16; }

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
// total with the sweep's static shared memory (blocks of `warps` warps)
// fits in a block's 227 KB and the sources are 16-byte aligned (torch
// allocations are); a larger scene (above ~3,300 triangles at 8 warps,
// ~3,150 at 16) reads its planes through L1, the same function at a lower
// speed.  BVH: none.
inline size_t smem_tables(TraceParams& P, size_t other, int warps = kWarps) {
  if (P.n_nodes) {
    P.use_smem = 0;
    return 0;
  }
  const size_t bytes = smem_table_bytes(P);
  if (P.cluster_k) {
    P.use_smem = other + bytes + cluster_static_smem(warps) <= static_cast<size_t>(kMaxSmem) &&
                 aligned16(P.planes) && aligned16(P.cab) && aligned16(P.gab);
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
// kTies (the clustered sweep's items, which run in no fixed order) also
// takes a hit at t_best itself where its index is below best.
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
// float32 mirror in tests/test_torch_cluster.py.  The pre-test's `<=`
// margin keeps the equal-t pairs that kTies may take.
template <bool kTies = false>
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
    if (fabsf(b0) >= min_dot && t >= eps && (kTies ? t <= t_best : t < t_best)) {
      bool inside = true;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float4 e = q[j];
        const float a = o.x * e.x + o.y * e.y + o.z * e.z + e.w;
        const float b = dir.x * e.x + dir.y * e.y + dir.z * e.z;
        inside = inside && (a + t * b <= 0.f);
      }
      if (inside && (!kTies || t < t_best || k < best)) {
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
// replaces the running one (t_best, best) where it is closer or, at an
// equal t, has a lower global index tri_index[k] than tri_index[best].
// The same arithmetic and pre-test as sweep(), whose `<=` margin keeps the
// equal-t pairs.
__device__ __forceinline__ void leaf_sweep(const float* __restrict__ planes,
                                           const int32_t* __restrict__ tri_index, int lo, int hi,
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
    if (fabsf(b0) >= min_dot && t >= eps && t <= t_best) {
      bool inside = true;
#pragma unroll
      for (int j = 1; j < 4; ++j) {
        const float4 e = q[j];
        const float a = o.x * e.x + o.y * e.y + o.z * e.z + e.w;
        const float b = dir.x * e.x + dir.y * e.y + dir.z * e.z;
        inside = inside && (a + t * b <= 0.f);
      }
      if (inside && (t < t_best || tri_index[k] < tri_index[best])) {
        t_best = t;
        best = k;
      }
    }
  }
}

// The BVH traversal (header comment) of the ray o + t*dir.  With kCount,
// counts[0..4) gain the nodes visited, the (ray, box) tests, the (ray,
// triangle) tests and the visits culled by their stored entry distance.
// The lanes go through the tree in passes that they take together, each
// ended by a vote of the lanes that reach it (__activemask(), a set that
// holds the voter, so that no lane leaves a loop that it still has work
// in): passes over inner nodes until no lane is at one, then one pass in
// which each lane at a leaf tests its triangles and pops.  A lane's own
// order of visits is the one-node-at-a-time order, so its hits and counts
// are too.  Without the votes a lane that runs a pass ahead splits the
// warp for the rest of the traversal (B1's BVH instance then ran 1.2-1.5x
// slower than a loop of one node a pass, PERF.md §6); waiting at inner
// nodes for the other lanes lets the warp test its leaves together.  An
// inner node whose children the ray misses, and a culled pop, leave kPop,
// which the leaf pass takes as a leaf of no triangles.
template <bool kCount>
__device__ __forceinline__ Hit traverse(const TraceParams& P, const Tables& T, V3 o, V3 dir,
                                        int* counts) {
  constexpr int kPop = INT_MIN;  // a leaf reference of 0 triangles
  const V3 inv = v3(inv_component(dir.x), inv_component(dir.y), inv_component(dir.z));
  float t_best = INFINITY;
  int best = 0;
  const float4* rows = reinterpret_cast<const float4*>(T.nodes);
  const float4 root = rows[1];
  float t_in;
  if constexpr (kCount) counts[0] += 1, counts[1] += 1;
  bool going = slab(rows[0], root, o, inv, t_best, t_in);
  int ref = __float_as_int(root.z);
  float2 stack[kMaxStack];  // (reference bits, entry distance) of the farther children
  int sp = 0;
  while (__any_sync(__activemask(), going)) {
    while (__any_sync(__activemask(), going && ref >= 0)) {
      if (!(going && ref >= 0)) continue;
      const float4* row = rows + 4 * ref;  // an inner node: both children in its row
      const float4 l1 = row[1], r1 = row[3];
      float t_l, t_r;
      const bool h_l = slab(row[0], l1, o, inv, t_best, t_l);
      const bool h_r = slab(row[2], r1, o, inv, t_best, t_r);
      if constexpr (kCount) counts[0] += h_l + h_r, counts[1] += 2;
      const bool near_left = t_l <= t_r;
      if (h_l && h_r) {  // the farther child waits on the stack
        if (sp == kMaxStack) __trap();
        stack[sp++] = make_float2(near_left ? l1.w : l1.z, fmaxf(t_l, t_r));
      }
      ref = !(h_l || h_r) ? kPop : __float_as_int((h_l && h_r ? near_left : h_l) ? l1.z : l1.w);
    }
    if (!going) continue;
    const int lo = (ref & INT_MAX) >> kLeafBits, count = ref & ((1 << kLeafBits) - 1);
    if constexpr (kCount) counts[2] += count;
    leaf_sweep(T.planes, T.tri_index, lo, lo + count, P.min_dot, P.epsilon, o, dir, t_best, best);
    ref = kPop;
    if (sp == 0) {
      going = false;
    } else {  // the farther child last pushed, unless the ray enters it past t_best
      const float2 e = stack[--sp];
      if (e.y <= t_best) ref = __float_as_int(e.x);
      else if constexpr (kCount) counts[3] += 1;
    }
  }
  return Hit{t_best, best};
}

// --- B10's warp-cooperative schedule (header comment) ------------------

// The position of the k-th (from 0) set bit of m, which has more than k.
__device__ __forceinline__ int nth_bit(unsigned m, int k) {
  int pos = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc(m & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      m >>= w;
      pos += w;
    }
  }
  return pos;
}

// m without its k lowest set bits.
__device__ __forceinline__ unsigned drop_bits(unsigned m, int k) {
  if (k <= 0) return m;
  if (k >= __popc(m)) return 0u;
  return m & ~((1u << nth_bit(m, k)) - 1u);
}

__device__ __forceinline__ V3 shfl3(unsigned lanes, V3 v, int src) {
  return v3(__shfl_sync(lanes, v.x, src), __shfl_sync(lanes, v.y, src),
            __shfl_sync(lanes, v.z, src));
}

// Each lane of `lanes` holds `count` (< 64) items, laid out in lane order:
// this lane's exclusive prefix (the items of the lanes below it), from one
// ballot per bit of the counts, so that it holds for any set of lanes.
__device__ __forceinline__ int items_before(unsigned lanes, unsigned below, int count) {
  int pre = 0;
#pragma unroll
  for (int b = 0; b < 6; ++b) pre += __popc(__ballot_sync(lanes, (count >> b) & 1) & below) << b;
  return pre;
}

// The holder lane of item s of that layout (`pre` this lane's prefix) and,
// in *r, the item's rank among the holder's; `want` false (the lane takes
// no item): this lane, 0.  Every lane of `lanes` calls it; s < 32.
__device__ __forceinline__ int item_holder(unsigned lanes, int count, int pre, bool want, int s,
                                           int* r) {
  const unsigned starts = __reduce_or_sync(lanes, count > 0 && pre < 32 ? 1u << pre : 0u);
  const unsigned holders = __ballot_sync(lanes, count > 0);
  *r = 0;
  if (!want) return threadIdx.x & 31;
  const unsigned upto = starts & ((2u << s) - 1u);  // the holders starting at or before s
  *r = s - (31 - __clz(upto));
  return nth_bit(holders, __popc(upto) - 1);
}

// A warp's shared scratch of the sweep, a part for each lane: its running
// closest hit as one word, (t bits, index) (every t a sweep accepts is at
// least eps > 0 and +inf is a miss, so the words order as (t, index) do),
// and its segment of the queue of (ray, cluster) items, (cluster << 5) |
// the ray's lane.  Item j of the queue of a call's lanes lies in the
// segment of the lane of rank j % width, at depth j / width, so that lanes
// of one warp in two calls at once (lane-divergent callers) use disjoint
// parts.  A round of group boxes queues at most kMaxClusterGroup items a
// lane onto fewer than `width`, so a segment holds kSegment.
constexpr int kMaxClusterGroup = 8;
constexpr int kSegment = kMaxClusterGroup + 1;
struct SweepScratch {
  unsigned long long box[32];
  uint32_t queue[32 * kSegment];
};
static_assert(sizeof(SweepScratch) == kSweepScratchBytes, "cluster_static_smem counts the scratch");

// The scratch of the warps of a block of kBlockWarps warps.
template <int kBlockWarps>
__device__ __forceinline__ SweepScratch* sweep_scratch() {
  __shared__ SweepScratch scratch[kBlockWarps];
  return scratch;
}

__device__ __forceinline__ unsigned long long hit_word(float t, int idx) {
  return (static_cast<unsigned long long>(__float_as_uint(t)) << 32) | static_cast<uint32_t>(idx);
}

// The work of the clustered sweep, per lane (intersect_kernel's counts):
// (ray, group) box tests, (ray, cluster) box tests, (ray, triangle) pairs,
// and the lane-slots of the pair loop's passes, 32 a row of a pass (masked
// lanes included), counted on the pass's lowest lane.
struct SweepWork {
  int group_tests, cluster_tests, pairs, slots;
};

// B10 (header comment): the closest hit of the ray o + t*dir on clustered
// tables, swept by the lanes of the warp that call it together
// (__activemask(); every warp intrinsic below takes that mask), in a block
// of kBlockWarps warps.  A lane that calls it with `active` false has no ray
// (its Hit is a miss) and takes its neighbours' items.  Per round of 32
// groups: while the queue holds fewer items than there are lanes and
// (ray, group) items are left, each lane takes one, in lane order, and
// queues the clusters of the group whose boxes the owner ray enters no
// later than t_cull; else each lane takes a queued (ray, cluster) item and
// sweeps its rows.  With kCount, *work gains the lane's SweepWork.
template <bool kCount, int kBlockWarps = kWarps>
__device__ __forceinline__ Hit cluster_hit(const TraceParams& P, const Tables& T, V3 o, V3 dir,
                                           bool active, SweepWork* work) {
  const unsigned lanes = __activemask();
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const int rank = __popc(lanes & below), width = __popc(lanes);
  SweepScratch& S = sweep_scratch<kBlockWarps>()[threadIdx.x >> 5];
  const V3 inv = v3(inv_component(dir.x), inv_component(dir.y), inv_component(dir.z));
  const int ck = P.cluster_k;
  float t_best = INFINITY;
  int best = 0;
  const int rows0 = min(ck, P.n_tri);
  if (active) sweep(T.planes, 0, rows0, P.min_dot, P.epsilon, o, dir, t_best, best);
  if constexpr (kCount) {
    if (active) work->pairs += rows0;
    if (rank == 0) work->slots += 32 * rows0;
  }
  // The last cluster, swept by each ray itself where it has fewer rows.
  const int last = P.n_clusters - 1;
  const int tail_rows = P.n_tri - last * ck;
  const int tail_group = tail_rows < ck && last > 0 ? (last - 1) / P.cluster_group : -1;
  for (int g0 = 0; g0 < P.n_groups; g0 += 32) {
    const float t_cull = t_best;
    const int gn = min(32, P.n_groups - g0);
    unsigned gm = 0;  // groups g0 + j whose box the ray enters, not yet handed out
    for (int j = 0; active && j < gn; ++j) {
      if (enters(T.gab + 8 * (g0 + j), o, inv, t_cull)) gm |= 1u << j;
    }
    if constexpr (kCount) work->group_tests += active ? gn : 0;
    const bool tail = tail_group >= g0 && tail_group < g0 + gn && ((gm >> (tail_group - g0)) & 1u);
    int queued = 0;  // the warp's queued items
    for (;;) {
      const int g_items = __reduce_add_sync(lanes, __popc(gm));
      if (queued >= width || (g_items == 0 && queued > 0)) {
        // Each lane takes a queued (ray, cluster) item, the top `width`
        // (all but at the end: one a lane), and sweeps the cluster's rows.
        const int base = max(queued - width, 0);
        const int depth = base / width + (rank < base % width);
        const bool has = rank < queued;
        const uint32_t item = has ? S.queue[lane * kSegment + depth] : 0u;
        const int owner = has ? static_cast<int>(item & 31u) : lane;
        const V3 so = shfl3(lanes, o, owner), sd = shfl3(lanes, dir, owner);
        float t = __shfl_sync(lanes, t_best, owner);
        int idx = __shfl_sync(lanes, best, owner);
        S.box[lane] = hit_word(t_best, best);
        __syncwarp(lanes);
        if (has) {
          const int lo = static_cast<int>(item >> 5) * ck;
          const int before = idx;
          sweep<true>(T.planes, lo, lo + ck, P.min_dot, P.epsilon, so, sd, t, idx);
          if (idx != before) atomicMin(S.box + owner, hit_word(t, idx));
        }
        if constexpr (kCount) {
          if (has) work->pairs += ck;
          if (rank == 0) work->slots += 32 * ck;
        }
        __syncwarp(lanes);
        const unsigned long long w = S.box[lane];
        t_best = __uint_as_float(static_cast<uint32_t>(w >> 32));
        best = static_cast<int>(static_cast<uint32_t>(w));
        queued = max(queued - width, 0);
      } else if (g_items > 0) {
        // Each lane takes a (ray, group) item: the group's cluster boxes.
        const int count = __popc(gm);
        const int pre = items_before(lanes, below, count);
        const bool take = rank < g_items;
        int r;
        const int src = item_holder(lanes, count, pre, take, rank, &r);
        const unsigned src_gm = __shfl_sync(lanes, gm, src);
        const V3 so = shfl3(lanes, o, src), si = shfl3(lanes, inv, src);
        const float st = __shfl_sync(lanes, t_cull, src);
        unsigned m = 0;  // bit j: cluster c_lo + j
        int c_lo = 0;
        if (take) {
          const int g = g0 + nth_bit(src_gm, r);
          c_lo = 1 + g * P.cluster_group;
          const int c_hi = min(c_lo + P.cluster_group, g == tail_group ? last : P.n_clusters);
          for (int c = c_lo; c < c_hi; ++c) {
            if (enters(T.cab + 8 * c, so, si, st)) m |= 1u << (c - c_lo);
          }
          if constexpr (kCount) work->cluster_tests += c_hi - c_lo;
        }
        const int n_m = __popc(m);
        const int at = queued + items_before(lanes, below, n_m);
        int depth = at / width, r_to = at - depth * width;
        for (; m != 0u; m &= m - 1u) {
          S.queue[nth_bit(lanes, r_to) * kSegment + depth] =
              (static_cast<uint32_t>(c_lo + __ffs(m) - 1) << 5) | src;
          if (++r_to == width) r_to = 0, ++depth;
        }
        queued += __reduce_add_sync(lanes, n_m);
        gm = drop_bits(gm, width - pre);  // the items handed out
        __syncwarp(lanes);
      } else {
        break;
      }
    }
    if (tail_group >= g0 && tail_group < g0 + gn) {
      const bool in = tail && enters(T.cab + 8 * last, o, inv, t_cull);
      if (in) sweep<true>(T.planes, last * ck, P.n_tri, P.min_dot, P.epsilon, o, dir, t_best, best);
      if constexpr (kCount) {
        work->cluster_tests += tail;
        if (in) work->pairs += tail_rows;
        if (__any_sync(lanes, in) && rank == 0) work->slots += 32 * tail_rows;
      }
    }
  }
  return Hit{t_best, best};
}

// Closest hit of the ray o + t*dir of the lanes where `active`, called by
// every lane of a converged warp of a block of kBlockWarps warps (a miss
// elsewhere): the dense sweep over all triangles, B10's clustered sweep
// (header comment) on clustered tables, whose lanes with nothing to sweep
// take part of the others' work, or the BVH traversal.  kSweep is a
// template parameter, not a branch on the tables, so that each kernel
// compiles without the other flavours' registers (with the clustered loop,
// the dense B1 spilled under its 80-register allocation and ran 5% slower).
template <int kSweep, int kBlockWarps = kWarps>
__device__ __forceinline__ Hit intersect_lanes(const TraceParams& P, const Tables& T, V3 o, V3 dir,
                                               bool active) {
  if constexpr (kSweep == kSweepClustered) {
    return cluster_hit<false, kBlockWarps>(P, T, o, dir, active, nullptr);
  } else {
    float t_best = INFINITY;
    int best = 0;
    if (active) {
      if constexpr (kSweep == kSweepBvh) return traverse<false>(P, T, o, dir, nullptr);
      else sweep(T.planes, 0, P.n_tri, P.min_dot, P.epsilon, o, dir, t_best, best);
    }
    return Hit{t_best, best};
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

// Record sinks of bounce_begin and bounce_end.  put() receives bounce b's
// record fields.
struct NoRecords {
  __device__ __forceinline__ void put(int, V3, V3, V3, V3, float, int, bool, bool) {}
};

// Lane i's column of per-bounce records of kRows rows in global memory,
// (max_bounces * kRows, n): rows() stores bounce b's, zero_from() zeroes
// the slots of the bounces the ray never reached.
template <int kRows>
struct RecordRows {
  float* rec;
  int n, i;
  __device__ __forceinline__ void row(int b, int r, float v) const {
    rec[static_cast<size_t>(b * kRows + r) * n + i] = v;
  }
  __device__ __forceinline__ void rows(int b, const float (&v)[kRows]) const {
#pragma unroll
    for (int r = 0; r < kRows; ++r) row(b, r, v[r]);
  }
  __device__ __forceinline__ void zero_from(int b0, int max_bounces) const {
    for (int b = b0; b < max_bounces; ++b) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) row(b, r, 0.f);
    }
  }
};

// Writes records to global memory in the (max_bounces * kRecRows, n) layout.
struct GlobalRecords : RecordRows<kRecRows> {
  __device__ __forceinline__ void put(int b, V3 f, V3 c, V3 nee, V3 pm, float coeff, int tri,
                                      bool hit, bool esc) const {
    rows(b, {f.x, f.y, f.z, c.x, c.y, c.z, nee.x, nee.y, nee.z, pm.x, pm.y, pm.z, coeff,
             static_cast<float>(tri), hit ? 1.f : 0.f, esc ? 1.f : 0.f});
  }
};

// What every path loop keeps of a lane.
struct PathLane {
  V3 point;  // the pending ray's origin, then its hit point
  float segs, shadows;
  int idx;   // the pending ray's hit triangle (0 on a miss)
  bool hit;  // the pending ray hit
};

// The state of one lane of the forward's bounce loop (the carry's rows).
struct Lane : PathLane {
  V3 dir, l_e, l_d, pm, rad;
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

// The pending ray's closest hit, from origin o along dir, of the lanes
// where `active`; every lane of the warp calls it together
// (intersect_lanes).
template <int kSweep>
__device__ __forceinline__ void sweep_lanes(const TraceParams& P, const Tables& T, PathLane& L,
                                            V3 o, V3 dir, bool active) {
  const Hit h = intersect_lanes<kSweep>(P, T, o, dir, active);
  if (active) {
    L.hit = is_hit(h);
    L.idx = h.idx;
    L.point = hit_point(o, dir, h);
  }
}

// The per-sample half of the fused RNG's hash.
__device__ __forceinline__ uint32_t hash_orig(const TraceParams& P, int i) {
  if (!P.fused) return 0u;
  const uint32_t g = P.camera ? static_cast<uint32_t>(P.base + i) : static_cast<uint32_t>(P.orig[i]);
  return fmix32(g ^ P.k0);
}

// Slots first..first+5 of the uniforms of global bounce b_global: the
// fused hash of (sample, b_global, slot), or row b_local*8 + slot of
// P.uniforms: [light pick, r1, r2, roulette, phi, theta] from 0 in the
// forward, from 1 in the extraction (whose slot 0 is never read).
__device__ __forceinline__ void draw6(const TraceParams& P, int i, uint32_t h_orig, int b_global,
                                      int b_local, float u[6], int first = 0) {
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    if (P.fused) {
      const uint32_t ctr = static_cast<uint32_t>(b_global * 8 + first + s);
      u[s] = unit_from_bits(fmix32((h_orig + ctr * kGolden) ^ P.k1));
    } else {
      u[s] = P.uniforms[static_cast<size_t>(b_local * 8 + first + s) * P.n + i];
    }
  }
}

// The shading normal of triangle idx at `point`: the barycentric one on
// vertex-normal tables, the face normal face_n otherwise.
__device__ __forceinline__ V3 shading_normal(const TraceParams& P, const Tables& T, int idx,
                                             V3 point, V3 face_n) {
  return P.has_vn ? smooth_at(point, T.vtab + kVtabStride * idx, T.vtab + kVtabStride * idx + 9,
                              T.vtab[kVtabStride * idx + 18])
                  : face_n;
}

// The unit direction at azimuth phi and polar cosine cos_t about the face
// normal n.
__device__ __forceinline__ V3 dir_about(V3 n, float phi, float cos_t) {
  const float sin_t = sqrtf(fmaxf(1.f - cos_t * cos_t, 0.f));
  return normalize3(rotate_z_to(n, v3(sin_t * cosf(phi), sin_t * sinf(phi), cos_t)));
}

// NEE's shadow ray, as a vertex carries it across the ray's sweep.
struct ShadowRay {
  V3 to_light;
  float cos_theta;  // of to_light against the shading normal
  int e;            // the emitter
  bool shadow;      // a shadow ray from the vertex along to_light is to be swept
};

// NEE's light sample from `point` where the scene has emitters (returns
// s.shadow): the emitter picked on the CDF by u[0], the point (sqrt(u[1]),
// u[2]) on it, the direction to it and its cosine against shade_n.
__device__ __forceinline__ bool sample_light(const TraceParams& P, const Tables& T, V3 point,
                                             V3 shade_n, const float u[3], ShadowRay& s) {
  s.shadow = P.n_emissive > 0;
  if (!s.shadow) return false;
  int e = P.n_emissive - 1;  // u past cdf[-1] clamps to the last emitter
  for (int k = 0; k < P.n_emissive; ++k) {
    if (T.cdf[k] >= u[0]) {
      e = k;
      break;
    }
  }
  s.e = e;
  const float* er = T.etab + P.etab_stride * e;
  const float sq = sqrtf(u[1]);
  const float r2 = u[2];
  const V3 v0 = ld3(er), v1 = ld3(er + 3), v2 = ld3(er + 6);
  const V3 emm = v3((1.f - sq) * v0.x + sq * (1.f - r2) * v1.x + r2 * sq * v2.x,
                    (1.f - sq) * v0.y + sq * (1.f - r2) * v1.y + r2 * sq * v2.y,
                    (1.f - sq) * v0.z + sq * (1.f - r2) * v1.z + r2 * sq * v2.z);
  s.to_light = normalize3(emm - point);
  s.cos_theta = dot3(shade_n, s.to_light);
  return true;
}

// Whether the shadow ray s from `point`, of closest hit sh, reached its
// emitter (row er): the light in front, a hit, the light's normal there
// (smooth or flat) facing back (*cos_theta_p >= 0), the sampled emitter.
__device__ __forceinline__ bool light_reached(const TraceParams& P, const float* er, V3 point,
                                              const ShadowRay& s, Hit sh, float* cos_theta_p) {
  const bool ok = s.cos_theta >= 0.f && is_hit(sh);
  const V3 light_n = P.has_vn
      ? smooth_at(hit_point(point, s.to_light, sh), er, er + 17, er[26])
      : ld3(er + 12);
  *cos_theta_p = -dot3(light_n, s.to_light);
  return ok && *cos_theta_p >= 0.f && sh.idx == static_cast<int>(er[15]);
}

// A path vertex of the lanes where `live`: begin(s), false where the path
// ends there, then end(s, the hit of its shadow ray from `point`, swept
// where s.shadow); every lane of the warp calls it.  On clustered tables
// the shadow rays are swept together (intersect_lanes); elsewhere each lane
// runs alone, which keeps the dense and BVH B1 in 80 registers (PERF.md
// §6).  Returns end's answer where `live`, else false.
template <int kSweep, class S, class Begin, class End>
__device__ __forceinline__ bool vertex_lanes(const TraceParams& P, const Tables& T, const V3& point,
                                             bool live, Begin begin, End end) {
  S s{};
  if constexpr (kSweep != kSweepClustered) {  // the lanes need not meet
    if (!live || !begin(s)) return false;
    return end(s, intersect_lanes<kSweep>(P, T, point, s.to_light, s.shadow));
  } else {
    const bool lit = live && begin(s);
    __syncwarp();
    const Hit sh = intersect_lanes<kSweep>(P, T, point, s.to_light, lit && s.shadow);
    return lit && end(s, sh);
  }
}

// One bounce of a live lane at global bounce b (B1's bounce, JAX
// _make_bounce, render_kernel.py:602), its record handed to sink slot
// `slot`, in two parts on either side of the shadow ray's sweep
// (bounce_lanes runs them).  The lane dies on escape (f = 0, nee = 0, c =
// the stale l_e + l_d with quirks, else 0) and where roulette ends the path
// (f = 0, coeff = 0); a dead lane keeps the rest of its state.  A lane that
// goes on keeps its hit point in L.point as the next ray's origin, and the
// caller sweeps the next ray (sweep_lanes) where it needs the hit.  What a
// bounce carries across the shadow ray's sweep:
struct Bounce : ShadowRay {
  V3 shade_n, next_dir;
  float cos_t, cosine;
  bool cont, is_spec;
};

// The part of the bounce before the shadow ray's sweep: the escape, which
// ends the lane (returns false), or the shading, the roulette draw, the next
// direction and the shadow ray, into s (returns true).
template <class Sink>
__device__ __forceinline__ bool bounce_begin(const TraceParams& P, const Tables& T, Lane& L,
                                             int b, const float u[6], Sink& sink, int slot,
                                             Bounce& s) {
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
  const V3 point = L.point;
  const float* row = T.table + kTableStride * idx;
  const V3 emission = ld3(row);
  const V3 spec = ld3(row + 3);
  const float shin = row[6];
  const V3 face_n = ld3(row + 7);
  s.shade_n = shading_normal(P, T, idx, point, face_n);
  // Q1: first-hit emission is kept and re-added every bounce.
  if (b == 0) {
    L.l_e = emission;
  } else if (!P.quirks) {
    L.l_e = zero3();
  }

  // Russian roulette and the next direction, about the FACE normal.
  s.cont = u[3] < P.p_rr;
  const float phi = P.two_pi * u[4];
  s.is_spec = false;
  if (P.no_spec) {
    s.cos_t = sqrtf(u[5]);
  } else {
    s.is_spec = (spec.x != 0.f || spec.y != 0.f || spec.z != 0.f) && shin != 0.f;
    s.cos_t = powf(u[5], s.is_spec ? 1.f / (shin + 1.f) : 0.5f);
  }
  s.next_dir = dir_about(face_n, phi, s.cos_t);
  s.cosine = dot3(s.next_dir, s.shade_n);

  // Next-event estimation; the shadow ray and the next ray share `point`.
  if (sample_light(P, T, point, s.shade_n, u, s)) L.shadows += 1.f;
  return true;
}

// The rest of the bounce, given the shadow ray's hit sh (read where
// s.shadow).  Returns L.alive.
template <class Sink>
__device__ __forceinline__ bool bounce_end(const TraceParams& P, const Tables& T, Lane& L,
                                           Sink& sink, int slot, const Bounce& s, Hit sh) {
  // The material, read again rather than carried across the sweep.
  const float* row = T.table + kTableStride * L.idx;
  const V3 spec = ld3(row + 3);
  const float shin = row[6];
  const V3 kd = ld3(row + 10);
  // l_d = bsdf_direct * nee, and d l_d / d kd = nee (no 1/pi: the
  // reference's direct BSDF is kd + spec * phong).
  V3 nee = zero3();
  V3 l_d_fresh = zero3();
  if (s.shadow) {
    const float* er = T.etab + P.etab_stride * s.e;
    float cos_theta_p;
    if (light_reached(P, er, L.point, s, sh, &cos_theta_p)) {
      const float geo = s.cos_theta * cos_theta_p / (sh.t * sh.t) / er[16];
      V3 bsdf_direct = kd;
      if (!P.no_spec)
        bsdf_direct = kd + spec * spec_coeff(P.inv_2pi, shin, s.shade_n, L.dir, s.to_light);
      nee = ld3(er + 9) * geo;
      l_d_fresh = bsdf_direct * nee;
    }
  }
  L.l_d = l_d_fresh;
  const V3 pm = L.pm;
  const V3 c = L.l_e + L.l_d;
  L.rad = L.rad + pm * c;

  if (!s.cont) {
    sink.put(slot, zero3(), c, nee, pm, 0.f, L.idx, true, false);
    L.alive = false;
    return false;
  }
  V3 bsdf;
  float coeff;
  if (P.no_spec) {
    bsdf = kd * P.inv_pi;
    coeff = s.cosine * P.cos_scale;  // cosine / pdf(=1/pi) / p_RR
  } else {
    const float pdf = s.is_spec ? powf((shin + 1.f) * s.cos_t, shin) : P.inv_pi;
    bsdf = kd * P.inv_pi + spec * spec_coeff(P.inv_2pi, shin, s.shade_n, L.dir, s.next_dir);
    coeff = pdf > 0.f ? s.cosine / pdf * P.inv_p_rr : 0.f;
  }
  const V3 f = bsdf * coeff;
  sink.put(slot, f, c, nee, pm, coeff, L.idx, true, false);
  L.pm = pm * f;
  L.dir = s.next_dir;
  return true;
}

// The bounce of the lanes where `live` (u read there); every lane of the
// warp calls it together (vertex_lanes).  Returns L.alive where `live`,
// else false.  b and slot are captured by value: by reference, B3's
// clustered instance took one register more (PERF.md §6).
template <int kSweep, class Sink>
__device__ __forceinline__ bool bounce_lanes(const TraceParams& P, const Tables& T, Lane& L,
                                             bool live, int b, const float u[6], Sink& sink,
                                             int slot) {
  return vertex_lanes<kSweep, Bounce>(
      P, T, L.point, live,
      [&, b, slot](Bounce& s) { return bounce_begin(P, T, L, b, u, sink, slot, s); },
      [&, slot](const Bounce& s, Hit sh) { return bounce_end(P, T, L, sink, slot, s, sh); });
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
