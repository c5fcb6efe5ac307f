// Forward path-tracing megakernel for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel render_tile_pallas /
// _kernel_fwd (inverse_path_tracer_tpu/ops/pallas/render_kernel.py:1440,
// :883; bounce body _make_bounce :602).  It computes the same function:
// for each ray, up to max_bounces bounces of closest-hit intersection,
// first-hit emission, next-event estimation with an area-CDF light pick,
// sqrt-barycentric point sample and shadow ray, Russian roulette, cosine or
// Phong direction sampling, the reference quirks Q1/Q2 (or the quirk-free
// estimator), and barycentric smooth shading on vertex-normal scenes.
//
// Design.  One thread per ray, the bounce loop in registers, exit as soon
// as the ray dies (the TPU kernel pays every bounce slot of a masked
// block).  The closest hit is a brute-force sweep over all triangles with
// a strict `<`, so ties keep the lowest triangle index; the per-triangle
// plane rows (16 floats: face plane, 3 edge planes), the per-triangle
// material table and the emitter table are staged in shared memory when
// they fit in 48 KB and otherwise read through the L1 cache from global
// memory, so any triangle count is correct.  Every thread of a warp reads
// the same plane row at the same time, which is a shared-memory broadcast.
// t is an exact IEEE divide.  The file is compiled with -fmad=false so that
// every sum rounds exactly as in the plain PyTorch version
// (render_kernel.py render_tile_plain), which lets the two agree bit for
// bit on geometry.
//
// Bound.  Per live (ray, bounce) the kernel sweeps nT triangles twice (the
// shadow ray and the next ray share the hit point as origin) at ~30 f32
// operations each plus a divide: the work is f32 ALU, far above the 52
// bytes per ray that it reads and writes.  Warp divergence from rays dying
// at different bounces is the main loss, left to later tuning (persistent
// threads with ray compaction, a BVH for large scenes).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kPlaneStride = 16;  // n, -c.n, out0, d0, out1, d1, out2, d2
constexpr int kTableStride = 16;  // emission 0:3 spec 3:6 shin 6 face_n 7:10 kd 10:13
constexpr int kVtabStride = 20;   // verts 0:9 vertex normals 9:18 area 18
// Emitter rows: verts 0:9 emission 9:12 face_n 12:15 tri 15 p 16
// (+ vertex normals 17:26, area 26 on vertex-normal scenes).
constexpr int kThreads = 256;
constexpr int kSmemLimit = 48 * 1024;
constexpr uint32_t kGolden = 0x9E3779B9u;

struct Params {
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
  float* rad;             // out (3, n)
  float* stats;           // out (2, n): segments, shadow rays
  uint32_t k0, k1;
  int n, n_tri, n_emissive, etab_stride;
  int has_vn, no_spec, quirks, fused, max_bounces, use_smem;
  float p_rr, min_dot, epsilon;
  float two_pi, inv_pi, inv_2pi, cos_scale, inv_p_rr;
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return V3{x, y, z}; }
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

// Closest hit of the ray o + t*dir over all triangles; strict `<` keeps the
// lowest index on exact ties.
__device__ __forceinline__ Hit intersect(const float* __restrict__ planes, int n_tri,
                                         float min_dot, float eps, V3 o, V3 dir) {
  float t_best = INFINITY;
  int best = 0;
  for (int k = 0; k < n_tri; ++k) {
    const float4* q = reinterpret_cast<const float4*>(planes + kPlaneStride * k);
    const float4 f = q[0];
    const float b0 = dir.x * f.x + dir.y * f.y + dir.z * f.z;
    const float a0 = o.x * f.x + o.y * f.y + o.z * f.z + f.w;
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
  return Hit{t_best, best};
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
  V3 acc = v3(0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const V3 c = cross3(ld3(v9 + 3 * ((i + 1) % 3)) - point, ld3(v9 + 3 * ((i + 2) % 3)) - point);
    const float w = 0.5f * sqrtf(dot3(c, c)) / a_safe;
    acc = acc + w * ld3(n9 + 3 * i);
  }
  return normalize3(acc);
}

// Phong lobe (n+2)/(2 pi) max(refl.w, 0)^n.
__device__ __forceinline__ float spec_coeff(const Params& P, float shin, V3 n, V3 w, V3 wi) {
  const float dn = 2.f * dot3(n, wi);
  const V3 refl = v3(-wi.x + dn * n.x, -wi.y + dn * n.y, -wi.z + dn * n.z);
  const float base = dot3(refl, w);
  const float powed = shin == 0.f ? 1.f : (base > 0.f ? powf(fmaxf(base, 0.f), shin) : 0.f);
  return (shin + 2.f) * P.inv_2pi * powed;
}

__global__ void __launch_bounds__(kThreads) render_fwd_kernel(const Params P) {
  extern __shared__ float4 smem4[];
  const float* planes = P.planes;
  const float* table = P.table;
  const float* vtab = P.vtab;
  const float* etab = P.etab;
  const float* cdf = P.cdf;
  if (P.use_smem) {
    float* s = reinterpret_cast<float*>(smem4);
    auto stage = [&](const float* src, int count) {
      for (int k = threadIdx.x; k < count; k += blockDim.x) s[k] = src[k];
      const float* out = s;
      s += (count + 3) & ~3;  // keep 16-byte alignment for the next array
      return out;
    };
    planes = stage(P.planes, P.n_tri * kPlaneStride);
    table = stage(P.table, P.n_tri * kTableStride);
    if (P.has_vn) vtab = stage(P.vtab, P.n_tri * kVtabStride);
    etab = stage(P.etab, P.n_emissive * P.etab_stride);
    cdf = stage(P.cdf, P.n_emissive);
    __syncthreads();
  }

  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= P.n) return;
  const int n = P.n;

  V3 dir = v3(P.d[i], P.d[n + i], P.d[2 * n + i]);
  V3 rad = v3(0.f, 0.f, 0.f), l_e = rad, l_d = rad, pm = v3(1.f, 1.f, 1.f);
  float segs = 0.f, shadows = 0.f;
  bool alive = P.alive[i] > 0.f;
  const uint32_t h_orig = P.fused ? fmix32(static_cast<uint32_t>(P.orig[i]) ^ P.k0) : 0u;

  Hit cur = Hit{INFINITY, 0};
  V3 point = v3(0.f, 0.f, 0.f);
  if (alive) {
    const V3 o = v3(P.p[i], P.p[n + i], P.p[2 * n + i]);
    cur = intersect(planes, P.n_tri, P.min_dot, P.epsilon, o, dir);
    point = hit_point(o, dir, cur);
  }

  for (int b = 0; alive && b < P.max_bounces; ++b) {
    float u[6];
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      if (P.fused) {
        const uint32_t ctr = static_cast<uint32_t>(b * 8 + s);
        u[s] = unit_from_bits(fmix32((h_orig + ctr * kGolden) ^ P.k1));
      } else {
        u[s] = P.uniforms[static_cast<size_t>(b * 8 + s) * n + i];
      }
    }
    segs += 1.f;
    if (!is_hit(cur)) {
      // Escape.  Q2: the loop body still adds the stale L_d (and L_e).
      if (P.quirks) rad = rad + pm * (l_e + l_d);
      break;
    }
    const int idx = cur.idx;
    const float* row = table + kTableStride * idx;
    const V3 emission = ld3(row);
    const V3 spec = ld3(row + 3);
    const float shin = row[6];
    const V3 face_n = ld3(row + 7);
    const V3 kd = ld3(row + 10);
    const V3 shade_n = P.has_vn
        ? smooth_at(point, vtab + kVtabStride * idx, vtab + kVtabStride * idx + 9,
                    vtab[kVtabStride * idx + 18])
        : face_n;
    // Q1: first-hit emission is kept and re-added every bounce.
    if (b == 0) {
      l_e = emission;
    } else if (!P.quirks) {
      l_e = v3(0.f, 0.f, 0.f);
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
    V3 l_d_fresh = v3(0.f, 0.f, 0.f);
    Hit nxt;
    if (P.n_emissive > 0) {
      shadows += 1.f;
      int e = P.n_emissive - 1;  // u past cdf[-1] clamps to the last emitter
      for (int k = 0; k < P.n_emissive; ++k) {
        if (cdf[k] >= u[0]) {
          e = k;
          break;
        }
      }
      const float* er = etab + P.etab_stride * e;
      const float sq = sqrtf(u[1]);
      const float r2 = u[2];
      const V3 v0 = ld3(er), v1 = ld3(er + 3), v2 = ld3(er + 6);
      const V3 emm = v3((1.f - sq) * v0.x + sq * (1.f - r2) * v1.x + r2 * sq * v2.x,
                        (1.f - sq) * v0.y + sq * (1.f - r2) * v1.y + r2 * sq * v2.y,
                        (1.f - sq) * v0.z + sq * (1.f - r2) * v1.z + r2 * sq * v2.z);
      const V3 to_light = normalize3(emm - point);
      const float cos_theta = dot3(shade_n, to_light);
      const Hit sh = intersect(planes, P.n_tri, P.min_dot, P.epsilon, point, to_light);
      nxt = intersect(planes, P.n_tri, P.min_dot, P.epsilon, point, next_dir);
      bool ok = cos_theta >= 0.f && is_hit(sh);
      const V3 light_n = P.has_vn
          ? smooth_at(hit_point(point, to_light, sh), er, er + 17, er[26])
          : ld3(er + 12);
      const float cos_theta_p = -dot3(light_n, to_light);
      ok = ok && cos_theta_p >= 0.f && static_cast<float>(sh.idx) == er[15];
      if (ok) {
        const float geo = cos_theta * cos_theta_p / (sh.t * sh.t) / er[16];
        V3 bsdf_direct = kd;
        if (!P.no_spec) bsdf_direct = kd + spec * spec_coeff(P, shin, shade_n, dir, to_light);
        l_d_fresh = bsdf_direct * (ld3(er + 9) * geo);
      }
    } else {
      nxt = intersect(planes, P.n_tri, P.min_dot, P.epsilon, point, next_dir);
    }
    l_d = l_d_fresh;
    rad = rad + pm * (l_e + l_d);

    if (!cont) break;
    V3 bsdf;
    float coeff;
    if (P.no_spec) {
      bsdf = kd * P.inv_pi;
      coeff = cosine * P.cos_scale;  // cosine / pdf(=1/pi) / p_RR
    } else {
      const float pdf = is_spec ? powf((shin + 1.f) * cos_t, shin) : P.inv_pi;
      bsdf = kd * P.inv_pi + spec * spec_coeff(P, shin, shade_n, dir, next_dir);
      coeff = pdf > 0.f ? cosine / pdf * P.inv_p_rr : 0.f;
    }
    pm = pm * (bsdf * coeff);
    dir = next_dir;
    cur = nxt;
    point = hit_point(point, next_dir, nxt);
  }

  P.rad[i] = rad.x;
  P.rad[n + i] = rad.y;
  P.rad[2 * n + i] = rad.z;
  P.stats[i] = segs;
  P.stats[n + i] = shadows;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns the cudaError_t of the launch.
int ipt_render_fwd(const float* p, const float* d, const float* alive, const int32_t* orig,
                   const float* uniforms, uint32_t k0, uint32_t k1, int fused,
                   const float* planes, const float* table, const float* vtab, int n_tri,
                   int has_vn, const float* etab, int etab_stride, const float* cdf,
                   int n_emissive, int no_spec, int quirks, int max_bounces, float p_rr,
                   float min_dot, float epsilon, float two_pi, float inv_pi, float inv_2pi,
                   float cos_scale, float inv_p_rr, float* rad, float* stats, int n,
                   void* stream) {
  if (n <= 0) return 0;
  Params P;
  P.p = p;
  P.d = d;
  P.alive = alive;
  P.orig = orig;
  P.uniforms = uniforms;
  P.planes = planes;
  P.table = table;
  P.vtab = vtab;
  P.etab = etab;
  P.cdf = cdf;
  P.rad = rad;
  P.stats = stats;
  P.k0 = k0;
  P.k1 = k1;
  P.n = n;
  P.n_tri = n_tri;
  P.n_emissive = n_emissive;
  P.etab_stride = etab_stride;
  P.has_vn = has_vn;
  P.no_spec = no_spec;
  P.quirks = quirks;
  P.fused = fused;
  P.max_bounces = max_bounces;
  P.p_rr = p_rr;
  P.min_dot = min_dot;
  P.epsilon = epsilon;
  P.two_pi = two_pi;
  P.inv_pi = inv_pi;
  P.inv_2pi = inv_2pi;
  P.cos_scale = cos_scale;
  P.inv_p_rr = inv_p_rr;

  auto padded = [](long long c) { return (c + 3) & ~3LL; };
  long long floats = padded((long long)n_tri * kPlaneStride) + padded((long long)n_tri * kTableStride) +
                     (has_vn ? padded((long long)n_tri * kVtabStride) : 0) +
                     padded((long long)n_emissive * etab_stride) + padded(n_emissive);
  const size_t smem = static_cast<size_t>(floats) * sizeof(float);
  P.use_smem = smem <= static_cast<size_t>(kSmemLimit);
  const int blocks = (n + kThreads - 1) / kThreads;
  render_fwd_kernel<<<blocks, kThreads, P.use_smem ? smem : 0,
                      static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}

const char* ipt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
