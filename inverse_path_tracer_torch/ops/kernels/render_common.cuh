// Device code shared by render_fwd.cu (B1, B3) and render_bwd.cu (B2, B4):
// the vector helpers, the counter-hash RNG, the closest-hit sweep, the
// shading helpers and the whole bounce loop of one ray (trace_path).
//
// trace_path is templated on a record sink, so that B1 (no records), B3
// (records to global memory) and B2 (records in a per-thread array) run one
// copy of the arithmetic.  Every file that includes this header is built
// with -fmad=false (build.py), so B2's replay takes exactly the branches of
// B1's forward and rounds exactly as the plain PyTorch version does.
//
// Records: kRecRows rows per bounce, row-major (max_bounces * kRecRows, n),
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

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ipt {

constexpr int kPlaneStride = 16;  // n, -c.n, out0, d0, out1, d1, out2, d2
constexpr int kTableStride = 16;  // emission 0:3 spec 3:6 shin 6 face_n 7:10 kd 10:13
constexpr int kVtabStride = 20;   // verts 0:9 vertex normals 9:18 area 18
// Emitter rows: verts 0:9 emission 9:12 face_n 12:15 tri 15 p 16
// (+ vertex normals 17:26, area 26 on vertex-normal scenes).
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemLimit = 48 * 1024;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr int kRecRows = 16;

// The inputs of the bounce loop.  Pointers to the scene tables are the
// global copies; stage_tables returns the ones a block reads.
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
  uint32_t k0, k1;
  int n, n_tri, n_emissive, etab_stride;
  int has_vn, no_spec, quirks, fused, max_bounces, use_smem;
  float p_rr, min_dot, epsilon;
  float two_pi, inv_pi, inv_2pi, cos_scale, inv_p_rr;
};

struct Tables {
  const float* planes;
  const float* table;
  const float* vtab;
  const float* etab;
  const float* cdf;
};

// Floats the scene tables take in shared memory, each array padded to 16
// bytes.
inline long long table_floats(int n_tri, int has_vn, int n_emissive, int etab_stride) {
  auto padded = [](long long c) { return (c + 3) & ~3LL; };
  return padded((long long)n_tri * kPlaneStride) + padded((long long)n_tri * kTableStride) +
         (has_vn ? padded((long long)n_tri * kVtabStride) : 0) +
         padded((long long)n_emissive * etab_stride) + padded(n_emissive);
}

// Copies the tables into shared memory at `s` when P.use_smem (then
// synchronises the block); otherwise the block reads them from global
// memory through L1.  Every thread of the block must call it.
__device__ __forceinline__ Tables stage_tables(const TraceParams& P, float* s) {
  Tables T{P.planes, P.table, P.vtab, P.etab, P.cdf};
  if (P.use_smem) {
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

// Record sinks of trace_path.  put() receives bounce b's record fields.
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

struct PathOut {
  V3 rad;
  float segs, shadows;
  int n_reached;  // bounces the ray entered (records written)
  bool escaped;   // the last of them was an escape
};

// The bounce loop of one ray: B1's forward (JAX _make_bounce, render_kernel
// .py:602), with every bounce's record handed to `sink`.  The last bounce
// is recorded too: on escape (f = 0, nee = 0, c = the stale l_e + l_d with
// quirks, else 0) and when roulette ends the path (f = 0, coeff = 0).
template <class Sink>
__device__ __forceinline__ PathOut trace_path(const TraceParams& P, const Tables& T, int i,
                                              Sink& sink) {
  const int n = P.n;
  V3 dir = v3(P.d[i], P.d[n + i], P.d[2 * n + i]);
  V3 rad = zero3(), l_e = rad, l_d = rad, pm = v3(1.f, 1.f, 1.f);
  float segs = 0.f, shadows = 0.f;
  int n_reached = 0;
  bool escaped = false;
  bool alive = P.alive[i] > 0.f;
  const uint32_t h_orig = P.fused ? fmix32(static_cast<uint32_t>(P.orig[i]) ^ P.k0) : 0u;

  Hit cur = Hit{INFINITY, 0};
  V3 point = zero3();
  if (alive) {
    const V3 o = v3(P.p[i], P.p[n + i], P.p[2 * n + i]);
    cur = intersect(T.planes, P.n_tri, P.min_dot, P.epsilon, o, dir);
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
    n_reached = b + 1;
    if (!is_hit(cur)) {
      // Escape.  Q2: the loop body still adds the stale L_d (and L_e).
      V3 c = zero3();
      if (P.quirks) {
        c = l_e + l_d;
        rad = rad + pm * c;
      }
      sink.put(b, zero3(), c, zero3(), pm, 0.f, 0, false, true);
      escaped = true;
      break;
    }
    const int idx = cur.idx;
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
      l_e = emission;
    } else if (!P.quirks) {
      l_e = zero3();
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
    Hit nxt;
    if (P.n_emissive > 0) {
      shadows += 1.f;
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
      const Hit sh = intersect(T.planes, P.n_tri, P.min_dot, P.epsilon, point, to_light);
      nxt = intersect(T.planes, P.n_tri, P.min_dot, P.epsilon, point, next_dir);
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
    } else {
      nxt = intersect(T.planes, P.n_tri, P.min_dot, P.epsilon, point, next_dir);
    }
    l_d = l_d_fresh;
    const V3 c = l_e + l_d;
    rad = rad + pm * c;

    if (!cont) {
      sink.put(b, zero3(), c, nee, pm, 0.f, idx, true, false);
      break;
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
    sink.put(b, f, c, nee, pm, coeff, idx, true, false);
    pm = pm * f;
    dir = next_dir;
    cur = nxt;
    point = hit_point(point, next_dir, nxt);
  }
  return PathOut{rad, segs, shadows, n_reached, escaped};
}

}  // namespace ipt
