// Pieces shared by the port's CUDA kernels: the "no hit" distance, the
// PCG4D counter hash of utils/rng.py, its stream ids, the material and
// texture kinds, the record-word layout of models/replay.py (F_TRI marks a
// triangle winner, K7), and the closest-sphere search of K9, K10 and the
// megakernel's brute search and walks (K1, K2, K5, K6, K8).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace crucible {

constexpr float BIG = 3.0e38f;        // "no hit" distance
constexpr float TWO_PI = 6.2831855f;  // float32(2*pi)
constexpr uint32_t PCG_MULT = 1664525u;
constexpr uint32_t PCG_ADD = 1013904223u;
constexpr uint32_t STREAM_TIME = 0u;
constexpr uint32_t STREAM_PIXEL_JITTER = 1u;
constexpr uint32_t STREAM_BOUNCE_BASE = 3u;

// Material and texture kinds (models/materials.py, models/textures.py).
constexpr float METAL = 1.0f;
constexpr float DIELECTRIC = 2.0f;
constexpr float EMISSIVE = 3.0f;
constexpr float TEX_CHECKER = 1.0f;

// Decision bits of a record word: winner id * REC_ID_SCALE + flag byte.
constexpr int F_ALIVE = 1;
constexpr int F_HIT = 2;
constexpr int F_TRI = 4;
constexpr int F_SCAT = 8;
constexpr int F_FRONT = 16;
constexpr int F_REFL = 32;
constexpr int F_DEGEN = 64;
constexpr int F_ROOT1 = 128;
constexpr int REC_ID_SCALE = 256;

struct U4 {
  float x, y, z, w;
};

// PCG4D (utils/rng.py) in native uint32 arithmetic, which wraps as the
// reference's uint32 arithmetic does.
__device__ __forceinline__ U4 uniform4(uint32_t x, uint32_t y, uint32_t z,
                                       uint32_t w) {
  x = x * PCG_MULT + PCG_ADD;
  y = y * PCG_MULT + PCG_ADD;
  z = z * PCG_MULT + PCG_ADD;
  w = w * PCG_MULT + PCG_ADD;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  w ^= w >> 16;
  x += y * w;
  y += z * x;
  z += x * y;
  w += y * z;
  // Top 24 bits -> [0, 1), exact in float32.
  const float s = 0x1p-24f;
  return U4{(float)(x >> 8) * s, (float)(y >> 8) * s, (float)(z >> 8) * s,
            (float)(w >> 8) * s};
}

// --- The closest-sphere search ------------------------------------------------
//
// Each kernel keeps the Pallas kernels' expanded quadratic term by term:
// h = c.d - d.o, c_q = (|c|^2 - r^2) - 2 c.o + |o|^2, disc = h^2 - a c_q,
// roots (h -/+ sqrt(disc)) * (1/a), a root accepted in (t_min, BIG), and a
// row replaces the best only when strictly nearer, so that the lowest row
// wins ties. A moving row (the linear shutter, K8, K9) adds w (cd.d) and
// w (cd.o) to the dot products and 2w s1 + w^2 s2 to |c|^2 - r^2, in K9's
// association. With -fmad=false each operation rounds on its own, as in
// the plain versions.

// A static row entry c = (cx, cy, cz, |c|^2 - r^2) against the ray ->
// (h, c_q).
__device__ __forceinline__ void static_terms(const float4 c, float ox, float oy, float oz,
                                             float dx, float dy, float dz, float d_dot_o,
                                             float o_sq, float& h, float& c_q) {
  const float dck = c.x * dx + c.y * dy + c.z * dz;
  const float ock = c.x * ox + c.y * oy + c.z * oz;
  h = dck - d_dot_o;
  c_q = c.w - 2.0f * ock + o_sq;
}

// A moving row (entries c, m = (cdx, cdy, cdz, s1) and s2) at the shutter
// fraction w -> (h, c_q).
__device__ __forceinline__ void moving_terms(const float4 c, const float4 m, float s2,
                                             float ox, float oy, float oz, float dx,
                                             float dy, float dz, float d_dot_o, float o_sq,
                                             float w, float two_w, float w_sq, float& h,
                                             float& c_q) {
  const float dck = (c.x * dx + c.y * dy + c.z * dz) + w * (m.x * dx + m.y * dy + m.z * dz);
  const float ock = (c.x * ox + c.y * oy + c.z * oz) + w * (m.x * ox + m.y * oy + m.z * oz);
  const float csrk = c.w + two_w * m.w + w_sq * s2;
  h = dck - d_dot_o;
  c_q = csrk - 2.0f * ock + o_sq;
}

// Row k's accepted root, where its discriminant is not negative; it
// replaces (best, k_win) only when strictly nearer. The update stays
// inside the root's branch: a form that returned the root to the caller
// compiled ~25% slower for K1 / K2 on an H100.
__device__ __forceinline__ void take_root(float h, float disc, int k, float inv_a, float t_min,
                                          float& best, int& k_win) {
  if (disc >= 0.0f) {
    const float sq = sqrtf(disc);
    const float root0 = (h - sq) * inv_a;
    const float root1 = (h + sq) * inv_a;
    const bool ok0 = (root0 > t_min) && (root0 < BIG);
    const bool ok1 = (root1 > t_min) && (root1 < BIG);
    const float root = ok0 ? root0 : root1;
    if ((ok0 || ok1) && root < best) {
      best = root;
      k_win = k;
    }
  }
}

// Table rows a block of K9 or K10 stages at a time; a larger table goes
// through chunks of this many rows.
constexpr int STAGE_ROWS = 2048;

// Entries staged for an N-row table: its first chunk, padded to 4.
__host__ __device__ inline int staged_entries(int n) {
  const int rows = n < STAGE_ROWS ? n : STAGE_ROWS;
  return (rows + 3) & ~3;
}

// One ray of K9's or K10's search and its running winner; k_win indexes the
// staged entries. w, two_w and w_sq are read by the moving search only.
struct SearchRay {
  float ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a, w, two_w, w_sq, best;
  int k_win;
};

// Ray i of (R, 3) origins and directions, with no winner yet.
__device__ __forceinline__ void load_search_ray(const float* o, const float* d, size_t i,
                                                SearchRay& y) {
  y.ox = o[3 * i];
  y.oy = o[3 * i + 1];
  y.oz = o[3 * i + 2];
  y.dx = d[3 * i];
  y.dy = d[3 * i + 1];
  y.dz = d[3 * i + 2];
  y.a_q = y.dx * y.dx + y.dy * y.dy + y.dz * y.dz;
  y.d_dot_o = y.dx * y.ox + y.dy * y.oy + y.dz * y.oz;
  y.o_sq = y.ox * y.ox + y.oy * y.oy + y.oz * y.oz;
  y.inv_a = 1.0f / y.a_q;
  y.k_win = -1;
}

// Entry (c; with MOVING m, s2) against the ray -> disc; h beside it.
template <bool MOVING>
__device__ __forceinline__ float entry_disc(const float4 c, const float4 m, float s2,
                                            const SearchRay& y, float& h) {
  float c_q;
  if (MOVING) {
    moving_terms(c, m, s2, y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, y.d_dot_o, y.o_sq, y.w,
                 y.two_w, y.w_sq, h, c_q);
  } else {
    static_terms(c, y.ox, y.oy, y.oz, y.dx, y.dy, y.dz, y.d_dot_o, y.o_sq, h, c_q);
  }
  return h * h - y.a_q * c_q;
}

// Rows a step of the moving search (search_staged): two, so that its 36
// bytes a row and four rays fit K9's registers (sphere_shade.cu).
constexpr int MOVING_STEP = 2;

// K rays against n4 staged entries (n4 a multiple of 4): rows[k] = (cx, cy,
// cz, |c|^2 - r^2), with MOVING also mot[k] = (cdx, cdy, cdz, s1) and
// s2[k]. Rows go four at a time (MOVING_STEP moving), all loaded first
// (broadcast LDS.128s that serve the K rays), then per ray one branch: the
// discriminants' sign bits ANDed. A discriminant is never -0 (h * h >=
// +0), so a clear sign bit marks one that is >= 0, or a NaN (which the
// row's own test then rejects).
template <int K, bool MOVING>
__device__ __forceinline__ void search_staged(const float4* rows, const float4* mot,
                                              const float* s2, int n4, float t_min,
                                              SearchRay (&y)[K]) {
  constexpr int STEP = MOVING ? MOVING_STEP : 4;
  for (int k = 0; k < n4; k += STEP) {
    float4 c[STEP], m[STEP];
    float q[STEP];
#pragma unroll
    for (int u = 0; u < STEP; ++u) {
      c[u] = rows[k + u];
      m[u] = MOVING ? mot[k + u] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      q[u] = MOVING ? s2[k + u] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) {
      float h[STEP], e[STEP];
      uint32_t signs = 0xffffffffu;
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        e[u] = entry_disc<MOVING>(c[u], m[u], q[u], y[j], h[u]);
        signs &= __float_as_uint(e[u]);
      }
      if ((int32_t)signs >= 0) {
#pragma unroll
        for (int u = 0; u < STEP; ++u) {
          take_root(h[u], e[u], k + u, y[j].inv_a, t_min, y[j].best, y[j].k_win);
        }
      }
    }
  }
}

// Pack the rows k in [0, count) that load(k, v) accepts, in row order,
// calling put(pos, k, v) for each at positions 0, 1, ... (a warp ballot
// and a block prefix sum over NT / 32 warps) -> how many. load reads row k
// into a V; put writes the entry. Every thread of the NT-thread block
// calls it; s_warp holds NT / 32 ints. It ends with a barrier, so every
// entry is written when it returns.
template <int NT, class V, class Load, class Put>
__device__ __forceinline__ int pack_rows(int count, int* s_warp, Load load, Put put) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int k0 = 0; k0 < count; k0 += NT) {
    const int k = k0 + threadIdx.x;
    V v{};
    const bool on = k < count && load(k, v);
    const uint32_t mask = __ballot_sync(0xffffffffu, on);
    if (lane == 0) s_warp[warp] = __popc(mask);
    __syncthreads();
    int pos = total, sum = total;
    for (int w = 0; w < NT / 32; ++w) {
      if (w < warp) pos += s_warp[w];
      sum += s_warp[w];
    }
    if (on) put(pos + __popc(mask & ((1u << lane) - 1u)), k, v);
    total = sum;
    __syncthreads();  // s_warp is written again; the entries are complete
  }
  return total;
}

// Pad `total` packed entries to a multiple of 4 with copies of the last
// one, which never win (the strict '<'): rows and ids, with MOVING also mot
// and s2 -> the padded count. Threads 0-2 write; the caller's barrier
// follows.
template <bool MOVING>
__device__ __forceinline__ int pad_staged(int total, float4* rows, float4* mot, float* s2,
                                          int32_t* ids) {
  const int n4 = (total + 3) & ~3;
  if ((int)threadIdx.x < n4 - total) {
    rows[total + threadIdx.x] = rows[total - 1];
    ids[total + threadIdx.x] = ids[total - 1];
    if (MOVING) {
      mot[total + threadIdx.x] = mot[total - 1];
      s2[total + threadIdx.x] = s2[total - 1];
    }
  }
  return n4;
}

}  // namespace crucible
