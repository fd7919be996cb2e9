// Pieces shared by the port's CUDA kernels: the PCG4D counter hash of
// utils/rng.py, its stream ids, the record-word layout of models/replay.py
// (F_TRI marks a triangle winner, K7), and the closest-sphere search of
// K10; the megakernel's flat loop runs the same arithmetic on its 16-byte
// row entries (megakernel.cu brute_row, moving_row, and static_terms /
// moving_terms in tree_closest).
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

// One ray against `count` rows of SoA sphere columns (center x/y/z,
// csr = |c|^2 - r^2, active), in the expanded quadratic of the Pallas
// kernels (sphere_hit.py _kernel): h = c.d - d.o, c_q = csr - 2 c.o + |o|^2,
// disc = h^2 - a c_q, roots (h -/+ sqrt(disc)) * (1/a), a root accepted in
// (t_min, BIG). The caller passes a = |d|^2, d.o, |o|^2 and 1/a. A row
// replaces (best, win) only when its root is strictly nearer, so the lowest
// row wins ties; rows are numbered from `base`. Every product and sum is
// rounded on its own (build with -fmad=false), as the eager versions round.
__device__ __forceinline__ void closest_sphere(
    const float* cx, const float* cy, const float* cz, const float* csr,
    const float* act, int count, int base, float ox, float oy, float oz,
    float dx, float dy, float dz, float a_q, float d_dot_o, float o_sq,
    float inv_a, float t_min, float& best, int& win) {
  for (int k = 0; k < count; ++k) {
    if (!(act[k] > 0.0f)) continue;
    const float c0 = cx[k], c1 = cy[k], c2 = cz[k];
    const float dck = c0 * dx + c1 * dy + c2 * dz;
    const float ock = c0 * ox + c1 * oy + c2 * oz;
    const float h = dck - d_dot_o;
    const float c_q = csr[k] - 2.0f * ock + o_sq;
    const float disc = h * h - a_q * c_q;
    if (!(disc >= 0.0f)) continue;
    const float sq = sqrtf(disc);
    const float root0 = (h - sq) * inv_a;
    const float root1 = (h + sq) * inv_a;
    const bool ok0 = (root0 > t_min) && (root0 < BIG);
    const bool ok1 = (root1 > t_min) && (root1 < BIG);
    if (!(ok0 || ok1)) continue;
    const float root = ok0 ? root0 : root1;
    if (root < best) {
      best = root;
      win = base + k;
    }
  }
}

}  // namespace crucible
