// Pieces shared by the port's CUDA kernels: the "no hit" distance, the
// PCG4D counter hash of utils/rng.py, its stream ids, the material and
// texture kinds, and the record-word layout of models/replay.py (F_TRI
// marks a triangle winner, K7).
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

}  // namespace crucible
