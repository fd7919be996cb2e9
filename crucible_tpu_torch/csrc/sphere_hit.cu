// Closest sphere hit per ray on Hopper (K10).
//
// Replaces crucible_tpu/ops/pallas/sphere_hit.py::hit_spheres_pallas (its
// pallas_call at sphere_hit.py:103, kernel _kernel at l.34): for R rays and
// an N-row sphere table, the nearest accepted root of each ray's quadratic
// and the row it belongs to. It is the primal of ops/intersect.hit_spheres,
// which every staged bounce and the direct-AD gradient call.
//
// What bounds it on this card: FP32 work, about 22 operations per ray and
// row (two 3-term dot products, the quadratic, a square root, two roots);
// the bytes are 28 per ray in and 9 out, and 20 per row.
//
// Design: one thread per ray. The search columns (center x/y/z,
// |c|^2 - r^2, active) are staged in shared memory in chunks of CHUNK rows,
// SoA, between two __syncthreads(); every thread of a warp then reads the
// same row at the same time, which shared memory serves as a broadcast. So
// no row cap is needed (the TPU kernel's VMEM limit has no counterpart), and
// the chunk loop keeps every thread of the block in the barriers even past
// the last ray. The search itself is common.cuh's closest_sphere, the
// arithmetic of the megakernel's brute search (K1): the Pallas kernel's expanded
// quadratic, term by term, with the lowest row winning ties as the TPU's
// min-then-first-index reduction does. A miss returns t = BIG, idx = 0,
// as the TPU kernel does.
//
// Numerics: -fmad=false and no fast math (ops/kernels/build.py), so the
// kernel rounds like its eager version (ops/kernels/sphere_hit.py
// hit_spheres_reference) and the two agree bit for bit.
//
// Interface: a plain C entry point, bound from Python with ctypes. It
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace crucible;

constexpr int BLOCK = 128;   // threads (rays) per block
constexpr int CHUNK = 2048;  // rows staged at a time: 5 * 4 * 2048 = 40 KB

__global__ void __launch_bounds__(BLOCK) sphere_hit(
    const float* __restrict__ o,        // (R, 3) origins
    const float* __restrict__ d,        // (R, 3) directions
    const float* __restrict__ centers,  // (N, 3)
    const float* __restrict__ csr,      // (N,) |c|^2 - r^2
    const float* __restrict__ active,   // (N,) 0 / 1
    int n, int r, float t_min,
    float* __restrict__ t_out,          // (R,) hit distance, BIG on a miss
    int32_t* __restrict__ idx_out) {    // (R,) winning row, 0 on a miss
  __shared__ float s_cx[CHUNK], s_cy[CHUNK], s_cz[CHUNK], s_csr[CHUNK],
      s_act[CHUNK];

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  if (live) {
    ox = o[3 * (size_t)ray];
    oy = o[3 * (size_t)ray + 1];
    oz = o[3 * (size_t)ray + 2];
    dx = d[3 * (size_t)ray];
    dy = d[3 * (size_t)ray + 1];
    dz = d[3 * (size_t)ray + 2];
  }
  const float a_q = dx * dx + dy * dy + dz * dz;
  const float d_dot_o = dx * ox + dy * oy + dz * oz;
  const float o_sq = ox * ox + oy * oy + oz * oz;
  const float inv_a = 1.0f / a_q;

  float best = BIG;
  int win = -1;
  for (int base = 0; base < n; base += CHUNK) {
    const int count = min(CHUNK, n - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int k = threadIdx.x; k < count; k += blockDim.x) {
      const float* c = centers + 3 * (size_t)(base + k);
      s_cx[k] = c[0];
      s_cy[k] = c[1];
      s_cz[k] = c[2];
      s_csr[k] = csr[base + k];
      s_act[k] = active[base + k];
    }
    __syncthreads();
    if (live) {
      closest_sphere(s_cx, s_cy, s_cz, s_csr, s_act, count, base, ox, oy, oz,
                     dx, dy, dz, a_q, d_dot_o, o_sq, inv_a, t_min, best, win);
    }
  }
  if (!live) return;
  t_out[ray] = best;
  idx_out[ray] = win < 0 ? 0 : win;
}

}  // namespace

extern "C" {

// Launch K10 on `stream`; returns cudaGetLastError().
int crucible_sphere_hit(const float* o, const float* d, const float* centers,
                        const float* csr, const float* active, int n, int r,
                        float t_min, float* t_out, int32_t* idx_out,
                        void* stream) {
  const int grid = (r + BLOCK - 1) / BLOCK;
  if (grid > 0) {
    sphere_hit<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(
        o, d, centers, csr, active, n, r, t_min, t_out, idx_out);
  }
  return (int)cudaGetLastError();
}

const char* crucible_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
