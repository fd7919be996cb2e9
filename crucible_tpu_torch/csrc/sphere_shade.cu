// Closest sphere hit with linear-shutter motion, and the winner's attribute
// row, on Hopper (K9).
//
// Replaces crucible_tpu/ops/pallas/sphere_shade.py::hit_spheres_fetch (its
// pallas_call at sphere_shade.py:136, kernel _kernel at l.50), the kernel of
// the staged 'pixel' schedule's fused bounce (integrator.bounce_step_fused):
// for R rays, each with its shutter fraction w, and an (N, 32) sphere table
// (integrator.make_sphere_table layout), the nearest accepted root against
// spheres at center c + w cd, radius r + w rd, and the winning row's
// attributes, so that the shading after it needs no gathers.
//
// Output (28, R) float32, rows 0-27 of the TPU kernel's (32, R): 0 t (BIG
// on a miss), 1 the winning row as a float (0 on a miss), 2-4 center, 5
// radius, 6-23 the shading columns 6-23, 24-26 center delta, 27 radius
// delta; rows 2-27 are zero on a miss. The TPU kernel's rows 28-31 are
// padding that it never writes and nothing reads, so they are left out.
//
// What bounds it on this card: for the scenes that take it (garden: one
// sphere padded to 8 rows) the bytes, 28 per ray in and 112 out; for big
// tables the FP32 work, about 32 operations per ray and row.
//
// Design: one thread per ray. Ten search columns a row (center, |c|^2 - r^2,
// active, center delta, s1, s2) are staged in shared memory in chunks of
// CHUNK rows between two __syncthreads(), so no row cap is needed. The
// search keeps the Pallas association term by term, with the motion terms
// even at w = 0: dc = dc_a + w dc_d, oc = oc_a + w oc_d,
// csr = s0 + (2w) s1 + (w w) s2, then K10's quadratic (sphere_hit.cu
// row_disc, row_root); a row replaces the best only when strictly nearer, so
// the lowest row wins ties, as in the TPU's min-then-first-index reduction. The
// winner's row is one indexed read from global memory after the search (the
// TPU kernel's one-hot masked sums give the same values). Stores are
// row-major (28, R): consecutive threads write consecutive words.
//
// Numerics: -fmad=false and no fast math (ops/kernels/build.py), so the
// kernel rounds like its eager version (ops/kernels/sphere_shade.py
// hit_spheres_fetch_reference) and the two agree bit for bit.
//
// Interface: a plain C entry point, bound from Python with ctypes. It
// launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace crucible;

constexpr int C_IN = 32;     // table columns
constexpr int C_OUT = 28;    // output rows
constexpr int BLOCK = 128;   // threads (rays) per block
constexpr int CHUNK = 1024;  // rows staged at a time: 10 * 4 * 1024 = 40 KB

// Staged columns: table column of each shared-memory column.
enum { S_CX, S_CY, S_CZ, S_S0, S_ACT, S_CDX, S_CDY, S_CDZ, S_S1, S_S2, NS };
__constant__ int kStagedCol[NS] = {0, 1, 2, 4, 5, 24, 25, 26, 28, 29};

__global__ void __launch_bounds__(BLOCK) sphere_shade(
    const float* __restrict__ o,      // (R, 3) origins
    const float* __restrict__ d,      // (R, 3) directions
    const float* __restrict__ w,      // (R,) shutter fractions
    const float* __restrict__ table,  // (N, 32) sphere attribute table
    int n, int r, float t_min,
    float* __restrict__ out) {        // (28, R)
  __shared__ float s[NS][CHUNK];

  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = ray < r;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  float wr = 0.0f;
  if (live) {
    ox = o[3 * (size_t)ray];
    oy = o[3 * (size_t)ray + 1];
    oz = o[3 * (size_t)ray + 2];
    dx = d[3 * (size_t)ray];
    dy = d[3 * (size_t)ray + 1];
    dz = d[3 * (size_t)ray + 2];
    wr = w[ray];
  }
  const float a_q = dx * dx + dy * dy + dz * dz;
  const float d_dot_o = dx * ox + dy * oy + dz * oz;
  const float o_sq = ox * ox + oy * oy + oz * oz;
  const float inv_a = 1.0f / a_q;
  const float two_w = 2.0f * wr;
  const float w_sq = wr * wr;

  float best = BIG;
  int win = -1;
  for (int base = 0; base < n; base += CHUNK) {
    const int count = min(CHUNK, n - base);
    __syncthreads();  // the previous chunk is no longer read
    for (int e = threadIdx.x; e < NS * count; e += blockDim.x) {
      const int j = e / count, k = e % count;
      s[j][k] = table[(size_t)(base + k) * C_IN + kStagedCol[j]];
    }
    __syncthreads();
    if (!live) continue;
    for (int k = 0; k < count; ++k) {
      if (!(s[S_ACT][k] > 0.0f)) continue;
      const float cx = s[S_CX][k], cy = s[S_CY][k], cz = s[S_CZ][k];
      const float cdx = s[S_CDX][k], cdy = s[S_CDY][k], cdz = s[S_CDZ][k];
      const float dc_a = cx * dx + cy * dy + cz * dz;
      const float dc_d = cdx * dx + cdy * dy + cdz * dz;
      const float oc_a = cx * ox + cy * oy + cz * oz;
      const float oc_d = cdx * ox + cdy * oy + cdz * oz;
      const float dc = dc_a + wr * dc_d;
      const float oc = oc_a + wr * oc_d;
      const float csr = s[S_S0][k] + two_w * s[S_S1][k] + w_sq * s[S_S2][k];
      const float h = dc - d_dot_o;
      const float c_q = csr - 2.0f * oc + o_sq;
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
  if (!live) return;

  float* col = out + ray;
  col[0] = best;
  col[(size_t)r] = win < 0 ? 0.0f : (float)win;
  const float* row = table + (size_t)(win < 0 ? 0 : win) * C_IN;
  for (int c = 2; c < C_OUT; ++c) {
    // Output rows 2-5 hold table columns 0-3 (column 4, |c|^2 - r^2, and
    // 5, active, are not passed on); rows 6-27 the columns of their index.
    const int src = c < 6 ? c - 2 : c;
    const float v = win >= 0 ? row[src] : 0.0f;
    col[(size_t)c * r] = v;
  }
}

}  // namespace

extern "C" {

// Launch K9 on `stream`; returns cudaGetLastError().
int crucible_sphere_shade(const float* o, const float* d, const float* w,
                          const float* table, int n, int r, float t_min,
                          float* out, void* stream) {
  const int grid = (r + BLOCK - 1) / BLOCK;
  if (grid > 0) {
    sphere_shade<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(o, d, w, table, n,
                                                           r, t_min, out);
  }
  return (int)cudaGetLastError();
}

const char* crucible_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
