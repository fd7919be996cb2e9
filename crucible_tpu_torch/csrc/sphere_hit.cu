// Closest sphere hit per ray on Hopper (K10).
//
// Replaces crucible_tpu/ops/pallas/sphere_hit.py::hit_spheres_pallas (its
// pallas_call at sphere_hit.py:103, kernel _kernel at l.34): for R rays and
// an N-row sphere table, the nearest accepted root of each ray's quadratic
// and the row it belongs to. It is the primal of ops/intersect.hit_spheres,
// which every staged bounce and the direct-AD gradient call.
//
// What bounds it on this card: FP32 work. Up to the discriminant a (ray,
// row) pair costs 17 operations (two 3-term dot products, h, c_q and the
// discriminant), then a square root and two roots where the discriminant is
// not negative (under 1% of the pairs at the main shape, 1920x1080 4 spp
// primary rays against book1). With -fmad=false each operation is its own
// instruction, and an SM issues 128 of them a clock, half the 67 TFLOP/s
// that counts an FMA as two: so the 17 instructions a pair, not the
// published rate, are the floor (~2.04 ms at the main shape at 1.98 GHz).
// The bytes are 24 per ray in and 8 out, and 20 per row.
//
// Design (measured in PERF.md §6):
// - A persistent grid: as many 128-thread blocks as stay resident
//   (crucible_sphere_hit_shape, queried once per table size and card by the
//   wrapper). Thread g of the grid takes rays g, g + G, g + 2G, ... (G the
//   grid's threads), so every thread has the same number of rays, within one.
// - Each block stages the table once: the active rows only, in table order,
//   as 16-byte entries (cx, cy, cz, |c|^2 - r^2) in shared memory sized to
//   the table (dynamic, 20 bytes a row), packed by a warp ballot and a block
//   prefix sum, with each entry's table row in a parallel array that is read
//   once per ray, for the winner (common.cuh pack_rows). The entry list is
//   padded to a multiple of 4 with copies of its last entry, which never win
//   (the strict '<' below).
// - Four rays a thread (RPT): each broadcast LDS.128 of a row serves all of
//   them. Rows go four at a time, all four loaded first. A thread's last
//   rays, fewer than RPT, take the 2- and 1-ray forms, so no lane computes
//   a dead ray.
// - Per ray and four rows, one branch: the discriminants' sign bits ANDed
//   (common.cuh search_staged, which K9 shares). The root test keeps its
//   update inside the root's branch (take_root, as the megakernel's
//   brute_row; the other form cost K1 / K2 ~25%).
// - A table past STAGE_ROWS rows goes through chunks of that many rows: the
//   block restages, and each ray carries its best root through its output
//   (read back, and written only where the chunk gave a nearer winner). No
//   row cap: the TPU kernel's VMEM limit has no counterpart here.
// - The FP32 CUDA cores, not the tensor cores: the dot products have K = 3
//   and every product must round on its own; TF32 or BF16 would change the
//   winners, and FP64 MMA rounds differently.
//
// Arithmetic: the Pallas kernel's expanded quadratic, term by term:
// h = c.d - d.o, c_q = (|c|^2 - r^2) - 2 c.o + |o|^2, disc = h^2 - a c_q,
// roots (h -/+ sqrt(disc)) * (1/a), a root accepted in (t_min, BIG). A row
// replaces the best only when strictly nearer, so the lowest table row wins
// ties, as the TPU's min-then-first-index reduction does. A miss returns
// t = BIG, idx = 0. The megakernel's flat loop runs the same arithmetic on
// the same 16-byte entries (megakernel.cu brute_row, over common.cuh's
// static_terms and take_root).
//
// Numerics: -fmad=false and no fast math (ops/kernels/build.py), so the
// kernel rounds like its eager version (ops/kernels/sphere_hit.py
// hit_spheres_reference) and the two agree bit for bit.
//
// Interface: plain C entry points, bound from Python with ctypes. The
// launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace crucible;

constexpr int BLOCK = 128;  // threads per block
constexpr int RPT = 4;      // rays a thread

__host__ __device__ int smem_bytes(int n) {
  return staged_entries(n) * (int)(sizeof(float4) + sizeof(int32_t));
}

// The rays first, first + stride, ... (K of them) against the staged
// chunk (common.cuh search_staged). In the first chunk every ray's result
// is written; in a later one the best so far is read from t_out and both
// outputs are written only where this chunk holds a nearer root.
template <int K>
__device__ __forceinline__ void batch(const float* o, const float* d, size_t first,
                                      size_t stride, const float4* rows, const int32_t* ids,
                                      int n4, bool resume, float t_min, float* t_out,
                                      int32_t* idx_out) {
  SearchRay y[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t i = first + j * stride;
    load_search_ray(o, d, i, y[j]);
    y[j].best = resume ? t_out[i] : BIG;
  }
  search_staged<K, false>(rows, nullptr, nullptr, n4, t_min, y);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t i = first + j * stride;
    if (y[j].k_win >= 0) {
      t_out[i] = y[j].best;
      idx_out[i] = ids[y[j].k_win];
    } else if (!resume) {
      t_out[i] = BIG;
      idx_out[i] = 0;
    }
  }
}

// Stage the active rows of table rows [base, base + count) as entries in
// table order (common.cuh pack_rows), then pad to a multiple of 4 -> the
// padded entry count. Every thread of the block calls it.
__device__ int stage(const float* centers, const float* csr, const float* active, int base,
                     int count, float4* s_rows, int32_t* s_ids, int* s_warp) {
  __syncthreads();  // the previous chunk is no longer read
  const int total = pack_rows<BLOCK, int>(
      count, s_warp, [&](int k, int&) { return active[base + k] > 0.0f; },
      [&](int pos, int k, int) {
        const float* c = centers + 3 * (size_t)(base + k);
        s_rows[pos] = make_float4(c[0], c[1], c[2], csr[base + k]);
        s_ids[pos] = base + k;
      });
  const int n4 = pad_staged<false>(total, s_rows, nullptr, nullptr, s_ids);
  __syncthreads();
  return n4;
}

__global__ void __launch_bounds__(BLOCK) sphere_hit(
    const float* __restrict__ o,        // (R, 3) origins
    const float* __restrict__ d,        // (R, 3) directions
    const float* __restrict__ centers,  // (N, 3)
    const float* __restrict__ csr,      // (N,) |c|^2 - r^2
    const float* __restrict__ active,   // (N,) 0 / 1
    int n, int r, float t_min,
    float* __restrict__ t_out,          // (R,) hit distance, BIG on a miss
    int32_t* __restrict__ idx_out) {    // (R,) winning row, 0 on a miss
  extern __shared__ float4 s_rows[];    // staged_entries(n) entries, then their ids
  int32_t* s_ids = (int32_t*)(s_rows + staged_entries(n));
  __shared__ int s_warp[BLOCK / 32];

  const size_t stride = (size_t)gridDim.x * BLOCK;
  const size_t first = (size_t)blockIdx.x * BLOCK + threadIdx.x;
  const size_t mine = first < (size_t)r ? ((size_t)r - 1 - first) / stride + 1 : 0;
  for (int base = 0; base < n; base += STAGE_ROWS) {
    const int n4 = stage(centers, csr, active, base, min(STAGE_ROWS, n - base), s_rows,
                         s_ids, s_warp);
    const bool resume = base > 0;
    size_t i = 0;
    for (; i + RPT <= mine; i += RPT) {
      batch<RPT>(o, d, first + i * stride, stride, s_rows, s_ids, n4, resume, t_min, t_out,
                 idx_out);
    }
    if (i + 2 <= mine) {
      batch<2>(o, d, first + i * stride, stride, s_rows, s_ids, n4, resume, t_min, t_out,
               idx_out);
      i += 2;
    }
    if (i < mine) {
      batch<1>(o, d, first + i * stride, stride, s_rows, s_ids, n4, resume, t_min, t_out,
               idx_out);
    }
  }
}

}  // namespace

extern "C" {

// Launch K10 on `grid` blocks, at most as many as stay resident
// (crucible_sphere_hit_shape), on `stream`; returns cudaGetLastError().
int crucible_sphere_hit(const float* o, const float* d, const float* centers,
                        const float* csr, const float* active, int n, int r,
                        float t_min, int grid, float* t_out, int32_t* idx_out,
                        void* stream) {
  if (grid > 0 && r > 0) {
    sphere_hit<<<grid, BLOCK, smem_bytes(n), (cudaStream_t)stream>>>(
        o, d, centers, csr, active, n, r, t_min, t_out, idx_out);
  }
  return (int)cudaGetLastError();
}

// K10's launch shape for an N-row table into shape[0..7]: resident blocks
// per SM, SMs, threads per block, registers per thread, local (spill)
// bytes per thread, dynamic shared memory per block, rows staged at a
// time, rays a thread. It also raises the kernel's dynamic shared memory
// limit to what this shape needs (never lowering it: the wrapper caches
// the shapes it launches on), so no launch sets or queries anything.
int crucible_sphere_hit_shape(int n, int32_t* shape) {
  const int bytes = smem_bytes(n);
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, sphere_hit);
  if (e == cudaSuccess && attr.maxDynamicSharedSizeBytes < bytes) {
    e = cudaFuncSetAttribute(sphere_hit, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  int per_sm = 0, sms = 0, dev = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sphere_hit, BLOCK, bytes);
  }
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  shape[0] = per_sm;
  shape[1] = sms;
  shape[2] = BLOCK;
  shape[3] = attr.numRegs;
  shape[4] = (int32_t)attr.localSizeBytes;
  shape[5] = bytes;
  shape[6] = STAGE_ROWS;
  shape[7] = RPT;
  return per_sm < 1 ? (int)cudaErrorInvalidConfiguration : (int)cudaSuccess;
}

const char* crucible_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
