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
// What bounds it on this card: for a table of a few rows (garden: one
// sphere padded to 8 rows) the bytes, 28 per ray in and 112 out; for big
// tables (book1's 488 rows under a keyed camera) the FP32 work, 17
// operations a (ray, active row) pair up to the discriminant for a static
// table, 35 for a moving one, then a square root and two roots where the
// discriminant is not negative. With -fmad=false each operation is its own
// instruction, so the no-FMA floor is twice the published-rate bound.
//
// Design, after K10 (sphere_hit.cu), whose search it shares (common.cuh):
// - A persistent grid: as many 128-thread blocks as stay resident
//   (crucible_sphere_shade_shape, queried once per staged size and card by
//   the wrapper). Thread g of the grid takes rays g, g + G, g + 2G, ... (G
//   the grid's threads), so stores stay coalesced. For a table of at most
//   16 staged entries, bound by the bytes, the wrapper launches one ray a
//   thread instead (ops/kernels/sphere_shade.py ONE_RAY_ENTRIES): the same
//   code, each thread's loop then one ray long.
// - Each block stages the table once per chunk of STAGE_ROWS rows: the
//   active rows only, in table order, packed by a warp ballot and a block
//   prefix sum (pack_rows), each entry's table row in a parallel array. A
//   row is read as four 16-byte loads (columns 0-3, 4-7, 24-27, 28-31), two
//   whole 32-byte sectors of its 128 bytes, and staged as K8's 36-byte
//   moving row: (cx, cy, cz, s0), (cdx, cdy, cdz, s1) and s2. Shared memory
//   is sized to the table: 40 bytes an entry with its id.
// - The block decides from the rows it staged whether they move:
//   __syncthreads_or over their non-zero columns 24-26, 28 and 29 (a NaN
//   counts as moving). Where none does, it takes K10's static arithmetic,
//   one LDS.128 and 17 operations a row, else the moving one (moving_terms).
//   No argument and no host sync decide it.
// - Four rays a thread (RPT), each broadcast load of a row serving all
//   four; fewer than four left take the 2- and 1-ray forms. Static rows go
//   four at a time, moving rows two (common.cuh MOVING_STEP), with one
//   branch a ray on the ANDed discriminant sign bits (search_staged). The
//   moving form sets the kernel's registers: four moving rows held 152 (3
//   blocks an SM on an H100), two hold 120 (4 blocks), and the static
//   search at book1's 488 rows ran 9% faster for it.
// - Past one chunk (STAGE_ROWS rows) each ray carries its best t and row
//   through output rows 0 and 1 (exact: a row id below 2^24 is a float32
//   integer) from chunk to chunk; a later chunk replaces them only where it
//   holds a strictly nearer root, so the lowest row still wins ties.
// - After the last chunk, the winner's attributes are read once from global
//   memory: seven 16-byte loads of its row (columns 0-3, then 4-27; the
//   wrapper checks the table's 16-byte alignment). Rows 2-27 are zero on a
//   miss. Stores are row-major (28, R): consecutive threads write
//   consecutive words.
//
// Why the static arithmetic gives the moving one's bits on a static table.
// The plain version (ops/kernels/sphere_shade.py moving_closest_reference)
// always adds the motion terms: dc = dc_a + w dc_d, oc = oc_a + w oc_d,
// csr = (s0 + (2w) s1) + (w w) s2. Where every delta, s1 and s2 is +0 or
// -0, and w and the rays are finite, each motion term is a signed zero, and
// x + (+-0) = x for every x but a zero, whose sign it may turn. So dc, oc
// and csr equal dc_a, oc_a and s0 but for the sign of a zero. A signed zero
// in dc, oc or csr changes h = dc - d.o and c_q = csr - 2 oc + |o|^2 only
// where those are zero, and then only their sign; disc = h h - a c_q keeps
// its bits (h h >= +0, and +0 - (+-0) = +0). A root (h -/+ sqrt(disc)) /
// a depends on the sign of h only where h and sqrt(disc) are both zero,
// and a zero root is never accepted while t_min >= 0 (the block takes the
// moving arithmetic otherwise). So every accepted root, the winner, t and
// the 28 output rows keep their bits (tests/test_torch_sphere_shade.py
// holds both forms on signed-zero motion columns).
//
// Numerics: -fmad=false and no fast math (ops/kernels/build.py), so the
// kernel rounds like its eager version (ops/kernels/sphere_shade.py
// hit_spheres_fetch_reference) and the two agree bit for bit.
//
// Interface: plain C entry points, bound from Python with ctypes. The
// launch runs on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace crucible;

constexpr int C_IN = 32;    // table columns
constexpr int C_OUT = 28;   // output rows
constexpr int BLOCK = 128;  // threads per block
constexpr int RPT = 4;      // rays a thread

// Staged entries' shared memory: two 16-byte entries, s2 and the table row.
__host__ __device__ int smem_bytes(int n) {
  return staged_entries(n) * (int)(2 * sizeof(float4) + sizeof(float) + sizeof(int32_t));
}

// The staged entries of one chunk (see the note at the top).
struct Staged {
  float4* rows;  // (cx, cy, cz, s0)
  float4* mot;   // (cdx, cdy, cdz, s1)
  float* s2;
  int32_t* ids;  // each entry's table row
};

// One table row's four 16-byte loads: columns 0-3 (center, radius), 4-7
// (s0, active, ...), 24-27 (center delta, radius delta), 28-31 (s1, s2,
// ...).
struct TableRow {
  float4 c, s, m, q;
};

// Stage the active rows of table rows [base, base + count), padded to a
// multiple of 4 -> the padded entry count; `moving` says whether any
// staged row has a non-zero motion column. Every thread of the block calls
// it.
__device__ int stage(const float4* __restrict__ table4, int base, int count, const Staged& st,
                     int* s_warp, bool& moving) {
  __syncthreads();  // the previous chunk is no longer read
  int mine = 0;
  const int total = pack_rows<BLOCK, TableRow>(
      count, s_warp,
      [&](int k, TableRow& v) {
        const float4* row = table4 + (size_t)(base + k) * (C_IN / 4);
        v.c = row[0];
        v.s = row[1];
        v.m = row[6];
        v.q = row[7];
        return v.s.y > 0.0f;  // column 5, active
      },
      [&](int pos, int k, const TableRow& v) {
        st.rows[pos] = make_float4(v.c.x, v.c.y, v.c.z, v.s.x);
        st.mot[pos] = make_float4(v.m.x, v.m.y, v.m.z, v.q.x);
        st.s2[pos] = v.q.y;
        st.ids[pos] = base + k;
        mine |= (v.m.x != 0.0f) | (v.m.y != 0.0f) | (v.m.z != 0.0f) | (v.q.x != 0.0f) |
                (v.q.y != 0.0f);
      });
  const int n4 = pad_staged<true>(total, st.rows, st.mot, st.s2, st.ids);
  moving = __syncthreads_or(mine) != 0;
  return n4;
}

// Ray i's output column: t, the winning row as a float and the row's
// attributes (rows 2-5 from table columns 0-3, rows 6-27 from columns
// 6-27), zeros past t on a miss (row < 0). Only the loads depend on the
// hit: a warp of hits and misses issues its 28 stores once.
__device__ __forceinline__ void write_hit(const float4* __restrict__ table4, float* out,
                                          size_t r, size_t i, float best, int row) {
  float4 v[7];
#pragma unroll
  for (int q = 0; q < 7; ++q) v[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= 0) {
    const float4* src = table4 + (size_t)row * (C_IN / 4);
#pragma unroll
    for (int q = 0; q < 7; ++q) v[q] = __ldg(src + q);
  }
  float* col = out + i;
  col[0] = best;
  col[r] = row < 0 ? 0.0f : (float)row;
  col[2 * r] = v[0].x;
  col[3 * r] = v[0].y;
  col[4 * r] = v[0].z;
  col[5 * r] = v[0].w;
  col[6 * r] = v[1].z;
  col[7 * r] = v[1].w;
#pragma unroll
  for (int q = 2; q < 7; ++q) {
    col[(4 * q) * r] = v[q].x;
    col[(4 * q + 1) * r] = v[q].y;
    col[(4 * q + 2) * r] = v[q].z;
    col[(4 * q + 3) * r] = v[q].w;
  }
}

// The rays first, first + stride, ... (K of them) against the staged
// chunk. A later chunk (resume) starts from the best t and row carried in
// output rows 0 and 1; the last chunk writes the whole column with the
// winner's attributes, an earlier one t and the row where they changed.
template <int K, bool MOVING>
__device__ __forceinline__ void batch(const float* o, const float* d, const float* w,
                                      const float4* table4, size_t first, size_t stride,
                                      const Staged& st, int n4, bool resume, bool last,
                                      float t_min, size_t r, float* out) {
  SearchRay y[K];
  int carried[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t i = first + j * stride;
    load_search_ray(o, d, i, y[j]);
    if (MOVING) {
      y[j].w = w[i];
      y[j].two_w = 2.0f * y[j].w;
      y[j].w_sq = y[j].w * y[j].w;
    }
    y[j].best = BIG;
    carried[j] = -1;
    if (resume) {
      y[j].best = out[i];
      if (y[j].best < BIG) carried[j] = (int)out[r + i];
    }
  }
  search_staged<K, MOVING>(st.rows, st.mot, st.s2, n4, t_min, y);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const size_t i = first + j * stride;
    const int row = y[j].k_win >= 0 ? st.ids[y[j].k_win] : carried[j];
    if (last) {
      write_hit(table4, out, r, i, y[j].best, row);
    } else if (y[j].k_win >= 0 || !resume) {
      out[i] = y[j].best;
      out[r + i] = row < 0 ? 0.0f : (float)row;
    }
  }
}

// The thread's `mine` rays (first, first + stride, ...) against the staged
// chunk: RPT at a time, then the 2- and 1-ray forms.
template <bool MOVING>
__device__ __forceinline__ void all_rays(const float* o, const float* d, const float* w,
                                         const float4* table4, size_t first, size_t stride,
                                         size_t mine, const Staged& st, int n4, bool resume,
                                         bool last, float t_min, size_t r, float* out) {
  size_t i = 0;
  for (; i + RPT <= mine; i += RPT) {
    batch<RPT, MOVING>(o, d, w, table4, first + i * stride, stride, st, n4, resume, last,
                       t_min, r, out);
  }
  if (i + 2 <= mine) {
    batch<2, MOVING>(o, d, w, table4, first + i * stride, stride, st, n4, resume, last, t_min,
                     r, out);
    i += 2;
  }
  if (i < mine) {
    batch<1, MOVING>(o, d, w, table4, first + i * stride, stride, st, n4, resume, last, t_min,
                     r, out);
  }
}

__global__ void __launch_bounds__(BLOCK) sphere_shade(
    const float* __restrict__ o,       // (R, 3) origins
    const float* __restrict__ d,       // (R, 3) directions
    const float* __restrict__ w,       // (R,) shutter fractions
    const float4* __restrict__ table4, // (N, 32) sphere attribute table, 16-byte aligned
    int n, int r, float t_min,
    float* __restrict__ out) {         // (28, R)
  extern __shared__ float4 sh4[];
  const int cap = staged_entries(n);
  const Staged st{sh4, sh4 + cap, (float*)(sh4 + 2 * cap),
                  (int32_t*)((float*)(sh4 + 2 * cap) + cap)};
  __shared__ int s_warp[BLOCK / 32];

  const size_t stride = (size_t)gridDim.x * BLOCK;
  const size_t first = (size_t)blockIdx.x * BLOCK + threadIdx.x;
  const size_t mine = first < (size_t)r ? ((size_t)r - 1 - first) / stride + 1 : 0;
  // At least one pass, so that an empty table still writes every miss.
  for (int base = 0; base == 0 || base < n; base += STAGE_ROWS) {
    bool moving;
    const int n4 = stage(table4, base, max(0, min(STAGE_ROWS, n - base)), st, s_warp, moving);
    const bool resume = base > 0, last = base + STAGE_ROWS >= n;
    // A zero root is accepted only where t_min < 0: there the signs of
    // zeros matter, so the static form is not taken (see the note above).
    if (moving || !(t_min >= 0.0f)) {
      all_rays<true>(o, d, w, table4, first, stride, mine, st, n4, resume, last, t_min, r, out);
    } else {
      all_rays<false>(o, d, w, table4, first, stride, mine, st, n4, resume, last, t_min, r,
                      out);
    }
  }
}

}  // namespace

extern "C" {

// Launch K9 on `grid` blocks, at most as many as stay resident
// (crucible_sphere_shade_shape), on `stream`; returns cudaGetLastError().
int crucible_sphere_shade(const float* o, const float* d, const float* w, const float* table,
                          int n, int r, float t_min, int grid, float* out, void* stream) {
  if (grid > 0 && r > 0) {
    sphere_shade<<<grid, BLOCK, smem_bytes(n), (cudaStream_t)stream>>>(
        o, d, w, (const float4*)table, n, r, t_min, out);
  }
  return (int)cudaGetLastError();
}

// K9's launch shape for an N-row table into shape[0..7]: resident blocks
// per SM, SMs, threads per block, registers per thread, local (spill)
// bytes per thread, dynamic shared memory per block, rows staged at a
// time, rays a thread. It also raises the kernel's dynamic shared memory
// limit to what this shape needs (never lowering it: the wrapper caches
// the shapes it launches on), so no launch sets or queries anything.
int crucible_sphere_shade_shape(int n, int32_t* shape) {
  const int bytes = smem_bytes(n);
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, sphere_shade);
  if (e == cudaSuccess && attr.maxDynamicSharedSizeBytes < bytes) {
    e = cudaFuncSetAttribute(sphere_shade, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  int per_sm = 0, sms = 0, dev = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sphere_shade, BLOCK, bytes);
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
