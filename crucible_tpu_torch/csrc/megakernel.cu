// Persistent path-tracing megakernel for sphere scenes on Hopper: forward
// mode (K1) and record mode (K2).
//
// Replaces crucible_tpu/ops/pallas/megakernel.py::_kernel for its
// brute-sphere, static-camera, non-animated branch, in both of its modes:
// - forward (run_megakernel, pallas_call at megakernel.py:1681): camera ray
//   generation with jitter and defocus, the PCG4D counter hash, the
//   closest-root sphere quadratic over every table row, the winner's
//   attribute fetch, solid / checker-of-solid albedo, default sky, emission,
//   and Lambertian / metal / dielectric / emissive scatter, accumulated into
//   per-lane radiance sums;
// - record (run_megakernel_record, pallas_call at megakernel.py:1828): each
//   lane traces one (pixel, sample) path and writes one packed decision word
//   per bounce (winner id * 256 + flag byte, models/replay.py layout); the
//   fused variant also accumulates that path's radiance from bounce
//   smem[4] on.
// Both modes are one templated kernel: the record flags only add the
// decision words, so the forward instantiation's arithmetic is unchanged.
//
// What bounds it on this card: per-thread FP32 work on the N-row quadratic
// (about 20 flops and a square root per row per bounce), with divergence at
// the material branches and at path termination. Record mode adds 4 bytes
// per bounce per lane of stores (coalesced: row-major (D, R)).
//
// Design: one thread per lane. The thread walks its pixel's samples
// sample0..spp-1 (record mode: sample0 only) and, within each sample,
// bounces until the path ends; lanes are independent, so the TPU kernel's
// lockstep regeneration bookkeeping becomes this plain nested loop. The
// intersection columns of the table (center x/y/z, |c|^2 - r^2, active) are
// staged once per block in shared memory as SoA; every thread of a warp
// reads the same row at the same time, which shared memory serves as a
// broadcast. The winner's row is read from global memory by index: an
// indexed load is exact, so the TPU's one-hot MXU fetch and its bf16 split
// have no counterpart here. On a miss no row is read.
//
// Numerics: every literal is float32 and the arithmetic follows the Pallas
// kernel's association operation for operation. Build with -fmad=false and
// without --use_fast_math (ops/kernels/build.py), so that no multiply-add is
// contracted, sqrtf and '/' round correctly and sinf/cosf are the precise
// versions: the kernel then agrees with its eager-torch version to rounding
// of the transcendental functions. Re-enabling FMA contraction is left to a
// later change that re-measures both speed and agreement.
//
// Interface: plain C entry points, bound from Python with ctypes. They
// launch on the caller's stream, allocate nothing and return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace crucible;

constexpr int C_IN = 32;           // table columns (sphere_shade.py layout)
constexpr int SMEM_COLS = 5;       // staged columns: cx, cy, cz, csr, active
constexpr int BLOCK = 128;         // threads per block (4 warps)
constexpr int NO_SAMPLE = 1 << 30;  // sample0 of a padding lane

// RECORD: one path per lane, decision words to `rec` (D, R).
// RADIANCE: accumulate radiance into `out` (3, R); in record mode only from
// bounce smem[4] on. Forward mode is <false, true>.
template <bool RECORD, bool RADIANCE>
__global__ void __launch_bounds__(BLOCK) megakernel(
    const int32_t* __restrict__ smem,     // (8,) [spp, seed, width, max_depth, accum_from, ...]
    const int32_t* __restrict__ pix_in,   // (R,) pixel ids
    const int32_t* __restrict__ sample0,  // (R,) first sample (2^30 = padding)
    const float* __restrict__ cam,        // (48,) camera constants
    const float* __restrict__ table,      // (N, 32) sphere attribute table
    int n, int r, float t_min,
    float* __restrict__ out,              // (3, R) radiance sums
    int32_t* __restrict__ rec) {          // (max_depth, R) records (RECORD only)
  extern __shared__ float sh[];
  float* s_cx = sh;
  float* s_cy = sh + n;
  float* s_cz = sh + 2 * n;
  float* s_csr = sh + 3 * n;
  float* s_act = sh + 4 * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    const float* row = table + (size_t)k * C_IN;
    s_cx[k] = row[0];
    s_cy[k] = row[1];
    s_cz[k] = row[2];
    s_csr[k] = row[4];
    s_act[k] = row[5];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= r) return;

  const int spp = smem[0];
  const uint32_t seed = (uint32_t)smem[1];
  const int width = smem[2];
  const int max_depth = smem[3];
  const int accum_from = RECORD ? smem[4] : 0;

  const int pix = pix_in[lane];
  const uint32_t upix = (uint32_t)pix;
  const float fi = (float)(pix % width);
  const float fj = (float)(pix / width);

  // Static camera slots (megakernel.py CAM_SIZE layout).
  const float p00x = cam[0], p00y = cam[1], p00z = cam[2];
  const float dux = cam[3], duy = cam[4], duz = cam[5];
  const float dvx = cam[6], dvy = cam[7], dvz = cam[8];
  const float lfx = cam[9], lfy = cam[10], lfz = cam[11];
  const float ubx = cam[12], uby = cam[13], ubz = cam[14];
  const float vbx = cam[15], vby = cam[16], vbz = cam[17];
  const float defr = cam[18];

  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  // Record rows written so far; the rest are zeroed after the path ends.
  int rows = 0;

  // Record mode issues one path (sample0 itself); padding lanes none.
  const int s0 = sample0[lane];
  const int s_end = RECORD ? (s0 < NO_SAMPLE ? s0 + 1 : s0) : spp;
  for (int smp = s0; smp < s_end; ++smp) {
    // --- primary ray: jitter + defocus from one hash -----------------------
    const U4 uc = uniform4(upix, (uint32_t)smp, STREAM_PIXEL_JITTER, seed);
    const float oxj = fi + (uc.x - 0.5f);
    const float oyj = fj + (uc.y - 0.5f);
    const float px = p00x + oxj * dux + oyj * dvx;
    const float py = p00y + oxj * duy + oyj * dvy;
    const float pz = p00z + oxj * duz + oyj * dvz;
    const float dphi = TWO_PI * uc.w;
    const float dru = sqrtf(uc.z);
    const float da = dru * cosf(dphi) * defr;
    const float db = dru * sinf(dphi) * defr;
    float ox = lfx + da * ubx + db * vbx;
    float oy = lfy + da * uby + db * vby;
    float oz = lfz + da * ubz + db * vbz;
    float dx = px - ox, dy = py - oy, dz = pz - oz;
    float tx = 1.0f, ty = 1.0f, tz = 1.0f;

    for (int bounce = 0;; ++bounce) {
      // --- closest sphere: expanded quadratic, lowest row wins ties ---------
      const float a_q = dx * dx + dy * dy + dz * dz;
      const float d_dot_o = dx * ox + dy * oy + dz * oz;
      const float o_sq = ox * ox + oy * oy + oz * oz;
      const float inv_a = 1.0f / a_q;
      float best = BIG;
      int win = -1;
      closest_sphere(s_cx, s_cy, s_cz, s_csr, s_act, n, 0, ox, oy, oz, dx, dy,
                     dz, a_q, d_dot_o, o_sq, inv_a, t_min, best, win);

      const float dlen = fmaxf(sqrtf(a_q), 1e-20f);
      const bool acc_row = !RECORD || bounce >= accum_from;
      if (win < 0) {
        // Miss: default sky gradient on the unit direction; the path ends.
        if (RADIANCE && acc_row) {
          const float sky_a = 0.5f * (dy / dlen + 1.0f);
          const float one_m_a = 1.0f - sky_a;
          ax = ax + tx * (one_m_a + sky_a * 0.5f);
          ay = ay + ty * (one_m_a + sky_a * 0.7f);
          az = az + tz * (one_m_a + sky_a);
        }
        if (RECORD) rec[(size_t)(rows++) * r + lane] = F_ALIVE;
        break;
      }
      const float* row = table + (size_t)win * C_IN;

      // --- shading point + outward normal -----------------------------------
      const float hx = ox + best * dx;
      const float hy = oy + best * dy;
      const float hz = oz + best * dz;
      const float inv_r = 1.0f / fmaxf(row[3], 1e-20f);
      float nx = (hx - row[0]) * inv_r;
      float ny = (hy - row[1]) * inv_r;
      float nz = (hz - row[2]) * inv_r;
      const bool front = dx * nx + dy * ny + dz * nz < 0.0f;
      const float sgn = front ? 1.0f : -1.0f;
      nx = nx * sgn;
      ny = ny * sgn;
      nz = nz * sgn;

      // --- emission + albedo: solid or 3-D checker of solids ----------------
      float alr = 0.0f, alg = 0.0f, alb = 0.0f;
      if (RADIANCE) {
        if (acc_row) {
          ax = ax + tx * row[10];
          ay = ay + ty * row[11];
          az = az + tz * row[12];
        }
        const float inv_scale = row[17];
        const int xf = (int)floorf(inv_scale * hx);
        const int yf = (int)floorf(inv_scale * hy);
        const int zf = (int)floorf(inv_scale * hz);
        // C's '%' truncates, but "== 0" gives the same even/odd answer.
        const bool is_even = (xf + yf + zf) % 2 == 0;
        if (row[13] == TEX_CHECKER) {
          alr = is_even ? row[18] : row[21];
          alg = is_even ? row[19] : row[22];
          alb = is_even ? row[20] : row[23];
        } else {
          alr = row[14];
          alg = row[15];
          alb = row[16];
        }
      }

      // --- scatter (models/materials.py) ------------------------------------
      const float mat_type = row[6];
      const U4 ub = uniform4(upix, (uint32_t)smp,
                             STREAM_BOUNCE_BASE + (uint32_t)bounce, seed);
      const float rz = 1.0f - 2.0f * ub.x;
      const float rr = sqrtf(fmaxf(0.0f, 1.0f - rz * rz));
      const float rphi = TWO_PI * ub.y;
      const float rx = rr * cosf(rphi);
      const float ry = rr * sinf(rphi);
      const float u_dec = ub.z;

      float ndx, ndy, ndz, atr, atg, atb;
      bool scattered;
      if (mat_type == DIELECTRIC) {
        // Snell + Schlick on the unit incoming direction.
        const float ior = row[8];
        const float udx = dx / dlen, udy = dy / dlen, udz = dz / dlen;
        const float ri = front ? 1.0f / fmaxf(ior, 1e-8f) : ior;
        const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
        const float sin_t = sqrtf(fmaxf(1.0e-12f, 1.0f - cos_t * cos_t));
        float r0 = (1.0f - ri) / (1.0f + ri);
        r0 = r0 * r0;
        const float one_m = 1.0f - cos_t;
        const float om2 = one_m * one_m;
        const float schlick = r0 + (1.0f - r0) * om2 * om2 * one_m;
        if ((ri * sin_t > 1.0f) || (schlick > u_dec)) {
          const float ud_dot_n = udx * nx + udy * ny + udz * nz;
          ndx = udx - 2.0f * ud_dot_n * nx;
          ndy = udy - 2.0f * ud_dot_n * ny;
          ndz = udz - 2.0f * ud_dot_n * nz;
        } else {
          const float ppx = ri * (udx + cos_t * nx);
          const float ppy = ri * (udy + cos_t * ny);
          const float ppz = ri * (udz + cos_t * nz);
          const float pp_sq = ppx * ppx + ppy * ppy + ppz * ppz;
          const float par = -sqrtf(fabsf(1.0f - pp_sq));
          ndx = ppx + par * nx;
          ndy = ppy + par * ny;
          ndz = ppz + par * nz;
        }
        atr = atg = atb = 1.0f;
        scattered = true;
      } else if (mat_type == METAL) {
        // reflect(d, n) normalized + fuzz * unit vector; dies below the surface.
        const float fuzz = row[7];
        const float d_dot_n = dx * nx + dy * ny + dz * nz;
        const float refx = dx - 2.0f * d_dot_n * nx;
        const float refy = dy - 2.0f * d_dot_n * ny;
        const float refz = dz - 2.0f * d_dot_n * nz;
        const float rlen =
            fmaxf(sqrtf(refx * refx + refy * refy + refz * refz), 1e-20f);
        ndx = refx / rlen + fuzz * rx;
        ndy = refy / rlen + fuzz * ry;
        ndz = refz / rlen + fuzz * rz;
        atr = alr;
        atg = alg;
        atb = alb;
        scattered = ndx * nx + ndy * ny + ndz * nz > 0.0f;
      } else {
        // Lambertian (and emissive, which never scatters).
        const float prob = row[9];
        ndx = nx + rx;
        ndy = ny + ry;
        ndz = nz + rz;
        if (fabsf(ndx) < 1e-8f && fabsf(ndy) < 1e-8f && fabsf(ndz) < 1e-8f) {
          ndx = nx;
          ndy = ny;
          ndz = nz;
        }
        const float inv_prob = 1.0f / fmaxf(prob, 1e-8f);
        atr = alr * inv_prob;
        atg = alg * inv_prob;
        atb = alb * inv_prob;
        scattered = (u_dec <= prob) && (mat_type != EMISSIVE);
      }

      if (RECORD) {
        // The record keeps every decision the replay re-reads, computed for
        // every material as the Pallas kernel computes them (megakernel.py
        // l.1450-1505): the dielectric reflect choice and the Lambertian
        // degeneracy on the row's own scalars, and which quadratic root the
        // winner used, from the per-winner (non-expanded) quadratic that the
        // replay re-solves.
        const float udx = dx / dlen, udy = dy / dlen, udz = dz / dlen;
        const float ior = row[8];
        const float ri = front ? 1.0f / fmaxf(ior, 1e-8f) : ior;
        const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
        const float sin_t = sqrtf(fmaxf(1.0e-12f, 1.0f - cos_t * cos_t));
        float r0 = (1.0f - ri) / (1.0f + ri);
        r0 = r0 * r0;
        const float one_m = 1.0f - cos_t;
        const float om2 = one_m * one_m;
        const float schlick = r0 + (1.0f - r0) * om2 * om2 * one_m;
        const bool refl = (ri * sin_t > 1.0f) || (schlick > u_dec);
        const bool degen = fabsf(nx + rx) < 1e-8f && fabsf(ny + ry) < 1e-8f &&
                           fabsf(nz + rz) < 1e-8f;
        const float r_ocx = row[0] - ox;
        const float r_ocy = row[1] - oy;
        const float r_ocz = row[2] - oz;
        const float r_h = dx * r_ocx + dy * r_ocy + dz * r_ocz;
        const float r_c =
            r_ocx * r_ocx + r_ocy * r_ocy + r_ocz * r_ocz - row[3] * row[3];
        const float r_disc = fmaxf(r_h * r_h - a_q * r_c, 0.0f);
        const float r_root0 = (r_h - sqrtf(r_disc)) * inv_a;
        const bool root1 = !(r_root0 > t_min);
        const int flags = F_ALIVE | F_HIT | (scattered ? F_SCAT : 0) |
                          (front ? F_FRONT : 0) | (refl ? F_REFL : 0) |
                          (degen ? F_DEGEN : 0) | (root1 ? F_ROOT1 : 0);
        rec[(size_t)(rows++) * r + lane] = win * REC_ID_SCALE + flags;
      }

      if (!(scattered && bounce + 1 < max_depth)) break;
      if (RADIANCE) {
        tx = tx * atr;
        ty = ty * atg;
        tz = tz * atb;
      }
      ox = hx;
      oy = hy;
      oz = hz;
      dx = ndx;
      dy = ndy;
      dz = ndz;
    }
  }

  if (RECORD) {
    // Rows after the path's end stay zero (F_ALIVE clear).
    for (; rows < max_depth; ++rows) rec[(size_t)rows * r + lane] = 0;
  }
  out[lane] = ax;
  out[(size_t)r + lane] = ay;
  out[2 * (size_t)r + lane] = az;
}

template <bool RECORD, bool RADIANCE>
int launch(const int32_t* smem, const int32_t* pix, const int32_t* sample0,
           const float* cam, const float* table, int n, int r, float t_min,
           float* out, int32_t* rec, void* stream) {
  const int smem_bytes = n * SMEM_COLS * (int)sizeof(float);
  if (smem_bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        megakernel<RECORD, RADIANCE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (r + BLOCK - 1) / BLOCK;
  if (grid > 0) {
    megakernel<RECORD, RADIANCE>
        <<<grid, BLOCK, smem_bytes, (cudaStream_t)stream>>>(
            smem, pix, sample0, cam, table, n, r, t_min, out, rec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the kernel needs for an N-row table.
int crucible_megakernel_smem_bytes(int n) {
  return n * SMEM_COLS * (int)sizeof(float);
}

// Launch the forward megakernel (K1) on `stream`; returns cudaGetLastError().
int crucible_megakernel_forward(const int32_t* smem, const int32_t* pix,
                                const int32_t* sample0, const float* cam,
                                const float* table, int n, int r, float t_min,
                                float* out, void* stream) {
  return launch<false, true>(smem, pix, sample0, cam, table, n, r, t_min, out,
                             nullptr, stream);
}

// Launch the record-mode megakernel (K2): `rec` (smem[3], R) int32 packed
// decision words; `out` (3, R) the fused radiance when `radiance` is nonzero,
// else zeros. Returns cudaGetLastError().
int crucible_megakernel_record(const int32_t* smem, const int32_t* pix,
                               const int32_t* sample0, const float* cam,
                               const float* table, int n, int r, float t_min,
                               int radiance, float* out, int32_t* rec,
                               void* stream) {
  if (radiance) {
    return launch<true, true>(smem, pix, sample0, cam, table, n, r, t_min, out,
                              rec, stream);
  }
  return launch<true, false>(smem, pix, sample0, cam, table, n, r, t_min, out,
                             rec, stream);
}

const char* crucible_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
