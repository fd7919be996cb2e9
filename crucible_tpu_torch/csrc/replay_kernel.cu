// Differentiable replay of recorded path decisions on Hopper: forward (K4),
// backward (K3), their channel-major pair (K4-legacy) and the fixed-order
// reduce of the backward's table cotangent.
//
// Replaces crucible_tpu/ops/pallas/replay_kernel.py, both layouts:
// - forward, _build_blk.fwd_call (pallas_call at replay_kernel.py:851,
//   _fwd_kernel_blk l.648): every lane walks its packed record rows
//   (models/replay.py F_* layout), fetches the winner's table row by index
//   and runs the bounce math of _bounce (l.130-276) with the recorded
//   decisions, summing radiance over rows >= accum_from;
// - backward, _build_blk.bwd_call (pallas_call at l.871, _bwd_kernel_blk
//   l.702): re-runs the forward while storing the carry (o, d, throughput)
//   each row enters with, then walks the rows in reverse through a
//   hand-written adjoint of _bounce, giving the per-lane cotangents of o
//   and d and the (N, 32) table cotangent summed over all lanes;
// - the unblocked pair of the same file (K4-legacy), _build.fwd_call
//   (pallas_call at l.516, _fwd_kernel l.321) and _build.bwd_call
//   (pallas_call at l.535, _bwd_kernel l.376): the same replay and adjoint
//   on channel-major rays, radiance and cotangents, (3, R), as the legacy
//   call passes them (opad.T / dpad.T). The TPU kernels differ only in
//   how their (1, TILE) rows fill vector registers, which has no meaning
//   here; the layout and the table-cotangent reduction do. The CM template
//   parameter selects the layout: each of the three channels is then read
//   (and written) as its own coalesced row, and the per-lane arithmetic,
//   so the radiance and the lane cotangents, is K4's and K3's bit for bit.
//   The legacy kernel's revisited output block (gtab_ref, l.490-497, summed
//   over the sequential TPU grid) becomes K3's fixed-order reduction of
//   per-block partials, so its table cotangent is K3's too, the same bits
//   launch after launch.
//
// What bounds them on this card. The bytes (records, rays, ids: ~80 B a
// lane plus 4 B a row) take a fraction of a millisecond at 3.35 TB/s for
// 8.3M lanes, and the FP32 operations (~100 a replayed row, ~300 an
// adjoint row) less. What the kernels wait on is latency: every row is a
// long dependent chain (IEEE divides, square roots, a sine and a cosine,
// no multiply-add under -fmad=false), so the card needs many warps in
// flight and every lane of each warp busy on a row.
//
// What the first design lost: K4 launched one block of 128 lanes per 128
// lanes, and each of its 64,800 blocks at 1080p staged the whole
// table (488 x 22 scattered loads, each with an integer divide and modulo)
// before any lane ran; then each lane walked its rows in a nested loop
// that waits at the warp's longest path. K3 ran a fixed grid of 264 blocks
// of 128 threads (8 warps an SM); merged the lanes of a warp that share a
// winner one lane after another (22 shuffles a lane); and added the warps'
// sums into a partial in global memory one warp after another, behind five
// block barriers a row.
//
// K4 now: persistent warps fed by a work counter, on the pattern of K1 /
// K2's brute_kernel. As many blocks as stay resident each stage the table
// once, one 128-byte table row per warp-wide coalesced load, a column's
// channel found by a compare, not a divide. A warp takes the next 32
// consecutive ray lanes with one atomicAdd; each lane finds its last alive
// row with eight independent loads at a time from the top, then replays its
// rows up to it; then the warp takes the next 32. A lane's radiance depends
// only on its own rows, taken in order, so whichever warp takes it, it gets
// the plain version's bits. The items are whole paths, not rows:
// brute_kernel's flat loop (a lane with no path in flight takes its next ray
// lane, one row an iteration) measured 28-32% slower here (0.94 against
// 0.68 ms at 1080p 4 spp d8, in turns on one NVIDIA H100 80GB HBM3 at
// 700 W): once lanes drift apart every record and ray read is its own
// sector, while a warp on 32 consecutive lanes reads them coalesced, and a
// replayed row is short beside the fetch's bookkeeping.
//
// K3 now: eight warps a block (256 threads), as many blocks as stay
// resident (two an SM at book1's 488 rows: 16 warps, against 8). The lanes
// are assigned statically, not by a work counter: block b walks the tiles
// b, b + grid, ... of 256 lanes, so every partial sum below is taken in an
// order fixed by the inputs and the launch shape alone, and two launches
// give the same bits without float atomics. Each tile's lanes are first
// sorted by their last alive row (a stable counting sort), so that each
// warp walks paths of about one length in both sweeps: the reverse sweep
// runs in step across the block (it merges row by row), and a warp whose
// paths end below the current row sits it out. Within a warp, the lanes that
// share a winner (__match_any_sync) sum their 22 channels in a tree over
// their ranks in the group, in log steps (pointer doubling: a lane adds the
// sum held by the member s ranks ahead, then jumps to that member's
// successor), stopping at the warp's largest group. Each group's sum is
// written by its lowest lane into the warp's list in shared memory; after
// one block barrier, warp w adds the listed entries whose row is w modulo
// 8, in warp order and, within a warp, in lane order, so every entry of the
// block's partial has one owner thread; a second barrier frees the lists.
// Two barriers a row, against five, and no serial merge. The partial lives
// in shared memory beside the staged table where both fit and that keeps as
// many blocks resident as a partial in global memory (book1's 488 rows: 43 KB
// beside the table's 45 KB, two blocks an SM either way); else it is the
// block's slice of `part` in global memory, as before.
// The carry each alive row enters with goes to a scratch buffer in global
// memory (depth x 9 floats per resident thread, coalesced; 19.5 MB at d8 for
// 264 blocks, within the 50 MB L2), as before. reduce_partials sums the
// partials in block order.
//
// Numerics: the forward follows _bounce operation for operation, with the
// eager twin in ops/kernels/replay_kernel.py rounding alike (build with
// -fmad=false, no fast math). The adjoint follows the gradient rules of the
// twin's torch ops: clamp_min/clamp_max pass the gradient at a tie
// (x >= lo, x <= hi), where jnp.maximum/minimum split it in halves; abs and
// where agree with jnp. Ties need exact equalities (a radius of 1e-20, a
// ray exactly along the normal), so the two differ only there.
//
// Interface: plain C entry points, bound from Python with ctypes. They
// launch on the caller's stream, allocate nothing (the wrapper passes the
// work counter and the scratch buffers) and return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace crucible;

constexpr int C_IN = 32;    // table columns (make_sphere_table layout)
constexpr int NU = 22;      // channels the bounce reads (USED)
constexpr int TS = 23;      // shared-memory row stride (odd: bank spread)
constexpr int NCARRY = 9;   // o, d, throughput
constexpr unsigned FULL = 0xffffffffu;
constexpr int FWD_BLOCK = 512;              // K4: threads per block
constexpr int BWD_BLOCK = 256;              // K3: threads per block
constexpr int BWD_WARPS = BWD_BLOCK / 32;   // 8
constexpr int LS = 23;      // a list entry's stride (odd: leaders spread over banks)
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block can use (227 KB)
constexpr int SORT_KEYS = 64;     // K3's tile sort: keys (rows from the bottom)
static_assert(SORT_KEYS * BWD_WARPS + 2 * BWD_BLOCK <= BWD_WARPS * 32 * LS,
              "the tile sort fits in the lists' space");

// Channel j of a staged row holds table column USED[j] (replay_kernel.py
// USED: 0-3, 6-23); channel_of inverts it.
constexpr int J_CX = 0, J_CY = 1, J_CZ = 2, J_R = 3, J_MAT = 4, J_FUZZ = 5,
              J_IOR = 6, J_PROB = 7, J_EM = 8, J_KIND = 11, J_COLOR = 12,
              J_INVS = 15, J_EVEN = 16, J_ODD = 19;

// The staged channel of table column `col` (USED inverted), -1 if unread.
__device__ __forceinline__ int channel_of(int col) {
  return col < 4 ? col : (col >= 6 && col < 24 ? col - 2 : -1);
}

// Stage the N rows' USED channels at stride TS: a warp reads one 128-byte
// table row per step, coalesced.
__device__ __forceinline__ void stage_table(const float* __restrict__ table,
                                            int n, float* s_tab) {
  for (int k = threadIdx.x; k < n * C_IN; k += blockDim.x) {
    const int j = channel_of(k & (C_IN - 1));
    if (j >= 0) s_tab[(k >> 5) * TS + j] = table[k];
  }
}

struct Carry {
  float ox, oy, oz, dx, dy, dz, tx, ty, tz;
};

struct Dec {
  int idx;
  bool alive, hit, cont, front, refl, degen, root1;
};

__device__ __forceinline__ Dec decode(int32_t w) {
  Dec d;
  d.idx = (int)((uint32_t)w >> 8);
  d.alive = (w & F_ALIVE) != 0;
  d.hit = (w & F_HIT) != 0;
  d.cont = (w & F_SCAT) != 0;
  d.front = (w & F_FRONT) != 0;
  d.refl = (w & F_REFL) != 0;
  d.degen = (w & F_DEGEN) != 0;
  d.root1 = (w & F_ROOT1) != 0;
  return d;
}

// Offset of channel c of lane `lane` in an R-lane float triple: lane-major
// (R, 3), or channel-major (3, R) when CM (the legacy layout).
template <bool CM>
__device__ __forceinline__ size_t at3(int lane, int c, int r) {
  return CM ? (size_t)c * r + lane : (size_t)lane * 3 + c;
}

template <bool CM>
__device__ __forceinline__ Carry load_carry(const float* __restrict__ o,
                                            const float* __restrict__ d,
                                            const int32_t* __restrict__ valid,
                                            int lane, int r) {
  const float thr = valid[lane] > 0 ? 1.0f : 0.0f;
  return Carry{o[at3<CM>(lane, 0, r)], o[at3<CM>(lane, 1, r)],
               o[at3<CM>(lane, 2, r)], d[at3<CM>(lane, 0, r)],
               d[at3<CM>(lane, 1, r)], d[at3<CM>(lane, 2, r)],
               thr, thr, thr};
}

template <bool CM>
__device__ __forceinline__ void store3(float* __restrict__ out, int lane, int r,
                                       float x, float y, float z) {
  out[at3<CM>(lane, 0, r)] = x;
  out[at3<CM>(lane, 1, r)] = y;
  out[at3<CM>(lane, 2, r)] = z;
}

// Albedo at the hit: solid, or 3-D checker of solids (no gradient through
// the parity: floor is flat).
__device__ __forceinline__ const float* albedo_of(const float* ch, float hx,
                                                  float hy, float hz) {
  if (ch[J_KIND] == TEX_CHECKER) {
    const float inv_scale = ch[J_INVS];
    const int xf = (int)floorf(inv_scale * hx);
    const int yf = (int)floorf(inv_scale * hy);
    const int zf = (int)floorf(inv_scale * hz);
    // C's '%' truncates, but "== 0" gives the same even/odd answer.
    return (xf + yf + zf) % 2 == 0 ? ch + J_EVEN : ch + J_ODD;
  }
  return ch + J_COLOR;
}

// One replay bounce (replay_kernel.py::_bounce with a live row): updates
// the carry in place and returns the radiance increment (zero unless `acc`).
__device__ __forceinline__ void bounce_fwd(Carry& c, const float* ch,
                                           const Dec& dec, float u1, float u2,
                                           float ud, bool acc, float& dr,
                                           float& dg, float& db) {
  // Winner quadratic -> recorded root.
  const float cwx = ch[J_CX], cwy = ch[J_CY], cwz = ch[J_CZ], rw = ch[J_R];
  const float a_q = c.dx * c.dx + c.dy * c.dy + c.dz * c.dz;
  const float ocx = cwx - c.ox, ocy = cwy - c.oy, ocz = cwz - c.oz;
  const float h_q = c.dx * ocx + c.dy * ocy + c.dz * ocz;
  const float c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - rw * rw;
  const float disc = h_q * h_q - a_q * c_q;
  const float sqrtd = disc > 0.0f ? sqrtf(disc) : 0.0f;
  const float t_sph = (h_q + (dec.root1 ? sqrtd : -sqrtd)) / a_q;
  const float t_sh = dec.hit ? t_sph : 1.0f;
  const float hx = c.ox + t_sh * c.dx;
  const float hy = c.oy + t_sh * c.dy;
  const float hz = c.oz + t_sh * c.dz;
  const float rmax = fmaxf(rw, 1e-20f);
  float nx = (hx - cwx) / rmax, ny = (hy - cwy) / rmax, nz = (hz - cwz) / rmax;
  if (!dec.front) {
    nx = -nx;
    ny = -ny;
    nz = -nz;
  }
  const float dlen = fmaxf(sqrtf(a_q), 1e-20f);
  const float udx = c.dx / dlen, udy = c.dy / dlen, udz = c.dz / dlen;

  dr = dg = db = 0.0f;
  if (acc) {
    // Default-gradient sky on a miss, emission on a hit.
    float cr, cg, cb;
    if (dec.hit) {
      cr = ch[J_EM];
      cg = ch[J_EM + 1];
      cb = ch[J_EM + 2];
    } else {
      const float a_sky = 0.5f * (udy + 1.0f);
      const float one_m = 1.0f - a_sky;
      cr = one_m + a_sky * 0.5f;
      cg = one_m + a_sky * 0.7f;
      cb = one_m + a_sky;
    }
    dr = c.tx * cr;
    dg = c.ty * cg;
    db = c.tz * cb;
  }
  if (!dec.cont) return;  // the carry passes through unchanged

  const float* al = albedo_of(ch, hx, hy, hz);
  const float rz = 1.0f - 2.0f * u1;
  const float rr = sqrtf(fmaxf(0.0f, 1.0f - rz * rz));
  const float rphi = TWO_PI * u2;
  const float rux = rr * cosf(rphi), ruy = rr * sinf(rphi), ruz = rz;

  const float mat = ch[J_MAT];
  float ndx, ndy, ndz, atr, atg, atb;
  if (mat == DIELECTRIC) {
    const float ior = ch[J_IOR];
    const float ri = dec.front ? 1.0f / ior : ior;
    const float ud_dot_n = udx * nx + udy * ny + udz * nz;
    if (dec.refl) {
      const float k2 = 2.0f * ud_dot_n;
      ndx = udx - k2 * nx;
      ndy = udy - k2 * ny;
      ndz = udz - k2 * nz;
    } else {
      const float cos_t = fminf(-ud_dot_n, 1.0f);
      const float ppx = ri * (udx + cos_t * nx);
      const float ppy = ri * (udy + cos_t * ny);
      const float ppz = ri * (udz + cos_t * nz);
      const float pp_sq = (ppx * ppx + ppy * ppy) + ppz * ppz;
      const float par = -sqrtf(fmaxf(fabsf(1.0f - pp_sq), 1e-12f));
      ndx = ppx + par * nx;
      ndy = ppy + par * ny;
      ndz = ppz + par * nz;
    }
    atr = atg = atb = 1.0f;
  } else if (mat == METAL) {
    const float fuzz = ch[J_FUZZ];
    const float k = 2.0f * (c.dx * nx + c.dy * ny + c.dz * nz);
    const float refx = c.dx - k * nx;
    const float refy = c.dy - k * ny;
    const float refz = c.dz - k * nz;
    const float rlen =
        fmaxf(sqrtf((refx * refx + refy * refy) + refz * refz), 1e-20f);
    ndx = refx / rlen + fuzz * rux;
    ndy = refy / rlen + fuzz * ruy;
    ndz = refz / rlen + fuzz * ruz;
    atr = al[0];
    atg = al[1];
    atb = al[2];
  } else {
    if (dec.degen) {
      ndx = nx;
      ndy = ny;
      ndz = nz;
    } else {
      ndx = nx + rux;
      ndy = ny + ruy;
      ndz = nz + ruz;
    }
    const float pmax = fmaxf(ch[J_PROB], 1e-8f);
    atr = al[0] / pmax;
    atg = al[1] / pmax;
    atb = al[2] / pmax;
  }
  c.tx = c.tx * atr;
  c.ty = c.ty * atg;
  c.tz = c.tz * atb;
  c.ox = hx;
  c.oy = hy;
  c.oz = hz;
  c.dx = ndx;
  c.dy = ndy;
  c.dz = ndz;
}

__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return ax * bx + ay * by + az * bz;
}

// Adjoint of bounce_fwd on a live row. `c` is the carry the row entered
// with; `g` holds the cotangent of the carry it leaves with and is replaced
// by the cotangent of `c`; (grr, grg, grb) is the radiance cotangent, used
// when `acc`. Writes the cotangents of the row's NU channels to `gch`.
__device__ __forceinline__ void bounce_bwd(const Carry& c, const float* ch,
                                           const Dec& dec, float u1, float u2,
                                           float ud, bool acc, float grr,
                                           float grg, float grb, Carry& g,
                                           float* gch) {
#pragma unroll
  for (int j = 0; j < NU; ++j) gch[j] = 0.0f;

  // --- forward values ------------------------------------------------------
  const float cwx = ch[J_CX], cwy = ch[J_CY], cwz = ch[J_CZ], rw = ch[J_R];
  const float a_q = c.dx * c.dx + c.dy * c.dy + c.dz * c.dz;
  const float ocx = cwx - c.ox, ocy = cwy - c.oy, ocz = cwz - c.oz;
  const float h_q = c.dx * ocx + c.dy * ocy + c.dz * ocz;
  const float c_q = (ocx * ocx + ocy * ocy + ocz * ocz) - rw * rw;
  const float disc = h_q * h_q - a_q * c_q;
  const bool pos = disc > 0.0f;
  const float sqrtd = pos ? sqrtf(disc) : 0.0f;
  const float t_sph = (h_q + (dec.root1 ? sqrtd : -sqrtd)) / a_q;
  const float t_sh = dec.hit ? t_sph : 1.0f;
  const float hx = c.ox + t_sh * c.dx;
  const float hy = c.oy + t_sh * c.dy;
  const float hz = c.oz + t_sh * c.dz;
  const float rmax = fmaxf(rw, 1e-20f);
  const float nsx = (hx - cwx) / rmax, nsy = (hy - cwy) / rmax,
              nsz = (hz - cwz) / rmax;
  const float sgn = dec.front ? 1.0f : -1.0f;
  const float nx = sgn * nsx, ny = sgn * nsy, nz = sgn * nsz;
  const float len = sqrtf(a_q);
  const float dlen = fmaxf(len, 1e-20f);
  const float udx = c.dx / dlen, udy = c.dy / dlen, udz = c.dz / dlen;

  // Cotangents of the intermediates, accumulated as the sweep goes back.
  float g_ox = 0.0f, g_oy = 0.0f, g_oz = 0.0f;
  float g_dx = 0.0f, g_dy = 0.0f, g_dz = 0.0f;
  float g_tx = 0.0f, g_ty = 0.0f, g_tz = 0.0f;
  float g_udx = 0.0f, g_udy = 0.0f, g_udz = 0.0f;
  float g_hx = 0.0f, g_hy = 0.0f, g_hz = 0.0f;
  float g_nx = 0.0f, g_ny = 0.0f, g_nz = 0.0f;

  // --- radiance: dr = tx * c_r -----------------------------------------------
  if (acc) {
    if (dec.hit) {
      g_tx = grr * ch[J_EM];
      g_ty = grg * ch[J_EM + 1];
      g_tz = grb * ch[J_EM + 2];
      gch[J_EM] = grr * c.tx;
      gch[J_EM + 1] = grg * c.ty;
      gch[J_EM + 2] = grb * c.tz;
    } else {
      const float a_sky = 0.5f * (udy + 1.0f);
      const float one_m = 1.0f - a_sky;
      g_tx = grr * (one_m + a_sky * 0.5f);
      g_ty = grg * (one_m + a_sky * 0.7f);
      g_tz = grb * (one_m + a_sky);
      const float gcr = grr * c.tx, gcg = grg * c.ty, gcb = grb * c.tz;
      const float g_one_m = gcr + gcg + gcb;
      const float g_a_sky = gcr * 0.5f + gcg * 0.7f + gcb - g_one_m;
      g_udy = 0.5f * g_a_sky;
    }
  }

  if (!dec.cont) {
    // The carry passed through: its cotangent does too.
    g_ox = g.ox;
    g_oy = g.oy;
    g_oz = g.oz;
    g_dx = g.dx;
    g_dy = g.dy;
    g_dz = g.dz;
    g_tx += g.tx;
    g_ty += g.ty;
    g_tz += g.tz;
  } else {
    // --- forward values of the scatter ---------------------------------------
    const float* al = albedo_of(ch, hx, hy, hz);
    float g_al[3] = {0.0f, 0.0f, 0.0f};  // cotangent of the albedo
    const float rz = 1.0f - 2.0f * u1;
    const float rr = sqrtf(fmaxf(0.0f, 1.0f - rz * rz));
    const float rphi = TWO_PI * u2;
    const float rux = rr * cosf(rphi), ruy = rr * sinf(rphi), ruz = rz;
    const float mat = ch[J_MAT];

    // t' = t * at, o' = h, d' = nd.
    g_hx = g.ox;
    g_hy = g.oy;
    g_hz = g.oz;
    const float g_ndx = g.dx, g_ndy = g.dy, g_ndz = g.dz;

    if (mat == DIELECTRIC) {
      g_tx += g.tx;  // at = 1
      g_ty += g.ty;
      g_tz += g.tz;
      const float ior = ch[J_IOR];
      const float ri = dec.front ? 1.0f / ior : ior;
      const float udn = udx * nx + udy * ny + udz * nz;
      float g_udn = 0.0f;
      if (dec.refl) {
        // nd = ud - (2 udn) n
        const float k2 = 2.0f * udn;
        g_udx += g_ndx;
        g_udy += g_ndy;
        g_udz += g_ndz;
        g_nx += -k2 * g_ndx;
        g_ny += -k2 * g_ndy;
        g_nz += -k2 * g_ndz;
        g_udn += 2.0f * -dot3(g_ndx, g_ndy, g_ndz, nx, ny, nz);
      } else {
        // nd = pp + par n, pp = ri (ud + cos_t n),
        // par = -sqrt(max(|1 - |pp|^2|, 1e-12)), cos_t = min(-udn, 1)
        const float cos_t = fminf(-udn, 1.0f);
        const float qx = udx + cos_t * nx, qy = udy + cos_t * ny,
                    qz = udz + cos_t * nz;
        const float ppx = ri * qx, ppy = ri * qy, ppz = ri * qz;
        const float pp_sq = (ppx * ppx + ppy * ppy) + ppz * ppz;
        const float w1 = 1.0f - pp_sq;
        const float aw = fabsf(w1);
        const float sq = sqrtf(fmaxf(aw, 1e-12f));
        const float par = -sq;
        float g_ppx = g_ndx, g_ppy = g_ndy, g_ppz = g_ndz;
        const float g_par = dot3(g_ndx, g_ndy, g_ndz, nx, ny, nz);
        g_nx += par * g_ndx;
        g_ny += par * g_ndy;
        g_nz += par * g_ndz;
        const float g_mw = -g_par / (2.0f * sq);
        const float g_aw = aw >= 1e-12f ? g_mw : 0.0f;
        const float g_w1 = w1 > 0.0f ? g_aw : (w1 < 0.0f ? -g_aw : 0.0f);
        const float g_ppsq = -g_w1;
        g_ppx += 2.0f * ppx * g_ppsq;
        g_ppy += 2.0f * ppy * g_ppsq;
        g_ppz += 2.0f * ppz * g_ppsq;
        const float g_ri = dot3(g_ppx, g_ppy, g_ppz, qx, qy, qz);
        const float g_qx = ri * g_ppx, g_qy = ri * g_ppy, g_qz = ri * g_ppz;
        g_udx += g_qx;
        g_udy += g_qy;
        g_udz += g_qz;
        g_nx += cos_t * g_qx;
        g_ny += cos_t * g_qy;
        g_nz += cos_t * g_qz;
        const float g_cos = dot3(g_qx, g_qy, g_qz, nx, ny, nz);
        if (-udn <= 1.0f) g_udn += -g_cos;
        gch[J_IOR] = dec.front ? -g_ri * (ri * ri) : g_ri;
      }
      // udn = ud . n
      g_udx += g_udn * nx;
      g_udy += g_udn * ny;
      g_udz += g_udn * nz;
      g_nx += g_udn * udx;
      g_ny += g_udn * udy;
      g_nz += g_udn * udz;
    } else if (mat == METAL) {
      // at = albedo
      g_tx += g.tx * al[0];
      g_ty += g.ty * al[1];
      g_tz += g.tz * al[2];
      g_al[0] = g.tx * c.tx;
      g_al[1] = g.ty * c.ty;
      g_al[2] = g.tz * c.tz;
      // nd = ref / rlen + fuzz ru, ref = d - (2 d.n) n
      const float k = 2.0f * (c.dx * nx + c.dy * ny + c.dz * nz);
      const float refx = c.dx - k * nx, refy = c.dy - k * ny,
                  refz = c.dz - k * nz;
      const float rl = sqrtf((refx * refx + refy * refy) + refz * refz);
      const float rlen = fmaxf(rl, 1e-20f);
      gch[J_FUZZ] = dot3(g_ndx, g_ndy, g_ndz, rux, ruy, ruz);
      float g_refx = g_ndx / rlen, g_refy = g_ndy / rlen, g_refz = g_ndz / rlen;
      const float g_rlen = -(g_ndx * ((refx / rlen) / rlen) +
                             g_ndy * ((refy / rlen) / rlen) +
                             g_ndz * ((refz / rlen) / rlen));
      const float g_rl = rl >= 1e-20f ? g_rlen : 0.0f;
      const float g_rsq = g_rl / (2.0f * rl);
      g_refx += 2.0f * refx * g_rsq;
      g_refy += 2.0f * refy * g_rsq;
      g_refz += 2.0f * refz * g_rsq;
      g_dx += g_refx;
      g_dy += g_refy;
      g_dz += g_refz;
      g_nx += -k * g_refx;
      g_ny += -k * g_refy;
      g_nz += -k * g_refz;
      const float g_ddn = 2.0f * -dot3(g_refx, g_refy, g_refz, nx, ny, nz);
      g_dx += g_ddn * nx;
      g_dy += g_ddn * ny;
      g_dz += g_ddn * nz;
      g_nx += g_ddn * c.dx;
      g_ny += g_ddn * c.dy;
      g_nz += g_ddn * c.dz;
    } else {
      // Lambertian: nd = n (+ ru), at = albedo / max(prob, 1e-8)
      g_nx += g_ndx;
      g_ny += g_ndy;
      g_nz += g_ndz;
      const float prob = ch[J_PROB];
      const float pmax = fmaxf(prob, 1e-8f);
      const float atr = al[0] / pmax, atg = al[1] / pmax, atb = al[2] / pmax;
      g_tx += g.tx * atr;
      g_ty += g.ty * atg;
      g_tz += g.tz * atb;
      const float g_atr = g.tx * c.tx, g_atg = g.ty * c.ty, g_atb = g.tz * c.tz;
      g_al[0] = g_atr / pmax;
      g_al[1] = g_atg / pmax;
      g_al[2] = g_atb / pmax;
      const float g_pmax = -(g_atr * (atr / pmax) + g_atg * (atg / pmax) +
                             g_atb * (atb / pmax));
      gch[J_PROB] = prob >= 1e-8f ? g_pmax : 0.0f;
    }

    // The albedo is one of three channel triples; constant indices keep
    // gch in registers.
    const bool is_color = al == ch + J_COLOR, is_even = al == ch + J_EVEN;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      gch[J_COLOR + k] = is_color ? g_al[k] : 0.0f;
      gch[J_EVEN + k] = is_even ? g_al[k] : 0.0f;
      gch[J_ODD + k] = !is_color && !is_even ? g_al[k] : 0.0f;
    }

    // n = sgn * ns, ns = (h - cw) / rmax
    const float g_nsx = sgn * g_nx, g_nsy = sgn * g_ny, g_nsz = sgn * g_nz;
    g_hx += g_nsx / rmax;
    g_hy += g_nsy / rmax;
    g_hz += g_nsz / rmax;
    gch[J_CX] -= g_nsx / rmax;
    gch[J_CY] -= g_nsy / rmax;
    gch[J_CZ] -= g_nsz / rmax;
    const float g_rmax =
        -(g_nsx * (nsx / rmax) + g_nsy * (nsy / rmax) + g_nsz * (nsz / rmax));
    if (rw >= 1e-20f) gch[J_R] += g_rmax;

    // h = o + t_sh d
    g_ox += g_hx;
    g_oy += g_hy;
    g_oz += g_hz;
    g_dx += t_sh * g_hx;
    g_dy += t_sh * g_hy;
    g_dz += t_sh * g_hz;
    float g_aq = 0.0f;
    if (dec.hit) {
      const float g_tsph = dot3(g_hx, g_hy, g_hz, c.dx, c.dy, c.dz);
      // t_sph = (h_q +- sqrtd) / a_q
      const float g_num = g_tsph / a_q;
      g_aq += -g_tsph * (t_sph / a_q);
      float g_hq = g_num;
      const float g_sqrtd = dec.root1 ? g_num : -g_num;
      const float g_disc = pos ? g_sqrtd / (2.0f * sqrtd) : 0.0f;
      // disc = h_q^2 - a_q c_q, c_q = |oc|^2 - rw^2
      g_hq += 2.0f * h_q * g_disc;
      g_aq += -c_q * g_disc;
      const float g_cq = -a_q * g_disc;
      gch[J_R] += -2.0f * rw * g_cq;
      float g_ocx = 2.0f * ocx * g_cq, g_ocy = 2.0f * ocy * g_cq,
            g_ocz = 2.0f * ocz * g_cq;
      // h_q = d . oc
      g_dx += g_hq * ocx;
      g_dy += g_hq * ocy;
      g_dz += g_hq * ocz;
      g_ocx += g_hq * c.dx;
      g_ocy += g_hq * c.dy;
      g_ocz += g_hq * c.dz;
      // oc = cw - o
      gch[J_CX] += g_ocx;
      gch[J_CY] += g_ocy;
      gch[J_CZ] += g_ocz;
      g_ox -= g_ocx;
      g_oy -= g_ocy;
      g_oz -= g_ocz;
    }
    // ud = d / dlen, dlen = max(sqrt(a_q), 1e-20)
    g_dx += g_udx / dlen;
    g_dy += g_udy / dlen;
    g_dz += g_udz / dlen;
    const float g_dlen =
        -(g_udx * (udx / dlen) + g_udy * (udy / dlen) + g_udz * (udz / dlen));
    if (len >= 1e-20f) g_aq += g_dlen / (2.0f * len);
    // a_q = d . d
    g_dx += 2.0f * c.dx * g_aq;
    g_dy += 2.0f * c.dy * g_aq;
    g_dz += 2.0f * c.dz * g_aq;
    g.ox = g_ox;
    g.oy = g_oy;
    g.oz = g_oz;
    g.dx = g_dx;
    g.dy = g_dy;
    g.dz = g_dz;
    g.tx = g_tx;
    g.ty = g_ty;
    g.tz = g_tz;
    return;
  }

  // Not continued: only the sky term reaches d (through ud).
  if (acc && !dec.hit) {
    g_dy += g_udy / dlen;
    const float g_dlen = -(g_udy * (udy / dlen));
    if (len >= 1e-20f) {
      const float g_aq = g_dlen / (2.0f * len);
      g_dx += 2.0f * c.dx * g_aq;
      g_dy += 2.0f * c.dy * g_aq;
      g_dz += 2.0f * c.dz * g_aq;
    }
  }
  g.ox = g_ox;
  g.oy = g_oy;
  g.oz = g_oz;
  g.dx = g_dx;
  g.dy = g_dy;
  g.dz = g_dz;
  g.tx = g_tx;
  g.ty = g_ty;
  g.tz = g_tz;
}

// The last row of `lane` whose F_ALIVE bit is set, -1 if none: eight
// independent loads at a time, from the top row down.
__device__ __forceinline__ int last_alive(const int32_t* __restrict__ rec,
                                          int lane, int r, int depth) {
  for (int top = depth - 1; top >= 0; top -= 8) {
    int32_t w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      w[q] = top - q >= 0 ? rec[(size_t)(top - q) * r + lane] : 0;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (w[q] & F_ALIVE) return top - q;
    }
  }
  return -1;
}

// K4 (CM false: rays and radiance (R, 3)) and K4-legacy's forward (CM true:
// (3, R)). Persistent warps (see the note at the top): a warp takes the next
// 32 consecutive ray lanes from the work counter `next` (one atomicAdd), and
// each of its lanes replays its own rows up to its last alive row; then the
// warp takes the next 32. The launch zeroes the counter.
template <bool CM>
__global__ void __launch_bounds__(FWD_BLOCK) replay_forward(
    const float* __restrict__ table,    // (N, 32)
    const float* __restrict__ o,        // (R, 3) or (3, R)
    const float* __restrict__ d,        // (R, 3) or (3, R)
    const int32_t* __restrict__ valid,  // (R,) initial-throughput mask
    const int32_t* __restrict__ pix,    // (R,) pixel ids
    const int32_t* __restrict__ smp,    // (R,) sample ids
    const int32_t* __restrict__ rec,    // (depth, R) packed records
    int n, int r, int depth, int accum_from, uint32_t seed,
    int32_t* __restrict__ next,         // work counter
    float* __restrict__ rad) {          // (R, 3) or (3, R) out
  extern __shared__ float s_tab[];
  stage_table(table, n, s_tab);
  __syncthreads();
  const int wl = (int)(threadIdx.x & 31);
  for (;;) {
    int base = 0;
    if (wl == 0) base = atomicAdd(next, 32);
    base = __shfl_sync(FULL, base, 0);
    if (base >= r) break;  // warp-uniform
    const int lane = base + wl;
    if (lane < r) {
      const int last = last_alive(rec, lane, r, depth);
      Carry c = load_carry<CM>(o, d, valid, lane, r);
      const uint32_t up = (uint32_t)pix[lane], us = (uint32_t)smp[lane];
      float ar = 0.0f, ag = 0.0f, ab = 0.0f;
      for (int it = 0; it <= last; ++it) {
        const Dec dec = decode(rec[(size_t)it * r + lane]);
        if (!dec.alive) continue;
        const U4 u = uniform4(up, us, STREAM_BOUNCE_BASE + (uint32_t)it, seed);
        const bool acc = it >= accum_from;
        float dr, dg, db;
        bounce_fwd(c, s_tab + dec.idx * TS, dec, u.x, u.y, u.z, acc, dr, dg, db);
        if (acc) {
          ar = ar + dr;
          ag = ag + dg;
          ab = ab + db;
        }
      }
      store3<CM>(rad, lane, r, ar, ag, ab);
    }
  }
}

// K3 (CM false: rays, their cotangents and the radiance cotangent (R, 3))
// and K4-legacy's backward (CM true: (3, R)). SHARED_PART: the block's
// table-cotangent partial lives in shared memory (copied to its slice of
// `part` at the end), else in that slice of `part` itself.
//
// Lanes are assigned statically (block b takes the tiles b, b + grid, ...
// of BWD_BLOCK lanes; thread t of a tile its lane t), not fetched from a
// work counter: the order in which the table cotangent's terms are added
// then depends on the inputs and the grid alone, so two launches on the
// same inputs give the same bits.
template <bool CM, bool SHARED_PART>
__global__ void __launch_bounds__(BWD_BLOCK, 2) replay_backward(
    const float* __restrict__ table,
    const float* __restrict__ o,
    const float* __restrict__ d,
    const int32_t* __restrict__ valid,
    const int32_t* __restrict__ pix,
    const int32_t* __restrict__ smp,
    const int32_t* __restrict__ rec,
    const float* __restrict__ g_rad,   // (R, 3) or (3, R) radiance cotangent
    int n, int r, int depth, int accum_from, uint32_t seed,
    float* __restrict__ ck,            // (depth, 9, gridDim.x * BWD_BLOCK) scratch
    float* __restrict__ part,          // (gridDim.x, n * NU) block partials
    float* __restrict__ g_o,           // (R, 3) or (3, R) out
    float* __restrict__ g_d) {         // (R, 3) or (3, R) out
  extern __shared__ float smem[];
  float* s_tab = smem;                                   // (n, TS) winner channels
  float* s_list = s_tab + n * TS;                        // (warps, 32, LS) group sums
  int* s_key = (int*)(s_list + BWD_WARPS * 32 * LS);     // (warps, 32) their rows
  int* s_cnt = s_key + BWD_WARPS * 32;                   // (warps,) entries listed
  // The tile sort's counts, order and last rows share the lists' space.
  int* s_hist = (int*)s_list;                            // (SORT_KEYS, warps)
  int* s_perm = s_hist + SORT_KEYS * BWD_WARPS;          // (BWD_BLOCK,) lanes
  int* s_plast = s_perm + BWD_BLOCK;                     // (BWD_BLOCK,) their last rows
  // This block's table cotangent (n, NU), read and written by it alone.
  float* b_part = SHARED_PART ? (float*)(s_cnt + BWD_WARPS)
                              : part + (size_t)blockIdx.x * n * NU;
  stage_table(table, n, s_tab);
  for (int k = threadIdx.x; k < n * NU; k += BWD_BLOCK) b_part[k] = 0.0f;
  __syncthreads();

  const int nthreads = gridDim.x * BWD_BLOCK;
  const int tid = blockIdx.x * BWD_BLOCK + threadIdx.x;
  const int wl = (int)(threadIdx.x & 31), warp = (int)(threadIdx.x >> 5);
  const unsigned below = (1u << wl) - 1u;
  const unsigned after = ~((2u << wl) - 1u);  // the warp's lanes after this one
  const int n_tiles = (r + BWD_BLOCK - 1) / BWD_BLOCK;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // Phase 0: the tile's lanes in order of their last alive row, longest
    // first (a stable counting sort over SORT_KEYS keys, ties in lane
    // order; lanes deeper than SORT_KEYS rows from the bottom share the last
    // key), so that each warp walks paths of about one length and the warps
    // whose paths have ended sit out the rows above them.
    int blast = -1;  // the tile's last alive row: the reverse sweep starts there
    {
      const int mine = tile * BWD_BLOCK + threadIdx.x;
      const int mlast = mine < r ? last_alive(rec, mine, r, depth) : -1;
      const int key = min(depth - 1 - mlast, SORT_KEYS - 1);
      for (int k = threadIdx.x; k < SORT_KEYS * BWD_WARPS; k += BWD_BLOCK) s_hist[k] = 0;
      const int wmax = __reduce_max_sync(FULL, mlast);
      if (wl == 0) s_cnt[warp] = wmax;
      __syncthreads();
#pragma unroll
      for (int w = 0; w < BWD_WARPS; ++w) blast = max(blast, s_cnt[w]);
      const unsigned same = __match_any_sync(FULL, key);
      const int wrank = __popc(same & below);
      if (wrank == 0) s_hist[key * BWD_WARPS + warp] = __popc(same);
      __syncthreads();
      if (warp == 0) {  // exclusive scan in (key, warp) order
        int base = 0;
        for (int k0 = 0; k0 < SORT_KEYS * BWD_WARPS; k0 += 32) {
          const int v = s_hist[k0 + wl];
          int incl = v;
#pragma unroll
          for (int s = 1; s < 32; s <<= 1) {
            const int t = __shfl_up_sync(FULL, incl, s);
            if (wl >= s) incl += t;
          }
          s_hist[k0 + wl] = base + incl - v;
          base += __shfl_sync(FULL, incl, 31);
        }
      }
      __syncthreads();
      const int at = s_hist[key * BWD_WARPS + warp] + wrank;
      s_perm[at] = mine;
      s_plast[at] = mlast;
      __syncthreads();
    }
    const int lane = s_perm[threadIdx.x];
    const int last = s_plast[threadIdx.x];  // last alive row of this lane
    __syncthreads();  // the lists reuse the order's space
    const bool active = lane < r;
    uint32_t up = 0, us = 0;
    if (active) {
      up = (uint32_t)pix[lane];
      us = (uint32_t)smp[lane];
      // Phase 1: forward, storing the carry each alive row enters with.
      Carry c = load_carry<CM>(o, d, valid, lane, r);
      for (int it = 0; it <= last; ++it) {
        const Dec dec = decode(rec[(size_t)it * r + lane]);
        if (!dec.alive) continue;
        float* slot = ck + (size_t)it * NCARRY * nthreads + tid;
        slot[0 * (size_t)nthreads] = c.ox;
        slot[1 * (size_t)nthreads] = c.oy;
        slot[2 * (size_t)nthreads] = c.oz;
        slot[3 * (size_t)nthreads] = c.dx;
        slot[4 * (size_t)nthreads] = c.dy;
        slot[5 * (size_t)nthreads] = c.dz;
        slot[6 * (size_t)nthreads] = c.tx;
        slot[7 * (size_t)nthreads] = c.ty;
        slot[8 * (size_t)nthreads] = c.tz;
        const U4 u = uniform4(up, us, STREAM_BOUNCE_BASE + (uint32_t)it, seed);
        float dr, dg, db;
        bounce_fwd(c, s_tab + dec.idx * TS, dec, u.x, u.y, u.z, false, dr, dg,
                   db);
      }
    }

    // Phase 2: reverse sweep. Every row's radiance cotangent is g_rad
    // itself (the radiance is a sum of row increments).
    float grr = 0.0f, grg = 0.0f, grb = 0.0f;
    if (active) {
      grr = g_rad[at3<CM>(lane, 0, r)];
      grg = g_rad[at3<CM>(lane, 1, r)];
      grb = g_rad[at3<CM>(lane, 2, r)];
    }
    Carry g = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int it = blast; it >= 0; --it) {  // block-uniform
      Dec dec;
      dec.alive = false;
      dec.idx = 0;
      if (it <= last) dec = decode(rec[(size_t)it * r + lane]);
      float gch[NU];
      bool contrib = false;
      if (dec.alive) {
        const float* slot = ck + (size_t)it * NCARRY * nthreads + tid;
        const Carry c = {slot[0 * (size_t)nthreads], slot[1 * (size_t)nthreads],
                         slot[2 * (size_t)nthreads], slot[3 * (size_t)nthreads],
                         slot[4 * (size_t)nthreads], slot[5 * (size_t)nthreads],
                         slot[6 * (size_t)nthreads], slot[7 * (size_t)nthreads],
                         slot[8 * (size_t)nthreads]};
        const U4 u = uniform4(up, us, STREAM_BOUNCE_BASE + (uint32_t)it, seed);
        bounce_bwd(c, s_tab + dec.idx * TS, dec, u.x, u.y, u.z,
                   it >= accum_from, grr, grg, grb, g, gch);
        contrib = dec.hit;  // a miss reads no channel
      } else {
#pragma unroll
        for (int j = 0; j < NU; ++j) gch[j] = 0.0f;
      }

      // Lanes of the warp with the same winner: a tree over their ranks in
      // the group. At step s, the member of rank q (q a multiple of 2s) adds
      // the sum held by the member of rank q + s (`nxt`), then `nxt` jumps
      // to that member's own `nxt`, 2s ranks on.
      if (__any_sync(FULL, contrib)) {
        const int key = contrib ? dec.idx : -1 - wl;  // non-contributors alone
        const unsigned grp = __match_any_sync(FULL, key);
        const int rank = __popc(grp & below);
        const unsigned later = grp & after;
        int nxt = later ? __ffs(later) - 1 : -1;
        const int gmax = __reduce_max_sync(FULL, __popc(grp));
        for (int s = 1; s < gmax; s <<= 1) {  // warp-uniform
          const bool take = nxt >= 0 && (rank & (2 * s - 1)) == 0;
          const int src = nxt >= 0 ? nxt : wl;
#pragma unroll
          for (int j = 0; j < NU; ++j) {
            const float v = __shfl_sync(FULL, gch[j], src);
            if (take) gch[j] = gch[j] + v;
          }
          const int ahead = __shfl_sync(FULL, nxt, src);
          nxt = nxt >= 0 ? ahead : -1;
        }
        // Each group's lowest lane lists its sum, in lane order.
        const bool lead = contrib && rank == 0;
        const unsigned leads = __ballot_sync(FULL, lead);
        if (lead) {
          const int e = warp * 32 + __popc(leads & below);
          float* ent = s_list + e * LS;
#pragma unroll
          for (int j = 0; j < NU; ++j) ent[j] = gch[j];
          s_key[e] = dec.idx;
        }
        if (wl == 0) s_cnt[warp] = __popc(leads);
      } else if (wl == 0) {
        s_cnt[warp] = 0;
      }
      __syncthreads();
      // Warp `warp` adds the entries of the rows it owns (row % 8 == warp)
      // into the block's partial, lane j channel j: warps in order, each
      // warp's entries in lane order.
      for (int w = 0; w < BWD_WARPS; ++w) {
        const int cnt = s_cnt[w];
        const int k = wl < cnt ? s_key[w * 32 + wl] : -1;
        unsigned mine = __ballot_sync(FULL, k >= 0 && (k & (BWD_WARPS - 1)) == warp);
        while (mine) {  // warp-uniform
          const int e = __ffs(mine) - 1;
          mine &= mine - 1;
          const int row = __shfl_sync(FULL, k, e);
          if (wl < NU) {
            float* p = b_part + row * NU + wl;
            *p = *p + s_list[(w * 32 + e) * LS + wl];
          }
        }
      }
      __syncthreads();  // the lists are free again
    }
    if (active) {
      store3<CM>(g_o, lane, r, g.ox, g.oy, g.oz);
      store3<CM>(g_d, lane, r, g.dx, g.dy, g.dz);
    }
  }
  if (SHARED_PART) {
    __syncthreads();
    float* out = part + (size_t)blockIdx.x * n * NU;
    for (int k = threadIdx.x; k < n * NU; k += BWD_BLOCK) out[k] = b_part[k];
  }
}

// g_table (N, 32): the column of channel j is the sum over blocks, in block order,
// of the partials' channel j; the other columns are zero.
__global__ void reduce_partials(const float* __restrict__ part, int nblocks,
                                int n, float* __restrict__ g_table) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n * C_IN) return;
  const int row = k / C_IN;
  const int j = channel_of(k % C_IN);
  float s = 0.0f;
  if (j >= 0) {
    for (int b = 0; b < nblocks; ++b) s += part[((size_t)b * n + row) * NU + j];
  }
  g_table[k] = s;
}

// K3's partial can live in shared memory up to this many table rows.
constexpr int LIST_FLOATS = BWD_WARPS * 32 * LS + BWD_WARPS * 32 + BWD_WARPS;
constexpr int SHARED_PART_ROWS = (MAX_SMEM / 4 - LIST_FLOATS) / (TS + NU);

// Bytes of dynamic shared memory: K4 stages the table; K3 also holds the
// warps' lists and, with `shared`, its partial.
int forward_smem(int n) { return n * TS * (int)sizeof(float); }
int backward_smem(int n, bool shared) {
  return (n * TS + LIST_FLOATS + (shared ? n * NU : 0)) * (int)sizeof(float);
}

template <bool CM>
const void* backward_kernel(bool shared) {
  return shared ? (const void*)replay_backward<CM, true>
                : (const void*)replay_backward<CM, false>;
}

// Let every kernel of the file take the block's whole dynamic shared memory.
// Each shape query sets it (the wrapper queries, and caches, the shape it
// launches on), so no launch sets or queries anything.
cudaError_t allow_smem() {
  const void* kernels[] = {
      (const void*)replay_forward<false>, (const void*)replay_forward<true>,
      backward_kernel<false>(false),      backward_kernel<false>(true),
      backward_kernel<true>(false),       backward_kernel<true>(true)};
  for (const void* k : kernels) {
    const cudaError_t e =
        cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Resident blocks per SM of `kernel` with `smem` bytes of dynamic shared memory.
cudaError_t resident(const void* kernel, int threads, int smem, int* per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel, threads, smem);
}

// A kernel's launch shape: resident blocks per SM (shape[0]), SMs, threads
// per block, registers per thread, local (spill) bytes per thread, dynamic
// shared memory per block, whether K3's partial is in shared memory.
cudaError_t shape_of(const void* kernel, int threads, int smem, int sp,
                     int32_t* shape) {
  int per_sm = 0, sms = 0, dev = 0;
  cudaError_t e = resident(kernel, threads, smem, &per_sm);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaFuncAttributes attr{};
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return e;
  shape[0] = per_sm;
  shape[1] = sms;
  shape[2] = threads;
  shape[3] = attr.numRegs;
  shape[4] = (int32_t)attr.localSizeBytes;
  shape[5] = smem;
  shape[6] = sp;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

template <bool CM>
cudaError_t forward_shape(int n, int32_t* shape) {
  return shape_of((const void*)replay_forward<CM>, FWD_BLOCK, forward_smem(n), 0, shape);
}

// K3's partial goes to shared memory where it fits beside the table and
// keeps as many K3 blocks resident as the global partial would; else to
// `part`. K4-legacy's backward takes K3's placement (and K3's grid, from the
// wrapper). Where the partial goes does not change the sums' order, only the
// grid does.
template <bool CM>
cudaError_t backward_shape(int n, int32_t* shape) {
  bool shared = n <= SHARED_PART_ROWS;
  if (shared) {
    int with = 0, without = 0;
    cudaError_t e =
        resident(backward_kernel<false>(true), BWD_BLOCK, backward_smem(n, true), &with);
    if (e == cudaSuccess) {
      e = resident(backward_kernel<false>(false), BWD_BLOCK, backward_smem(n, false), &without);
    }
    if (e != cudaSuccess) return e;
    shared = with >= without;
  }
  return shape_of(backward_kernel<CM>(shared), BWD_BLOCK, backward_smem(n, shared),
                  shared ? 1 : 0, shape);
}

// Launch K4 (or K4-legacy's forward) on `grid` blocks, after zeroing the
// work counter. The wrapper sizes `grid` from the launch shape: as many
// blocks as stay resident, none more than the R lanes need.
template <bool CM>
int launch_forward(const float* table, const float* o, const float* d,
                   const int32_t* valid, const int32_t* pix, const int32_t* smp,
                   const int32_t* rec, int n, int r, int depth, int accum_from,
                   int seed, int grid, int32_t* next, float* rad, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(next, 0, sizeof(int32_t), st);
  if (e != cudaSuccess) return (int)e;
  if (grid > 0) {
    replay_forward<CM><<<grid, FWD_BLOCK, forward_smem(n), st>>>(
        table, o, d, valid, pix, smp, rec, n, r, depth, accum_from, (uint32_t)seed,
        next, rad);
  }
  return (int)cudaGetLastError();
}

// Launch K3 (or K4-legacy's backward) on `grid` blocks with the partial in
// shared memory or not (`shared`), then the reduce of their partials into
// g_table. The wrapper takes `grid` and `shared` from K3's launch shape and
// sizes `ck` / `part` from `grid`.
template <bool CM>
int launch_backward(const float* table, const float* o, const float* d,
                    const int32_t* valid, const int32_t* pix,
                    const int32_t* smp, const int32_t* rec, const float* g_rad,
                    int n, int r, int depth, int accum_from, int seed, int grid,
                    int shared, float* ck, float* part, float* g_table, float* g_o,
                    float* g_d, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int smem = backward_smem(n, shared != 0);
  if (grid > 0) {
    if (shared) {
      replay_backward<CM, true><<<grid, BWD_BLOCK, smem, st>>>(
          table, o, d, valid, pix, smp, rec, g_rad, n, r, depth, accum_from,
          (uint32_t)seed, ck, part, g_o, g_d);
    } else {
      replay_backward<CM, false><<<grid, BWD_BLOCK, smem, st>>>(
          table, o, d, valid, pix, smp, rec, g_rad, n, r, depth, accum_from,
          (uint32_t)seed, ck, part, g_o, g_d);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int entries = n * C_IN;
  if (entries > 0) {
    reduce_partials<<<(entries + 255) / 256, 256, 0, st>>>(part, grid, n, g_table);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch shape of one kernel for an N-row table into shape[0..6]:
// resident blocks per SM, SMs, threads per block, registers per thread,
// local (spill) bytes per thread, dynamic shared memory bytes per block,
// 1 if K3's partial is in shared memory. `kernel`: 0 K4, 1 K3, 2 K4-legacy's
// forward, 3 its backward. Also lets every kernel of the file take a block's
// whole shared memory, so it precedes the first launch. Returns a CUDA error.
int crucible_replay_shape(int kernel, int n, int32_t* shape) {
  const cudaError_t e = allow_smem();
  if (e != cudaSuccess) return (int)e;
  switch (kernel) {
    case 0: return (int)forward_shape<false>(n, shape);
    case 1: return (int)backward_shape<false>(n, shape);
    case 2: return (int)forward_shape<true>(n, shape);
    case 3: return (int)backward_shape<true>(n, shape);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launch the replay forward (K4) with `grid` blocks on `stream`: rays and
// radiance (R, 3); `next` one int32 of scratch, the work counter. Returns
// cudaGetLastError().
int crucible_replay_forward(const float* table, const float* o, const float* d,
                            const int32_t* valid, const int32_t* pix,
                            const int32_t* smp, const int32_t* rec, int n,
                            int r, int depth, int accum_from, int seed, int grid,
                            int32_t* next, float* rad, void* stream) {
  return launch_forward<false>(table, o, d, valid, pix, smp, rec, n, r, depth,
                               accum_from, seed, grid, next, rad, stream);
}

// Launch the replay backward (K3) with `grid` blocks, its partial in shared
// memory if `shared`, then the reduce of its block partials into g_table
// (N, 32). `ck` holds depth * 9 * grid * 256 floats, `part` grid * N * 22.
// Rays and cotangents (R, 3). Returns cudaGetLastError().
int crucible_replay_backward(const float* table, const float* o,
                             const float* d, const int32_t* valid,
                             const int32_t* pix, const int32_t* smp,
                             const int32_t* rec, const float* g_rad, int n,
                             int r, int depth, int accum_from, int seed,
                             int grid, int shared, float* ck, float* part,
                             float* g_table, float* g_o, float* g_d, void* stream) {
  return launch_backward<false>(table, o, d, valid, pix, smp, rec, g_rad, n, r,
                                depth, accum_from, seed, grid, shared, ck, part,
                                g_table, g_o, g_d, stream);
}

// K4-legacy's forward: crucible_replay_forward on channel-major rays and
// radiance, (3, R).
int crucible_replay_legacy_forward(const float* table, const float* o,
                                   const float* d, const int32_t* valid,
                                   const int32_t* pix, const int32_t* smp,
                                   const int32_t* rec, int n, int r, int depth,
                                   int accum_from, int seed, int grid,
                                   int32_t* next, float* rad, void* stream) {
  return launch_forward<true>(table, o, d, valid, pix, smp, rec, n, r, depth,
                              accum_from, seed, grid, next, rad, stream);
}

// K4-legacy's backward: crucible_replay_backward on channel-major rays,
// radiance cotangent and ray cotangents, (3, R); the same scratch and the
// same (N, 32) table cotangent.
int crucible_replay_legacy_backward(const float* table, const float* o,
                                    const float* d, const int32_t* valid,
                                    const int32_t* pix, const int32_t* smp,
                                    const int32_t* rec, const float* g_rad,
                                    int n, int r, int depth, int accum_from,
                                    int seed, int grid, int shared, float* ck,
                                    float* part, float* g_table, float* g_o,
                                    float* g_d, void* stream) {
  return launch_backward<true>(table, o, d, valid, pix, smp, rec, g_rad, n, r,
                               depth, accum_from, seed, grid, shared, ck, part,
                               g_table, g_o, g_d, stream);
}

const char* crucible_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
