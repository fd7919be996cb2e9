// Persistent path-tracing megakernel on Hopper: one kernel, flat_kernel,
// for every sphere and mesh scene the megakernel renders. Forward mode (K1)
// and record mode (K2) over the brute sphere search, the walk of a static
// big table's sphere tree (K5) or of a moving one's swept tree (K6, in place
// of the chunk-cull branch's clusters), their motion variants (K8), and the
// triangle-BVH stage of static and moving meshes (K7, K7 moving).
//
// Replaces crucible_tpu/ops/pallas/megakernel.py::_kernel in both of its
// modes, with its static, animated (moving spheres and meshes) and
// cam_animated (keyframed camera) variants:
// - forward (run_megakernel, pallas_call at megakernel.py:1681): camera ray
//   generation with jitter and defocus, the PCG4D counter hash, the
//   closest hit, the winner's attribute fetch, solid / checker-of-solid
//   albedo, default sky, emission, and Lambertian / metal / dielectric /
//   emissive scatter, accumulated into per-lane radiance sums;
// - record (run_megakernel_record, pallas_call at megakernel.py:1828): each
//   lane traces one (pixel, sample) path and writes one packed decision word
//   per bounce (winner id * 256 + flag byte, models/replay.py layout); the
//   fused variant also accumulates that path's radiance from bounce
//   smem[4] on.
// The closest sphere is the brute search over every active row (the branch
// at megakernel.py:804-830; K1, K2, K8), or a walk over the tree-permuted
// table: a static table's tree (K5, what the n_sph_nodes branch,
// megakernel.py:618-803, computes) or a moving table's swept tree (K6, what
// the chunk-cull branch, megakernel.py:831-960, computes); a walk's record
// words de-permute the winner through table column 31. A mesh adds the
// triangle stage after the sphere search, the brute one or a walk (K7,
// megakernel.py from l.962). The record flags only add the decision words; the camera
// (primary_ray) and the shading (shade_bounce) are shared by all.
//
// K8, the motion variants (both modes; megakernel.py l.509-555, 588-616
// and the shading lerp l.1309-1314). Each path draws its shutter fraction
// w = the first uniform of pcg4d(pix, sample, STREAM_TIME, seed), the
// number the staged path's camera draws, once when it starts:
// - ANIMATED: spheres move on the linear shutter. The search adds
//   w (cd.d) and w (cd.o) to its dot products and 2w s1 + w^2 s2 to
//   |c|^2 - r^2 (moving_row and moving_terms; table columns 24-29), and
//   the winner's center and radius are lerped for its normal and, in record
//   mode, for the per-winner quadratic that picks F_ROOT1, so that every
//   flag is the moving sphere's (megakernel.py l.1309-1313, 1459-1466). A
//   mesh of an animated scene moves too (K7 moving, below);
// - CAM_ANIMATED: at each new sample the lane lerps look_from and look_at
//   (cam slots 9-11 / 19-21 plus w times the deltas in 22-27) and rebuilds
//   the basis, pixel00, du and dv with true divisions and the 1e-12 floor,
//   operation for operation as camera.generate_rays does.
// Every search (brute, K5's tree, K6's tree, each with or without a mesh
// after it) takes either flag and both, in both modes, fused or not. K5's tree holds
// the spheres at one time: a moving table walks K6's swept tree, whose
// boxes hold them over the whole shutter.
//
// What bounds it on this card: per-thread FP32 work on the quadratic (about
// 20 flops and a square root per row tested per bounce, ~40 moving; a walk
// adds a slab test per node visited), with divergence at the material
// branches and at the walks. Record mode adds 4 bytes per bounce per lane of
// stores (row-major (D, R)).
//
// The flat loop: persistent lanes. Launched on as many blocks as stay
// resident (the wrapper sizes the grid from the launch shape it queried
// once), each iteration of the one loop, a lane with no path in flight
// starts its next sample (forward) or takes its next path (record), drawing
// the path's w, then every lane runs one closest-hit search and one
// bounce's shading, so a warp stays converged at one search per iteration
// whatever bounce each lane is on: a lane whose path ends does not wait for
// the warp's longest path. Lanes take work items from a global counter, one
// atomicAdd per warp for its idle lanes, shared out in lane order so that
// neighbouring lanes start on neighbouring pixels. A forward item is one
// pixel's lane with all its samples in order on one thread, so each sum is
// added in the order of the plain version, whichever lane takes it. The
// winner's row is read from global memory by index (an indexed load is
// exact, so the TPU's one-hot MXU fetch and its bf16 split have no
// counterpart here). On a miss no row is read.
// - The brute search (K1, K2, K8, and beside a mesh) stages each block's
//   live rows once in shared memory (the wrapper orders the active rows
//   first, in table order, with their table row ids; inactive rows are not
//   staged): 16-byte (cx, cy, cz, |c|^2 - r^2) entries, and with ANIMATED a
//   second 16-byte (cdx, cdy, cdz, s1) entry and s2, 36 bytes a row. It
//   reads a row per broadcast LDS.128 (two and an LDS.32 moving) and tests
//   four rows a step, strict '<' in row order, so ties still go to the
//   lowest table row.
// - K5 and K6 (TREE) walk a per-lane BVH of the active spheres
//   (ops/kernels/megakernel.py swept_tables: SAH, SWEPT_LEAF spheres a
//   leaf; K6's leaf boxes hold each sphere at shutter open and close, K5's
//   at its one position), nearer child first (tree_closest: the far child
//   deferred with its entry distance on a TREE_STACK-entry stack;
//   swept_tables builds no deeper tree and swept_inputs refuses one). The
//   TPU kernel walks its sphere BVH at leaves of 128 rows (one vector tile)
//   in a 16-node slab window with a scalar cursor chase, and tests the
//   chunk-cull branch's 256-row clusters against whole 512-lane tiles,
//   fetching the winner by one-hot contraction, all answers to the TPU's
//   vector layout; a thread here tests only the nodes and leaves its own ray
//   enters before its best t: on bouncing stress n7744 about 30 nodes and
//   25 rows a search, where the cluster walk tests about 1,500 rows
//   (counted by the plain walks). The nodes sit in shared memory where
//   they fit (36 bytes each: two 16-byte entries, lo x/y/z hi x and hi y/z
//   first count, then the skip link), else they are read from global
//   memory; the rows are read from global memory (L2): K5's one LDG.128 a
//   row, (cx, cy, cz, |c|^2 - r^2); K6's three, that, (cdx, cdy, cdz, s1)
//   and (s2, original id, 0, 0). A leaf row's root is K1's static search
//   (K5) or K8's moving one (K6), and an exact tie goes to the lower
//   original id, so the walk returns K1's (or K8's) brute search over the
//   original table, bit for bit: the lexicographic least (t, id) does not
//   depend on the order in which leaves are visited. Its records carry the
//   original ids.
// - K7 (TRI; megakernel.py from l.962: the Woop leaf test l.1079-1140, the
//   winner's normal and material l.1286-1299, 1318-1321, the record flags
//   l.1472-1490) walks the mesh's triangle BVH after the sphere search
//   (the brute one, or K5's / K6's walk: a mesh beside a big table, where
//   each walk keeps its own state: the sphere walk its stack, the
//   triangle walk its skip links), over its DFS skip links as the TPU kernel's walk and the plain
//   version do (tri_closest), from the sphere stage's t: the slab test in
//   the Pallas kernel's arithmetic (no margin: the JAX package grows no
//   triangle box), at a leaf the Woop unit-triangle test on its rows
//   (integrator.make_tri_tables: t = -o'_z / d'_z, u = o'_x + t d'_x, v =
//   o'_y + t d'_y after the row's affine map, d'_z guarded at 1e-12), three
//   LDG.128 of the row's 16 floats, the ones the test reads. A triangle
//   replaces the bound only when strictly nearer, so within a leaf the
//   lowest row wins a tie and across leaves the first in DFS order; the
//   bound starts at the sphere stage's t, so a triangle wins only when
//   strictly nearer than every sphere. The order is kept: with boxes that
//   are not grown, a hit on an edge shared by triangles of two leaves can
//   lie an ulp before its leaf box's computed entry, and a walk that meets
//   the leaves in another order (nearer child first, measured) prunes such
//   a leaf where the DFS walk visits it, and returns another triangle on
//   such a ray (torus_teapot's 1080p 32 spp d50 launch, in an A/B of the
//   two orders, tools/torch_static_ab.py). The winner's shading
//   attributes are an indexed load of its material's row of `mats`
//   (sphere-table columns 6-23), its normal the table's unit normal,
//   flipped to face the ray; its record word holds the leaf-order triangle
//   id and F_TRI, and no F_ROOT1. The nodes (K6's layout, boxes not grown)
//   are read from global memory (L2): staged in shared memory after the
//   brute search's rows, torus_teapot's 3,159 (113.7 KB) left room for 2
//   blocks an SM against 4, and the launch took 29% longer (measured).
// - K7 moving (TRI with ANIMATED: every mesh of an animated scene moves,
//   megakernel.py l.1141-1240, the normalization l.1280-1284, set at l.1675
//   / l.1822): the same walk over boxes that hold each triangle at shutter
//   open and close; at a leaf row the thread lerps the edges and v0 to the
//   path's shutter fraction w (e1 + w e1d, e2 + w e2d, o - (v0 + w v0d)) and
//   runs Möller–Trumbore on them, |det| > 1e-8, in the Pallas kernel's
//   association term by term. The wrapper packs the 18 floats the test reads
//   into five 16-byte entries a row (moving_tri_rows). The winner carries the
//   unnormalized cross of its lerped edges (the table's normal is stale
//   under motion), normalized once after the walk with 1 / max(|n|, 1e-20);
//   its material id is column 12 of its (M, 32) row.
// The TPU kernel's 16-node window, multi-leaf chase, packed hit mask and
// one-hot material fetch answer the TPU's vector layout and have no
// counterpart here.
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
constexpr int COL_ID = 31;         // the table's original row id
constexpr int TRI_COLS = 16;       // Woop row: a0, a1, a2, b, unit normal, mat id
constexpr int TRI_MOVING_COLS = 32;  // moving row: v0, e1, e2, n, mat id, 0, v0d, e1d, e2d
constexpr int MOVING_TRI_ENTRIES = 5;  // 16-byte entries of a packed moving row
constexpr int MAT_COLS = 24;       // material row: sphere-table columns 6-23, ...
constexpr int BRUTE_BLOCK = 128;   // threads per block, the brute search (4 warps)
constexpr int TREE_BLOCK = 256;    // threads per block, a walk (K5, K6, K7; 8 warps)
constexpr int TREE_STACK = 64;     // a walk's deferred far children: its tree at most this deep
constexpr int NODE_BYTES = 36;     // a walk's node: two 16-byte entries and the skip link
constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block can take
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int NO_SAMPLE = 1 << 30;  // sample0 of a padding lane
constexpr float SLAB_EPS = 4e-3f;  // the sphere walks' slab margin (see below)

// A sphere walk's slab test is conservative: each box is grown by SLAB_EPS
// * (1 + its largest |coordinate|) on the host (ops/kernels/megakernel.py
// swept_inputs) and by SLAB_EPS * the origin's largest |coordinate| here,
// which covers the expanded quadratic's error on the hit point (up to
// ~1.7e-3 (|c| + |o|), fault C6), so no leaf holding a winning root is
// skipped. The moving quadratic's error on the hit point is that of the
// static one at the center c + w cd, which lies in the leaf's box, a box
// that holds the sphere at open and close holding it at every w between
// (the wrapper checks that each leaf box holds its rows at open and close
// and each parent box its children).

__device__ __forceinline__ float safe_inv(float v) {
  return 1.0f / (fabsf(v) < 1e-30f ? (v >= 0.0f ? 1e-30f : -1e-30f) : v);
}

// The primary ray of sample `smp` of pixel (fi, fj): jitter and defocus
// from one hash (megakernel.py l.402-455 of the Pallas kernel's camera).
// CAM_ANIMATED (K8): the camera at the path's shutter fraction w.
template <bool CAM_ANIMATED>
__device__ __forceinline__ void primary_ray(const float* __restrict__ cam, uint32_t upix,
                                            float fi, float fj, uint32_t smp,
                                            uint32_t seed, float w, float& ox, float& oy,
                                            float& oz, float& dx, float& dy, float& dz) {
  // Static camera slots (megakernel.py CAM_SIZE layout).
  float p00x = cam[0], p00y = cam[1], p00z = cam[2];
  float dux = cam[3], duy = cam[4], duz = cam[5];
  float dvx = cam[6], dvy = cam[7], dvz = cam[8];
  float lfx = cam[9], lfy = cam[10], lfz = cam[11];
  float ubx = cam[12], uby = cam[13], ubz = cam[14];
  float vbx = cam[15], vby = cam[16], vbz = cam[17];
  const float defr = cam[18];
  if (CAM_ANIMATED) {
    // The camera at w: look_from / look_at lerped, then the basis as
    // camera.generate_rays builds it (vec.unit with the 1e-12 floor).
    lfx = cam[9] + w * cam[22];
    lfy = cam[10] + w * cam[23];
    lfz = cam[11] + w * cam[24];
    const float lax = cam[19] + w * cam[25];
    const float lay = cam[20] + w * cam[26];
    const float laz = cam[21] + w * cam[27];
    const float wx0 = lfx - lax, wy0 = lfy - lay, wz0 = lfz - laz;
    const float wden = fmaxf(sqrtf(wx0 * wx0 + wy0 * wy0 + wz0 * wz0), 1e-12f);
    const float wbx = wx0 / wden, wby = wy0 / wden, wbz = wz0 / wden;
    const float ux0 = cam[29] * wbz - cam[30] * wby;  // cross(vup, w)
    const float uy0 = cam[30] * wbx - cam[28] * wbz;
    const float uz0 = cam[28] * wby - cam[29] * wbx;
    const float uden = fmaxf(sqrtf(ux0 * ux0 + uy0 * uy0 + uz0 * uz0), 1e-12f);
    ubx = ux0 / uden;
    uby = uy0 / uden;
    ubz = uz0 / uden;
    vbx = wby * ubz - wbz * uby;  // cross(w, u)
    vby = wbz * ubx - wbx * ubz;
    vbz = wbx * uby - wby * ubx;
    dux = cam[32] * ubx / cam[34];  // viewport_w * u / width
    duy = cam[32] * uby / cam[34];
    duz = cam[32] * ubz / cam[34];
    dvx = -cam[31] * vbx / cam[35];  // viewport_h * (-v) / height
    dvy = -cam[31] * vby / cam[35];
    dvz = -cam[31] * vbz / cam[35];
    p00x = lfx - cam[33] * wbx - cam[36] * dux - cam[37] * dvx;
    p00y = lfy - cam[33] * wby - cam[36] * duy - cam[37] * dvy;
    p00z = lfz - cam[33] * wbz - cam[36] * duz - cam[37] * dvz;
  }
  const U4 uc = uniform4(upix, smp, STREAM_PIXEL_JITTER, seed);
  const float oxj = fi + (uc.x - 0.5f);
  const float oyj = fj + (uc.y - 0.5f);
  const float px = p00x + oxj * dux + oyj * dvx;
  const float py = p00y + oxj * duy + oyj * dvy;
  const float pz = p00z + oxj * duz + oyj * dvz;
  const float dphi = TWO_PI * uc.w;
  const float dru = sqrtf(uc.z);
  const float da = dru * cosf(dphi) * defr;
  const float db = dru * sinf(dphi) * defr;
  ox = lfx + da * ubx + db * vbx;
  oy = lfy + da * uby + db * vby;
  oz = lfz + da * ubz + db * vbz;
  dx = px - ox;
  dy = py - oy;
  dz = pz - oz;
}

// One bounce after the closest hit (best, win; with TRI K7's triangle
// winner tid and, moving, its cross tn): on a miss the default sky, else
// the winner's emission and albedo and its scatter (models/materials.py);
// RADIANCE adds to (ax, ay, az) where `acc_row`. RECORD: `word` receives
// the bounce's decision word. Returns whether the path goes on, with (o, d)
// the next ray and (tx, ty, tz) its throughput.
template <bool RECORD, bool RADIANCE, bool WALK, bool ANIMATED, bool TRI>
__device__ __forceinline__ bool shade_bounce(
    const float* __restrict__ table, const float* __restrict__ tris,
    const float* __restrict__ mats, uint32_t upix, uint32_t smp, uint32_t seed,
    int bounce, bool acc_row, int max_depth, float t_min, float w, float a_q,
    float inv_a, float best, int win, int tid, float tnx, float tny, float tnz,
    float& ox, float& oy, float& oz, float& dx, float& dy, float& dz, float& tx,
    float& ty, float& tz, float& ax, float& ay, float& az, int32_t& word) {
  constexpr int TRI_STRIDE = ANIMATED ? TRI_MOVING_COLS : TRI_COLS;
  constexpr int TRI_MAT = ANIMATED ? 12 : 15;  // a row's material id column
  const bool is_tri = TRI && tid >= 0;
  const float dlen = fmaxf(sqrtf(a_q), 1e-20f);
  if (win < 0 && !is_tri) {
    // Miss: default sky gradient on the unit direction; the path ends.
    if (RADIANCE && acc_row) {
      const float sky_a = 0.5f * (dy / dlen + 1.0f);
      const float one_m_a = 1.0f - sky_a;
      ax = ax + tx * (one_m_a + sky_a * 0.5f);
      ay = ay + ty * (one_m_a + sky_a * 0.7f);
      az = az + tz * (one_m_a + sky_a);
    }
    word = F_ALIVE;
    return false;
  }
  // The winner's attributes: a sphere's table row, or a triangle's
  // material row, whose column c - 6 holds table column c (c >= 6).
  const float* row = table + (size_t)(is_tri ? 0 : win) * C_IN;
  const float* mat_row =
      TRI && is_tri ? mats + (size_t)(int)tris[(size_t)tid * TRI_STRIDE + TRI_MAT] * MAT_COLS
                    : nullptr;
  auto attr = [&](int c) { return TRI && is_tri ? mat_row[c - 6] : row[c]; };

  // --- shading point + outward normal -------------------------------------
  const float hx = ox + best * dx;
  const float hy = oy + best * dy;
  const float hz = oz + best * dz;
  float wcx = row[0], wcy = row[1], wcz = row[2], wrad = row[3];
  if (ANIMATED) {  // the winner at the path's shutter fraction
    wcx = wcx + w * row[24];
    wcy = wcy + w * row[25];
    wcz = wcz + w * row[26];
    wrad = wrad + w * row[27];
  }
  float nx, ny, nz;
  if (TRI && is_tri && ANIMATED) {  // the lerped triangle's cross, made unit
    const float nlen = sqrtf(tnx * tnx + tny * tny + tnz * tnz);
    const float invn = 1.0f / fmaxf(nlen, 1e-20f);
    nx = tnx * invn;
    ny = tny * invn;
    nz = tnz * invn;
  } else if (TRI && is_tri) {  // the table's unit normal
    const float* tw = tris + (size_t)tid * TRI_COLS;
    nx = tw[12];
    ny = tw[13];
    nz = tw[14];
  } else {
    const float inv_r = 1.0f / fmaxf(wrad, 1e-20f);
    nx = (hx - wcx) * inv_r;
    ny = (hy - wcy) * inv_r;
    nz = (hz - wcz) * inv_r;
  }
  const bool front = dx * nx + dy * ny + dz * nz < 0.0f;
  const float sgn = front ? 1.0f : -1.0f;
  nx = nx * sgn;
  ny = ny * sgn;
  nz = nz * sgn;

  // --- emission + albedo: solid or 3-D checker of solids ------------------
  float alr = 0.0f, alg = 0.0f, alb = 0.0f;
  if (RADIANCE) {
    if (acc_row) {
      ax = ax + tx * attr(10);
      ay = ay + ty * attr(11);
      az = az + tz * attr(12);
    }
    const float inv_scale = attr(17);
    const int xf = (int)floorf(inv_scale * hx);
    const int yf = (int)floorf(inv_scale * hy);
    const int zf = (int)floorf(inv_scale * hz);
    // C's '%' truncates, but "== 0" gives the same even/odd answer.
    const bool is_even = (xf + yf + zf) % 2 == 0;
    if (attr(13) == TEX_CHECKER) {
      alr = is_even ? attr(18) : attr(21);
      alg = is_even ? attr(19) : attr(22);
      alb = is_even ? attr(20) : attr(23);
    } else {
      alr = attr(14);
      alg = attr(15);
      alb = attr(16);
    }
  }

  // --- scatter (models/materials.py) --------------------------------------
  const float mat_type = attr(6);
  const U4 ub = uniform4(upix, smp, STREAM_BOUNCE_BASE + (uint32_t)bounce, seed);
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
    const float ior = attr(8);
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
    const float fuzz = attr(7);
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
    const float prob = attr(9);
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
    const float ior = attr(8);
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
    bool root1 = false;  // a triangle has no second root
    if (!(TRI && is_tri)) {
      // The winner at the path's shutter fraction (row[0..3] when static).
      const float r_ocx = wcx - ox;
      const float r_ocy = wcy - oy;
      const float r_ocz = wcz - oz;
      const float r_h = dx * r_ocx + dy * r_ocy + dz * r_ocz;
      const float r_c =
          r_ocx * r_ocx + r_ocy * r_ocy + r_ocz * r_ocz - wrad * wrad;
      const float r_disc = fmaxf(r_h * r_h - a_q * r_c, 0.0f);
      const float r_root0 = (r_h - sqrtf(r_disc)) * inv_a;
      root1 = !(r_root0 > t_min);
    }
    const int flags = F_ALIVE | F_HIT | (is_tri ? F_TRI : 0) |
                      (scattered ? F_SCAT : 0) | (front ? F_FRONT : 0) |
                      (refl ? F_REFL : 0) | (degen ? F_DEGEN : 0) |
                      (root1 ? F_ROOT1 : 0);
    // The walk's winner is a permuted row: record its original id
    // (exact in float32 below 2^24). A triangle's id is its leaf-order row.
    const int win_id = is_tri ? tid : WALK ? (int)row[COL_ID] : win;
    word = win_id * REC_ID_SCALE + flags;
  }

  if (!(scattered && bounce + 1 < max_depth)) return false;
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
  return true;
}

// One staged row against the ray, in K10's arithmetic (common.cuh
// static_terms, take_root); the entry replaces (best, k_win) only when
// strictly nearer.
__device__ __forceinline__ void brute_row(const float4 c, int k, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float a_q, float d_dot_o, float o_sq,
                                          float inv_a, float t_min, float& best,
                                          int& k_win) {
  float h, c_q;
  static_terms(c, ox, oy, oz, dx, dy, dz, d_dot_o, o_sq, h, c_q);
  take_root(h, h * h - a_q * c_q, k, inv_a, t_min, best, k_win);
}

// A moving row (entries c, m = (cdx, cdy, cdz, s1) and s2) at the path's
// shutter fraction in K9's association (common.cuh moving_terms), in
// brute_row's form: the entry replaces (best, k_win) only when strictly
// nearer.
__device__ __forceinline__ void moving_row(const float4 c, const float4 m, float s2, int k,
                                           float ox, float oy, float oz, float dx, float dy,
                                           float dz, float a_q, float d_dot_o, float o_sq,
                                           float inv_a, float w, float two_w, float w_sq,
                                           float t_min, float& best, int& k_win) {
  float h, c_q;
  moving_terms(c, m, s2, ox, oy, oz, dx, dy, dz, d_dot_o, o_sq, w, two_w, w_sq, h, c_q);
  take_root(h, h * h - a_q * c_q, k, inv_a, t_min, best, k_win);
}

// K5's and K6's closest hit over a tree of spheres (see the note at the
// top) -> (best, win), win a row of the permuted table, -1 on a miss. At an
// inner node the walk slab-tests both children and goes on to the one it enters
// first, deferring the other with its entry distance on a stack of
// TREE_STACK entries, one at most a level of a tree at most that deep
// (swept_inputs checks it); after a leaf (or where it enters neither) it
// resumes at the most recently deferred child whose entry is not past the
// best hit so far (the box test's exit is min(box exit, best), so "entry
// <= best" is the test repeated). A leaf row's root is the moving search's
// at w (ANIMATED: K6, three 16-byte entries a row) or the static one's (K5,
// one entry a row); it replaces the best where strictly nearer or, at an
// exact tie, where its original id is lower, so any visit order gives the
// least (t, original id).
template <bool ANIMATED>
__device__ __forceinline__ void tree_closest(
    const float4* nodes, const int32_t* miss, int k, const float4* __restrict__ rows,
    const float* __restrict__ table, float ox, float oy, float oz, float dx, float dy,
    float dz, float a_q, float d_dot_o, float o_sq, float inv_a, float w, float t_min,
    float& best, int& win) {
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  const float pr = SLAB_EPS * fmaxf(fmaxf(fabsf(ox), fabsf(oy)), fabsf(oz));
  const float two_w = 2.0f * w, w_sq = w * w;
  float win_id = 0.0f;  // the winner's original id (exact in float32)
  // Node i's grown box against [t_min, best]: whether the ray enters it,
  // and where.
  auto entered = [&](int i, float& enter) {
    const float4 a = nodes[2 * i], b = nodes[2 * i + 1];
    const float t0x = ((a.x - pr) - ox) * ivx;
    const float t1x = ((a.w + pr) - ox) * ivx;
    const float t0y = ((a.y - pr) - oy) * ivy;
    const float t1y = ((b.x + pr) - oy) * ivy;
    const float t0z = ((a.z - pr) - oz) * ivz;
    const float t1z = ((b.y + pr) - oz) * ivz;
    enter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), t_min));
    const float exitv = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                              fminf(fmaxf(t0z, t1z), best));
    return enter <= exitv;
  };
  // Whether row q (original id row_id in a moving row's third entry) has a
  // lower original id than the winner so far; a static row's id is read
  // from the table, at an exact tie only.
  auto lower = [&](int q, float row_id) {
    if (ANIMATED) return row_id < win_id;
    return __ldg(table + (size_t)q * C_IN + COL_ID) < __ldg(table + (size_t)win * C_IN + COL_ID);
  };
  auto leaf = [&](int first, int count) {
    for (int q = first; q < first + count; ++q) {
      const float4 c = __ldg(rows + (ANIMATED ? 3 : 1) * q);
      float h, c_q, row_id = 0.0f;
      if (ANIMATED) {
        const float4 e = __ldg(rows + 3 * q + 2);
        moving_terms(c, __ldg(rows + 3 * q + 1), e.x, ox, oy, oz, dx, dy, dz, d_dot_o, o_sq,
                     w, two_w, w_sq, h, c_q);
        row_id = e.y;
      } else {
        static_terms(c, ox, oy, oz, dx, dy, dz, d_dot_o, o_sq, h, c_q);
      }
      const float disc = h * h - a_q * c_q;
      if (disc >= 0.0f) {
        const float sq = sqrtf(disc);
        const float root0 = (h - sq) * inv_a;
        const float root1 = (h + sq) * inv_a;
        const bool ok0 = (root0 > t_min) && (root0 < BIG);
        const bool ok1 = (root1 > t_min) && (root1 < BIG);
        const float root = ok0 ? root0 : root1;
        if ((ok0 || ok1) && (root < best || (root == best && lower(q, row_id)))) {
          best = root;
          win = q;
          win_id = row_id;
        }
      }
    }
  };
  float enter;
  int2 stack[TREE_STACK];  // (node, entry distance as bits)
  int sp = 0;
  if (k == 0 || !entered(0, enter)) return;
  int i = 0;
  for (;;) {
    const float4 b = nodes[2 * i + 1];
    const int count = __float_as_int(b.w);
    if (count > 0) {
      leaf(__float_as_int(b.z), count);
    } else {
      const int l = i + 1, r = miss[l];
      float el, er;
      const bool hl = entered(l, el), hr = entered(r, er);
      if (hl && hr) {
        const bool near_l = el <= er;
        i = near_l ? l : r;
        stack[sp++] = make_int2(near_l ? r : l, __float_as_int(near_l ? er : el));
        continue;
      }
      if (hl || hr) {
        i = hl ? l : r;
        continue;
      }
    }
    for (;;) {  // resume at the last deferred child still entered before best
      if (sp == 0) return;
      const int2 top = stack[--sp];
      if (__int_as_float(top.y) <= best) {
        i = top.x;
        break;
      }
    }
  }
}

// K7's closest triangle over the mesh's BVH (see the note at the top): the
// stackless walk of the DFS skip links, from the sphere stage's t in `tb`,
// lowering it and setting `tid` (a row of `tris`, leaf order) wherever a
// triangle is strictly nearer: at node i the slab test of its box against
// [t_min, tb]; on a hit at an inner node go on to i + 1, at a leaf test its
// rows and go to miss[i]; on a miss go to miss[i]; stop at K. `rows`: the
// Woop rows themselves, (M, 16) float32 read as four 16-byte entries a row
// of which the test reads three; MOVING (K7 moving): the packed moving rows,
// five entries a row (v0 x/y/z, e1 x), (e1 y/z, e2 x/y), (e2 z, v0d x/y/z),
// (e1d x/y/z, e2d x), (e2d y/z, material id, 0), each lerped to the path's
// shutter fraction `w`; (nx, ny, nz) then receives the winner's unnormalized
// lerped-edge cross.
template <bool MOVING>
__device__ __forceinline__ void tri_closest(
    const float4* nodes, const int32_t* miss, int k, const float4* __restrict__ rows,
    float ox, float oy, float oz, float dx, float dy, float dz, float w, float t_min,
    float& tb, int& tid, float& nx, float& ny, float& nz) {
  const float ivx = safe_inv(dx), ivy = safe_inv(dy), ivz = safe_inv(dz);
  int i = 0;
  while (i < k) {
    const float4 a = nodes[2 * i], b = nodes[2 * i + 1];
    const float t0x = (a.x - ox) * ivx;
    const float t1x = (a.w - ox) * ivx;
    const float t0y = (a.y - oy) * ivy;
    const float t1y = (b.x - oy) * ivy;
    const float t0z = (a.z - oz) * ivz;
    const float t1z = (b.y - oz) * ivz;
    const float enter = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                              fmaxf(fminf(t0z, t1z), t_min));
    const float exitv = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                              fminf(fmaxf(t0z, t1z), tb));
    if (enter <= exitv) {
      const int count = __float_as_int(b.w);
      if (count == 0) {  // inner node: its left child is next
        ++i;
        continue;
      }
      const int first = __float_as_int(b.z);
      for (int q = first; q < first + count; ++q) {
        if (MOVING) {
          const float4* r = rows + MOVING_TRI_ENTRIES * (size_t)q;
          const float4 p0 = __ldg(r), p1 = __ldg(r + 1), p2 = __ldg(r + 2);
          const float4 p3 = __ldg(r + 3), p4 = __ldg(r + 4);
          const float e1x = p0.w + w * p3.x;
          const float e1y = p1.x + w * p3.y;
          const float e1z = p1.y + w * p3.z;
          const float e2x = p1.z + w * p3.w;
          const float e2y = p1.w + w * p4.x;
          const float e2z = p2.x + w * p4.y;
          const float pvx = dy * e2z - dz * e2y;
          const float pvy = dz * e2x - dx * e2z;
          const float pvz = dx * e2y - dy * e2x;
          const float det = e1x * pvx + e1y * pvy + e1z * pvz;
          if (!(fabsf(det) > 1e-8f)) continue;  // parallel to the plane
          const float invd = 1.0f / det;
          const float tvx = ox - (p0.x + w * p2.y);
          const float tvy = oy - (p0.y + w * p2.z);
          const float tvz = oz - (p0.z + w * p2.w);
          const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * invd;
          const float qvx = tvy * e1z - tvz * e1y;
          const float qvy = tvz * e1x - tvx * e1z;
          const float qvz = tvx * e1y - tvy * e1x;
          const float vv = (dx * qvx + dy * qvy + dz * qvz) * invd;
          const float th = (e2x * qvx + e2y * qvy + e2z * qvz) * invd;
          if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && th > t_min && th < tb) {
            tb = th;
            tid = q;
            nx = e1y * e2z - e1z * e2y;
            ny = e1z * e2x - e1x * e2z;
            nz = e1x * e2y - e1y * e2x;
          }
          continue;
        }
        const float4* r = rows + 4 * (size_t)q;  // a0 | a1, a2 x/y | a2 z, b
        const float4 ra = __ldg(r), rb = __ldg(r + 1), rc = __ldg(r + 2);
        const float dpz = rb.z * dx + rb.w * dy + rc.x * dz;
        if (!(fabsf(dpz) > 1e-12f)) continue;  // parallel to the plane
        const float opz = rb.z * ox + rb.w * oy + rc.x * oz + rc.w;
        const float th = -opz * (1.0f / dpz);
        if (!(th > t_min && th < tb)) continue;
        const float opx = ra.x * ox + ra.y * oy + ra.z * oz + rc.y;
        const float dpx = ra.x * dx + ra.y * dy + ra.z * dz;
        const float uu = opx + th * dpx;
        const float opy = ra.w * ox + rb.x * oy + rb.y * oz + rc.z;
        const float dpy = ra.w * dx + rb.x * dy + rb.y * dz;
        const float vv = opy + th * dpy;
        if (uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f) {
          tb = th;
          tid = q;
        }
      }
    }
    i = miss[i];
  }
}

// The flat loop's dynamic shared memory: the brute search's staged rows (a
// 16-byte entry each, with ANIMATED 36 bytes), padded to a multiple of 4 of
// the table's N rows; a sphere walk's K nodes where they fit, else none
// (read from global memory).
__host__ __device__ int flat_smem_bytes(bool animated, bool tree, int n, int k) {
  if (tree) {
    const long bytes = (long)k * NODE_BYTES;
    return bytes <= MAX_SMEM ? (int)bytes : 0;
  }
  const int n4 = (n + 3) & ~3;
  return n4 * (int)(animated ? 2 * sizeof(float4) + sizeof(float) : sizeof(float4));
}

// What flat_kernel reads beside the table (ops/kernels/megakernel.py
// _flat_args). The brute search: its rows' entries, the active rows first
// in table order (16 bytes a row, 48 with ANIMATED), their table row ids and
// the count of active rows. K5 / K6: the tree's rows in the permuted
// table's order (16 bytes a row, 48 with ANIMATED), its K nodes (two
// 16-byte entries a node: grown box lo x/y/z and hi x; hi y/z, first and
// count as int bits) and skip links. K7: the mesh's rows as the walk reads
// them, its table rows and material rows (the winner's), its KT nodes in
// K6's layout (boxes not grown) and skip links. All: the work counter the
// launch zeroes.
struct Flat {
  const float4* rows;    // (N,), (N, 3) row entries (see above)
  const int32_t* ids;    // brute: (N,) each entry's table row
  const int32_t* live;   // brute: (1,) the active rows, entries [0, live)
  const float4* nodes;   // K5 / K6: (K, 2) node entries
  const int32_t* miss;   // K5 / K6: (K,) skip links
  const float4* trows;   // K7: (M, 4) Woop or (M, 5) packed moving entries
  const float* tris;     // K7: (M, 16) Woop or (M, 32) moving rows, leaf order
  const float* mats;     // K7: (NM, 24) material rows
  const float4* tnodes;  // K7: (KT, 2) node entries
  const int32_t* tmiss;  // K7: (KT,) skip links
  int32_t* next;         // (1,) the next work item to hand out
  int k;                 // the sphere tree's node count, 0 for the brute search
  int kt;                // the triangle tree's node count, 0 without a mesh
};

// K1 (forward: RECORD false, RADIANCE true), K2 (record, fused or not), K8
// (ANIMATED, CAM_ANIMATED), K5 and K6 (TREE, without and with ANIMATED) and
// K7 (TRI; K7 moving with ANIMATED; after the brute search, or after K5's /
// K6's walk with TREE) in one flat loop over persistent lanes
// (see the note at the top): each iteration, a lane with no path in flight
// starts its item's next sample, then every lane with a path runs one
// search and one bounce's shading. Items are handed out by the work counter
// `f.next`, one atomicAdd per warp for its idle lanes, in lane order.
// Forward mode: an item is a lane of `pix` / `sample0` with its samples
// sample0..spp-1 in order; record mode: that lane's one path. The launch
// zeroes `out` and `rec` first, so items with no path (padding lanes) and
// record rows after a path's end are never written. `n` is the table's row
// count (the brute search's staging room).
template <bool RECORD, bool RADIANCE, bool ANIMATED, bool CAM_ANIMATED, bool TREE, bool TRI>
__global__ void __launch_bounds__(TREE || TRI ? TREE_BLOCK : BRUTE_BLOCK) flat_kernel(
    const int32_t* __restrict__ smem, const int32_t* __restrict__ pix_in,
    const int32_t* __restrict__ sample0, const float* __restrict__ cam,
    const float* __restrict__ table, const Flat f, int n, int r, float t_min,
    float* __restrict__ out, int32_t* __restrict__ rec) {
  constexpr int NT = TREE || TRI ? TREE_BLOCK : BRUTE_BLOCK;
  extern __shared__ float4 sh4[];
  // The brute search's live rows, padded to a multiple of 4 with NaN
  // entries, whose discriminant is never >= 0: srow[q] (and with ANIMATED
  // smot[q] and ss2[q]). K5's and K6's nodes and skip links where they fit.
  const int cap = (n + 3) & ~3;
  float4* srow = sh4;
  float4* smot = sh4 + cap;
  float* ss2 = (float*)(sh4 + 2 * cap);
  const float4* nodes = f.nodes;
  const int32_t* miss = f.miss;
  int n4 = 0;
  if (TREE) {
    if (flat_smem_bytes(ANIMATED, true, n, f.k) > 0) {
      float4* s_nodes = sh4;
      int32_t* s_miss = (int32_t*)(sh4 + 2 * f.k);
      for (int q = threadIdx.x; q < 2 * f.k; q += NT) s_nodes[q] = f.nodes[q];
      for (int q = threadIdx.x; q < f.k; q += NT) s_miss[q] = f.miss[q];
      nodes = s_nodes;
      miss = s_miss;
    }
  } else {
    const int n_live = *f.live;
    n4 = (n_live + 3) & ~3;
    const float qnan = __int_as_float(0x7fffffff);
    const float4 pad = make_float4(qnan, qnan, qnan, qnan);
    for (int q = threadIdx.x; q < n4; q += NT) {
      if (ANIMATED) {
        srow[q] = q < n_live ? f.rows[3 * q] : pad;
        smot[q] = q < n_live ? f.rows[3 * q + 1] : pad;
        ss2[q] = q < n_live ? f.rows[3 * q + 2].x : qnan;
      } else {
        srow[q] = q < n_live ? f.rows[q] : pad;
      }
    }
  }
  __syncthreads();

  const int spp = smem[0];
  const uint32_t seed = (uint32_t)smem[1];
  const int width = smem[2];
  const int max_depth = smem[3];
  const int accum_from = RECORD ? smem[4] : 0;
  const int warp_lane = (int)(threadIdx.x & 31);
  const unsigned below = (1u << warp_lane) - 1u;  // the warp's lanes before this one

  // The lane's item, its next sample and its end; the path in flight.
  int item = 0, smp = 0, s_end = 0, bounce = 0;
  bool spent = false, live = false;
  uint32_t upix = 0;
  float fi = 0.0f, fj = 0.0f, w = 0.0f;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 0.0f, dy = 0.0f, dz = 0.0f;
  float tx = 0.0f, ty = 0.0f, tz = 0.0f, ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (;;) {
    // --- lanes whose item is done take the next ones ----------------------
    // One atomicAdd per warp, shared out in lane order; an item with no
    // sample to trace is passed over.
    for (;;) {
      const bool need = !spent && !live && smp >= s_end;
      const unsigned m = __ballot_sync(FULL_WARP, need);
      if (m == 0) break;
      const int leader = __ffs(m) - 1;
      int base = 0;
      if (warp_lane == leader) base = atomicAdd(f.next, __popc(m));
      base = __shfl_sync(FULL_WARP, base, leader);
      if (need) {
        item = base + __popc(m & below);
        spent = item >= r;
        if (!spent) {
          const int pix = pix_in[item];
          upix = (uint32_t)pix;
          fi = (float)(pix % width);
          fj = (float)(pix / width);
          const int s0 = sample0[item];
          smp = s0;
          // Record mode traces sample0 itself; padding lanes nothing.
          s_end = RECORD ? (s0 < NO_SAMPLE ? s0 + 1 : s0) : spp;
          ax = ay = az = 0.0f;
        }
      }
    }
    if (__all_sync(FULL_WARP, spent)) break;

    if (!spent) {
      if (!live) {  // the item's next sample, at its shutter fraction (K8)
        if (ANIMATED || CAM_ANIMATED) w = uniform4(upix, (uint32_t)smp, STREAM_TIME, seed).x;
        primary_ray<CAM_ANIMATED>(cam, upix, fi, fj, (uint32_t)smp, seed, w, ox, oy, oz,
                                  dx, dy, dz);
        tx = ty = tz = 1.0f;
        bounce = 0;
        live = true;
      }
      // --- closest sphere ----------------------------------------------------
      const float a_q = dx * dx + dy * dy + dz * dz;
      const float d_dot_o = dx * ox + dy * oy + dz * oz;
      const float o_sq = ox * ox + oy * oy + oz * oz;
      const float inv_a = 1.0f / a_q;
      float best = BIG;
      int win = -1;
      if (TREE) {
        tree_closest<ANIMATED>(nodes, miss, f.k, f.rows, table, ox, oy, oz, dx, dy, dz, a_q,
                               d_dot_o, o_sq, inv_a, w, t_min, best, win);
      } else {
        // One broadcast LDS.128 a row (two and an LDS.32 moving), four rows
        // a step, all four loaded before the first is tested; strict '<' in
        // row order. Each row's test keeps its update inside its root's
        // branch (brute_row, moving_row): a form that returned the root to
        // the caller compiled ~25% slower for K1 / K2 on an H100.
        const float two_w = 2.0f * w, w_sq = w * w;
        int k_win = -1;
        for (int k = 0; k < n4; k += 4) {
          if (!ANIMATED) {
            const float4 c0 = srow[k], c1 = srow[k + 1], c2 = srow[k + 2], c3 = srow[k + 3];
            brute_row(c0, k, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a, t_min, best,
                      k_win);
            brute_row(c1, k + 1, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a, t_min, best,
                      k_win);
            brute_row(c2, k + 2, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a, t_min, best,
                      k_win);
            brute_row(c3, k + 3, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a, t_min, best,
                      k_win);
            continue;
          }
          const float4 c0 = srow[k], c1 = srow[k + 1], c2 = srow[k + 2], c3 = srow[k + 3];
          const float4 m0 = smot[k], m1 = smot[k + 1], m2 = smot[k + 2], m3 = smot[k + 3];
          const float s20 = ss2[k], s21 = ss2[k + 1], s22 = ss2[k + 2], s23 = ss2[k + 3];
          moving_row(c0, m0, s20, k, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a,
                     w, two_w, w_sq, t_min, best, k_win);
          moving_row(c1, m1, s21, k + 1, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a,
                     w, two_w, w_sq, t_min, best, k_win);
          moving_row(c2, m2, s22, k + 2, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a,
                     w, two_w, w_sq, t_min, best, k_win);
          moving_row(c3, m3, s23, k + 3, ox, oy, oz, dx, dy, dz, a_q, d_dot_o, o_sq, inv_a,
                     w, two_w, w_sq, t_min, best, k_win);
        }
        win = k_win < 0 ? -1 : f.ids[k_win];
      }

      // --- K7: the mesh's closest triangle, strictly nearer -----------------
      int tid = -1;
      float tnx = 0.0f, tny = 0.0f, tnz = 0.0f;  // K7 moving: the winner's cross
      if (TRI) {
        tri_closest<ANIMATED>(f.tnodes, f.tmiss, f.kt, f.trows, ox, oy, oz, dx, dy, dz, w,
                              t_min, best, tid, tnx, tny, tnz);
      }

      int32_t word = 0;
      live = shade_bounce<RECORD, RADIANCE, TREE, ANIMATED, TRI>(
          table, f.tris, f.mats, upix, (uint32_t)smp, seed, bounce,
          !RECORD || bounce >= accum_from, max_depth, t_min, w, a_q, inv_a, best, win,
          tid, tnx, tny, tnz, ox, oy, oz, dx, dy, dz, tx, ty, tz, ax, ay, az, word);
      if (RECORD) rec[(size_t)bounce * r + item] = word;
      ++bounce;
      if (!live && ++smp >= s_end && RADIANCE) {  // the item's last path ended
        out[item] = ax;
        out[(size_t)r + item] = ay;
        out[2 * (size_t)r + item] = az;
      }
    }
  }
}

template <bool A, bool C, bool T, bool TR>
struct FlatFlags {
  static constexpr bool animated = A, cam_animated = C, tree = T, tri = TR;
};

// Call fn(FlatFlags<...>{}) with the instantiation for one search (TREE:
// K5 / K6; TRI: K7's stage after the sphere search; neither: the brute
// search) and K8's flags, each of the four combinations.
template <bool TREE, bool TRI, class F>
int flags_dispatch(int animated, int cam_animated, F&& fn) {
  if (animated && cam_animated) return fn(FlatFlags<true, true, TREE, TRI>{});
  if (animated) return fn(FlatFlags<true, false, TREE, TRI>{});
  if (cam_animated) return fn(FlatFlags<false, true, TREE, TRI>{});
  return fn(FlatFlags<false, false, TREE, TRI>{});
}

// fn with the flat loop's instantiation for a sphere tree (tree: K5, or K6
// with `animated`), a mesh (tri: K7, K7 moving with `animated`), both (a
// mesh beside a sphere tree: K5's walk then K7's, or K6's then K7
// moving's) or neither (K1 / K2, K8 with its flags).
template <class F>
int flat_dispatch(int animated, int cam_animated, bool tree, bool tri, F&& fn) {
  if (tree && tri) return flags_dispatch<true, true>(animated, cam_animated, fn);
  if (tree) return flags_dispatch<true, false>(animated, cam_animated, fn);
  if (tri) return flags_dispatch<false, true>(animated, cam_animated, fn);
  return flags_dispatch<false, false>(animated, cam_animated, fn);
}

// Launch the flat loop on `grid` blocks (the wrapper's, from the launch
// shape: as many as stay resident, none more than the R lanes need): the
// work counter, `out` and (RECORD) the `depth` rows of `rec` are zeroed on
// the stream first.
template <bool RECORD, bool RADIANCE, bool ANIMATED, bool CAM_ANIMATED, bool TREE, bool TRI>
int launch_flat(const int32_t* smem, const int32_t* pix, const int32_t* sample0,
                const float* cam, const float* table, const Flat& f, int n, int r,
                int depth, int grid, float t_min, float* out, int32_t* rec, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(f.next, 0, sizeof(int32_t), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(out, 0, 3 * (size_t)r * sizeof(float), st);
  if (e == cudaSuccess && RECORD) {
    e = cudaMemsetAsync(rec, 0, (size_t)depth * r * sizeof(int32_t), st);
  }
  if (e != cudaSuccess) return (int)e;
  if (grid > 0) {
    constexpr int NT = TREE || TRI ? TREE_BLOCK : BRUTE_BLOCK;
    flat_kernel<RECORD, RADIANCE, ANIMATED, CAM_ANIMATED, TREE, TRI>
        <<<grid, NT, flat_smem_bytes(ANIMATED, TREE, n, f.k), st>>>(
            smem, pix, sample0, cam, table, f, n, r, t_min, out, rec);
  }
  return (int)cudaGetLastError();
}

// One flat instantiation's launch shape into shape[0..5]: resident blocks
// per SM, SMs, threads per block, registers per thread, local (stack and
// spill) bytes per thread, dynamic shared memory per block. It also raises
// the kernel's dynamic shared memory limit to what this shape needs (never
// lowering it: the wrapper caches the shapes it launches on), so no launch
// sets or queries anything.
template <bool RECORD, bool RADIANCE, bool ANIMATED, bool CAM_ANIMATED, bool TREE, bool TRI>
cudaError_t flat_shape(int n, const Flat& f, int32_t* shape) {
  const void* kernel =
      (const void*)flat_kernel<RECORD, RADIANCE, ANIMATED, CAM_ANIMATED, TREE, TRI>;
  constexpr int NT = TREE || TRI ? TREE_BLOCK : BRUTE_BLOCK;
  const int bytes = flat_smem_bytes(ANIMATED, TREE, n, f.k);
  cudaFuncAttributes attr{};
  cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e == cudaSuccess && attr.maxDynamicSharedSizeBytes < bytes) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  int per_sm = 0, sms = 0, dev = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, bytes);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  shape[0] = per_sm;
  shape[1] = sms;
  shape[2] = NT;
  shape[3] = attr.numRegs;
  shape[4] = (int32_t)attr.localSizeBytes;
  shape[5] = bytes;
  return per_sm < 1 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

// flat_shape or launch_flat for the instantiation of one mode (RECORD,
// RADIANCE) that flat_dispatch picks: K5 / K6 where the launch has a sphere
// tree (f.k > 0), else the brute search; K7's stage after it where it has a
// triangle tree (f.kt > 0); K8's flags as given.
template <bool RECORD, bool RADIANCE>
int shape_of(int animated, int cam_animated, int n, const Flat& f, int32_t* shape) {
  return flat_dispatch(animated, cam_animated, f.k > 0, f.kt > 0, [&](auto fl) {
    using Fl = decltype(fl);
    return (int)flat_shape<RECORD, RADIANCE, Fl::animated, Fl::cam_animated, Fl::tree,
                           Fl::tri>(n, f, shape);
  });
}

template <bool RECORD, bool RADIANCE>
int variant(const int32_t* smem, const int32_t* pix, const int32_t* sample0,
            const float* cam, const float* table, const Flat& f, int n, int r, int depth,
            int grid, float t_min, int animated, int cam_animated, float* out, int32_t* rec,
            void* stream) {
  return flat_dispatch(animated, cam_animated, f.k > 0, f.kt > 0, [&](auto fl) {
    using Fl = decltype(fl);
    return launch_flat<RECORD, RADIANCE, Fl::animated, Fl::cam_animated, Fl::tree, Fl::tri>(
        smem, pix, sample0, cam, table, f, n, r, depth, grid, t_min, out, rec, stream);
  });
}

Flat make_flat(const float* frows, const int32_t* fids, const int32_t* flive,
               const float* fnodes, const int32_t* fmiss, const float* trows,
               const float* tris, const float* mats, const float* tnodes,
               const int32_t* tmiss, int32_t* next, int fk, int kt) {
  return Flat{(const float4*)frows, fids, flive, (const float4*)fnodes, fmiss,
              (const float4*)trows, tris, mats, (const float4*)tnodes, tmiss,
              next, fk, kt};
}

}  // namespace

extern "C" {

// Launch the forward megakernel on `stream` (struct Flat: the search's
// `frows`, `fids`, `flive`, `fnodes`, `fmiss`; the mesh's `trows`, `tris`,
// `mats`, `tnodes`, `tmiss`; the work counter `next`) on `grid` blocks: the
// walk over the FK
// nodes of a sphere tree when fk > 0 (K5; K6 with `animated`), else the
// brute search (K1), with the triangle stage over the KT nodes of a mesh's
// tree when kt > 0 (K7; K7 moving, whose `tris` are (M, 32) rows, with
// `animated`) after either sphere search; with `animated` or `cam_animated`
// nonzero, their motion variants (K8). Returns cudaGetLastError().
int crucible_megakernel_forward(const int32_t* smem, const int32_t* pix,
                                const int32_t* sample0, const float* cam,
                                const float* table, const float* frows, const int32_t* fids,
                                const int32_t* flive, const float* fnodes,
                                const int32_t* fmiss, const float* trows, const float* tris,
                                const float* mats, const float* tnodes, const int32_t* tmiss,
                                int32_t* next, int n, int fk, int kt, int grid, int r,
                                float t_min, int animated, int cam_animated, float* out,
                                void* stream) {
  const Flat f = make_flat(frows, fids, flive, fnodes, fmiss, trows, tris, mats, tnodes,
                           tmiss, next, fk, kt);
  return variant<false, true>(smem, pix, sample0, cam, table, f, n, r, 0, grid, t_min,
                              animated, cam_animated, out, nullptr, stream);
}

// Launch the record-mode megakernel: `rec` (depth, R) int32 packed decision
// words, `depth` = smem[3]; `out` (3, R) the fused radiance when `radiance`
// is nonzero, else zeros. The variants are the forward's: K2, K5, K6, K8
// and K7 (after the brute search or a tree walk). Returns cudaGetLastError().
int crucible_megakernel_record(const int32_t* smem, const int32_t* pix,
                               const int32_t* sample0, const float* cam,
                               const float* table, const float* frows, const int32_t* fids,
                               const int32_t* flive, const float* fnodes,
                               const int32_t* fmiss, const float* trows, const float* tris,
                               const float* mats, const float* tnodes, const int32_t* tmiss,
                               int32_t* next, int n, int fk, int kt, int grid, int r,
                               int depth, float t_min, int radiance, int animated,
                               int cam_animated, float* out, int32_t* rec, void* stream) {
  const Flat f = make_flat(frows, fids, flive, fnodes, fmiss, trows, tris, mats, tnodes,
                           tmiss, next, fk, kt);
  if (radiance) {
    return variant<true, true>(smem, pix, sample0, cam, table, f, n, r, depth, grid, t_min,
                               animated, cam_animated, out, rec, stream);
  }
  return variant<true, false>(smem, pix, sample0, cam, table, f, n, r, depth, grid, t_min,
                              animated, cam_animated, out, rec, stream);
}

// The flat loop's launch shape for an N-row table (the brute search) or a
// sphere tree of FK nodes (fk > 0: K5, K6), with a mesh's tree of KT nodes
// after either (kt > 0: K7), in one mode (record, radiance: the forward is
// 0, 1) with K8's flags, into shape[0..5]: resident blocks per SM, SMs,
// threads per block, registers per thread, local (stack and spill) bytes
// per thread, dynamic shared memory per block. Lets that instantiation take
// its dynamic shared memory. Returns a CUDA error.
int crucible_megakernel_flat_shape(int record, int radiance, int animated, int cam_animated,
                                   int n, int fk, int kt, int32_t* shape) {
  const Flat f = make_flat(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                           nullptr, nullptr, nullptr, nullptr, fk, kt);
  if (!record) return shape_of<false, true>(animated, cam_animated, n, f, shape);
  if (radiance) return shape_of<true, true>(animated, cam_animated, n, f, shape);
  return shape_of<true, false>(animated, cam_animated, n, f, shape);
}

const char* crucible_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
