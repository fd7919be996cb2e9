#!/usr/bin/env python3
"""On-card check of crucible_tpu_torch: build, compare, render, train.

Run from the root of a checkout on a machine with an NVIDIA Hopper GPU:

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds the CUDA kernels from ``crucible_tpu_torch/csrc`` with nvcc, one
   process per source, all at once, and the native BVH builder
   (``crucible_tpu_torch/native``) with g++.
3. Holds every kernel against its eager-torch twin on the card:
   - K1, the forward megakernel (persistent lanes in one flat bounce
     loop): ``smoke_scene`` 64 wide, 8 spp, depth 8 (every lane within
     1e-4); ``book1_end_scene`` 320 wide, 8 spp, depth 50, bit for bit; and
     the 1920x1080, 32 spp, depth 50 launch of the forward render, bit for
     bit on 64 pixel blocks (lanes are independent) and launch against
     launch. Its grid, resident blocks an SM and registers a thread, and
     its time beside its bound at the main shape.
   - K2, the record megakernel (fused and plain): smoke 64 wide and book1
     320 wide, 4 spp, depth 8, bit for bit; the 1920x1080 launch of the
     gradient step on 32768 lanes, and launch against launch; its launch
     shape and its time beside its bound.
   - K4, the replay forward: book1 320 wide and the 1920x1080 launch (on
     32768 lanes), bit for bit.
   - K3, the replay backward: book1 320 wide and 32768 lanes of the
     1920x1080 shape, within the JAX package's scheme for its replay
     backward (normalized differences above 2e-4 on < 0.5% of table
     entries and < 2% of ray entries, none above 0.1); and two launches
     give the same table cotangent, bit for bit. K4's and K3's launch
     shapes (grid, resident blocks an SM, registers, spill bytes, shared
     memory, where K3's partial lives) and their times beside their
     bounds at the main shape.
   - K4 and K3 at the depth-50 chunk's three buckets (1920x1080, 4 spp,
     as ``replay.replay_bucketed_2l`` lays them out: every lane's 6 head
     rows; the compacted slots of the paths that end in (6, 16] and in
     (16, 50], their throughput masked, radiance from row 6 on;
     ``tools/torch_replay_ab.deep_buckets``): K4 bit for bit (its denormal
     results flushed to zero where the card's ``index_add``, the plain
     version's radiance sum, flushes a probe's denormal sum; the probe's
     result is printed) and K3 within its scheme
     on 32768 lanes of each, K3's table
     cotangent the same bits twice; each launch timed beside its bound
     from its own alive and continuing rows.
   - The gradient step at book1 64 wide, 2 spp, depth 8 on the card
     against the same call on the CPU (the twins): loss within rel 1e-4,
     gradients within normalized 1e-3.
   - K10, the closest sphere hit, bit for bit on t, idx and hit against
     book1's table: 2^20 random rays, the primary rays of book1 320 wide at
     4 spp, and the two launches of the direct-AD step's shape: its
     1920x1080 4 spp primary rays (timed, with its launch shape: grid,
     resident blocks an SM, threads, rays a thread, registers, spill and
     shared bytes) and the rays of its second bounce, which start on
     sphere surfaces (timed); and 2^20 random rays against sphere_stress
     n7744's table, past the rows a block stages at a time (timed).
   - K9, the fused hit + fetch: garden's 1920x1080 primary rays against
     garden's table, 2^20 random rays against book1's, and book1's table
     with random motion columns and shutter fractions, bit for bit on all
     28 output rows.
   - The pixel schedule on the card against the CPU (garden 64 wide, 4
     spp, depth 8), and book1 320 wide, 8 spp, depth 50 through the pixel
     and the mega schedules: isclose(rtol=1e-3, atol=1e-3) on more than
     97% of pixel values, means within 2e-3.
   - K5, the walk of a static table's tree (SWEPT_LEAF spheres a leaf,
     nearer child first) in the flat loop: forward on ``sphere_stress``
     with 7744 and 1936 rows, 320 wide, 8 spp, depth 50, in full, and on 64
     pixel blocks of the n7744 1920x1080 32 spp d50 launch; record (fused
     and plain) on n1936 and n7744, 320 wide, 4 spp, depth 8, in full, and
     on 32768 lanes of each 1920x1080 launch. Each bit for bit against the
     plain walk and against the brute kernel (K1, K2) on the original
     table; the plain walk counts the node, row and root tests that give
     K5's bound (printed a search), with each launch shape. Then K5 at leaf
     sizes 8, 4, 16, 8 on n7744 (320 wide and 1920x1080).
   - K4 and K3 at n1936's 1936 rows (320 wide, 4 spp, depth 8): K4 bit for
     bit, K3 within its scheme and the same bits twice.
   - K4-legacy, the channel-major replay pair, on K2's records of book1
     at 320 wide and 1920x1080, 4 spp, depth 8: forward bit for bit with
     its plain version (32768 lanes at 1080p) and with K4; backward lane
     cotangents and table cotangent bit for bit with K3's, within K3's
     scheme against the plain version, the same bits twice; timed beside
     K4 and K3.
   - K8, the megakernel's motion variants, on "bouncing book1" (book1 in
     motion: its Lambertian small spheres rise over the first 1/48 s, and
     so does the camera; built here through the public API): each brute
     instantiation of the flat loop (moving spheres, moving camera, both)
     at 320 wide, 8 spp, depth 50, and both on 64 pixel blocks of the
     1920x1080 32 spp d50 launch, with each launch shape (grid, resident
     blocks an SM, registers, spill bytes, shared memory); K5's walk with a
     moving camera on sphere_stress n1936 320 wide, 8 spp, depth 50 (also
     against the brute camera variant on the original table). Each bit for bit against its plain version; K8 timed
     beside K1 on the same lanes of static and bouncing book1; and bouncing
     book1 through the pixel and mega schedules (isclose > 0.97, means
     within 2e-3).
   - K8 in record mode (fused and plain): each brute instantiation on
     bouncing book1 320 wide, 4 spp, depth 8; the walk with a moving camera
     on sphere_stress n1936 320 wide (also against the brute camera
     variant on the original table); 32768 lanes of bouncing book1's
     1920x1080 4 spp d8 launch (with its launch shape); and static book1's
     table given the animated flag (zero motion columns) against K2. Each
     bit for bit.
   - K6, the walk over the swept tree (an SAH tree whose boxes hold each
     sphere at shutter open and close, in place of the chunk-cull branch's
     256-row clusters) in the flat loop, on "bouncing stress"
     (sphere_stress with every Lambertian sphere rising as in bouncing
     book1, and the camera too; built here through the public API):
     forward (moving spheres and camera) on n7744 and n1936 at 320 wide,
     8 spp, depth 50, in full (n1936 also against the K8 brute search on
     the original table), and on K6_MAIN_BLOCKS (64) pixel blocks of the
     n7744 1920x1080 32 spp d50 launch; the same walk over book1's static
     table in a tree (K5) against K1 and the plain version, in full; record
     (fused and plain) on n1936 and n7744 320 wide, 4 spp, depth 8, in full
     (n1936 also against the K8 brute record), and on K6_RECORD_LANES
     (131,072) lanes of the n7744 1920x1080 4 spp d8 launch.
     Each bit for bit against the plain version, which counts the node,
     row and root tests that give K6's bound (printed a search), with each
     launch shape. Then K6 at leaf sizes 8, 4, 16, 8 on n7744 (320 wide and
     1920x1080), and K6 and the K8 brute search timed in turns on the same
     lanes of n1936 and of its first 1,024 rows at 320 wide and 1920x1080
     (the animated CULL_MIN_ROWS crossover), bit for bit.
   - K7, the triangle-BVH stage for static meshes (in the flat loop, over
     the tree's DFS skip links), on "torus_teapot"
     (demo.load_teapot's scene with a procedural torus of the teapot's
     6,320 triangles in place of teapot.obj; built here through the public
     API): forward on the 80-triangle fan 64 wide and on torus_teapot 320
     wide, 8 spp, depth 50, in full, and on 32 pixel blocks of its 1920x1080
     32 spp d50 launch; record (fused and plain) on torus_teapot 320 wide, 4
     spp, depth 8, in full and on 32768 lanes of its 1920x1080 launch. Each
     bit for bit against the plain version, which counts the node and row
     tests that give K7's bound, with each launch shape. Then the plain walk
     against the brute Möller–Trumbore over all rows on 2^16 random rays
     (winners differ on < 0.1%), and K7's time at leaf sizes 4, 8, 16, 32
     and 64.
   - K7 moving, the triangle stage over a moving mesh (with K8's moving
     sphere search), on "moving torus_teapot" (torus_teapot as
     demo.moving_teapot's movie, every triangle translated and scaled as
     its teapot is, at frame 30): forward on the moving fan 64 wide and on
     moving torus_teapot 320 wide, 8 spp, depth 50, in full, on 32 pixel
     blocks of its 1920x1080 32 spp d50 launch and in full on movie frame
     5 (400x225, 50 spp, depth 5); record (fused and
     plain) at 320 wide, 4 spp, depth 8, in full and on 32768 lanes of its
     1920x1080 launch; with K8's rising camera (forward 160 wide and the
     1920x1080 launch's 32 pixel blocks, record 320 wide); and K7 (Woop
     rows) with the camera on the static torus_teapot (forward 160 wide,
     record 320 wide). Each bit for bit against the plain version. K7
     and K7 moving timed in turns on one geometry (torus_teapot, and the
     same with a zero keyframe on every triangle) at 320 wide and on the
     1920x1080 32 spp d50 launch. Then the plain walk against the brute
     Möller–Trumbore with motion over all rows on 2^16 random rays with
     random shutter fractions (winners differ on < 0.1%).
   - The moving-scene gradient step on the card against the same call on
     the CPU, 64 wide, 2 spp, depth 8, on bouncing book1 (its radiometric
     leaves, fault C4) and on smoke with its ball and camera moving (every
     leaf): records equal on > 0.999 of the lanes; on the card's records,
     loss within rel 1e-4 and gradients within normalized 1e-3; each on its
     own records, loss within rel 2e-3 and gradients within 5e-3. The fan's
     step likewise (both sides built at leaf 32), from the CPU's rays and
     records: loss within rel 1e-4, radiometric leaves within 1e-3; and
     the moving fan's so.
4. The forward render: ``render.render_image`` of book1 at 1920x1080, 32
   spp, depth 50; checks the image, counts K1's launches, writes
   ``build/chip_smoke_book1.png``.
5. The gradient step, book1 at 1920x1080, 4 spp, depth 8, every pixel:
   - ``grad.loss_and_grad``: one warm step, then 3 timed steps;
   - ``grad.record_decisions``, then 3 frozen-decision steps
     (``loss_and_grad(rec=...)``);
   - 3 steps of ``grad.make_train_step`` with Adam on ``tex_color`` and
     ``mat_emission``: the loss must go down.
6. The staged forward render: ``render.render_image`` of garden (the
   spherical sky) at 1920x1080, 32 spp, depth 50, which ``auto`` sends to
   the pixel schedule: K9 launches and K1 does not; writes
   ``build/chip_smoke_garden.png``.
7. The direct-AD gradient step, ``loss_and_grad(method="ad")`` on book1 at
   1920x1080, 4 spp, depth 8, every pixel: one warm step, 3 timed steps,
   peak memory; K10 launches; held against the replay step of phase 5
   (loss within rel 2e-3, ``tex_color`` and ``mat_emission`` gradients
   within normalized 5e-3); one step under the profiler.
8. The big-scene forward render: ``render.render_image`` of
   ``sphere_stress(1920, copies=16)`` (7744 rows) at 1920x1080, 32 spp,
   depth 50: the walk launches once and K1 never; writes
   ``build/chip_smoke_stress.png``.
9. The big-scene gradient step, ``sphere_stress(1920, copies=4)`` (1936
   rows) at 1920x1080, 4 spp, depth 8, every pixel: as phase 5 without the
   train steps (the record walk, K3 and K4 launch, K2 never), and one
   direct-AD step held against the replay step.
10. The forward render in motion: ``render.render_image`` of bouncing
   book1 at 1920x1080, 32 spp, depth 50 (``auto`` -> mega: one K8 launch,
   no K1 launch; writes ``build/chip_smoke_bounce.png``), and of
   sphere_stress n1936 with a moving camera at 320 wide (one K8 walk).
11. Movies: ``render.render_movie`` of ``first_movie(duration=0.25)``
   (6 frames, 400 wide, 50 spp, depth 5; the pixel schedule, K9) and of a
   2-frame bouncing book1 at 1920x1080, 32 spp, depth 50 (two K8
   launches), into a temporary directory; then bouncing book1's frame 0 by
   phase (:func:`frame_phases`: build, launch to synchronize, fetch and
   quantization, PPM write, and the per-pixel writer the port had before
   on the same frame, which must write the same bytes).
   Each main-path phase zeroes the launch counts before it and reads them
   after; a kernel of the phase that was not launched fails the run.
12. Gradients through the eager replay, ``grad.loss_and_grad`` at
   1920x1080, 4 spp, depth 8, every pixel: bouncing book1 (K8 record; a
   warm and 2 timed steps, ``record_decisions`` and 2 frozen-decision
   steps, the step cut into its phases, one step under the profiler),
   sphere_stress n7744 (K5 record; 7744 rows are above the replay kernels'
   2048) and garden (K2 record; the spherical sky, ``sky_image`` a leaf):
   wall time, Mrays/s, peak memory; K3 and K4 never launch. Then the replay
   against direct AD on bouncing book1 and garden at 320x180, 2 spp, depth
   8: loss within rel 2e-3, radiometric gradients within normalized 5e-3
   (garden's sky image over 8x8-texel blocks: the nearest texel is a
   choice the record does not hold).
13. The mesh: ``render.render_image`` of torus_teapot at 1920x1080, 32
   spp, depth 50, twice (``auto`` -> mega: one K7 launch each, no K1; writes
   ``build/chip_smoke_torus.png``), and its ``grad.loss_and_grad`` at
   1920x1080, 4 spp, depth 8 (K7 record, then the eager replay's triangle
   branch; K3 and K4 never launch): a warm and 2 timed steps, the step by
   phase, peak memory, ``record_decisions`` and a frozen-decision step.
14. The moving mesh (K7 moving), moving torus_teapot at frame 30:
   ``render.render_image`` at 1920x1080, 32 spp, depth 50, twice (one K7
   moving launch each and no other; writes
   ``build/chip_smoke_moving_torus.png``), beside the scene build's time.
15. Its movie: ``render.render_movie`` at 400x225, 50 spp, depth 5, cut
   from 120 frames to 6, twice (six K7 moving launches each), beside the
   scene build's time for each frame (the lowering of its 18,960 vertex
   timelines and the SAH tree, redone every frame); frame 3's build with
   the native and the Python BVH builder (:func:`builder_ab`, the trees
   bit for bit), and the frame by phase.
16. Its gradient, ``grad.loss_and_grad`` at 1920x1080, 4 spp, depth 8 (K7
   moving record, then the eager replay's moving-triangle branch; K3 and K4
   never launch): a warm and 2 timed steps, the step by phase, peak
   memory, ``record_decisions`` and a frozen-decision step.
17. It under a rising camera (K7 moving with K8's camera): ``render_image``
   at 1920x1080, 32 spp, depth 50, twice.
18. The animated big scene (K6): ``render.render_image`` of bouncing
   stress n7744 at 1920x1080, 32 spp, depth 50, twice (one K6 launch each
   and no other; writes ``build/chip_smoke_bounce_stress.png``), beside the
   scene build's time.
19. Its movie: ``render.render_movie`` at 400x225, 50 spp, depth 5, cut to
   2 frames, the launches of each frame read (frame 0 K6; frame 1, past
   the keyframe, K6 with zero deltas or K5), beside each frame's build and
   the swept tree's part of it; frame 0's swept tree and scene build with
   the native and the Python BVH builder (the tables bit for bit), and the
   frame by phase.
20. Its gradient, ``grad.loss_and_grad`` at 1920x1080, 4 spp, depth 8 (K6
   record, then the eager replay; K3 and K4 never launch): a warm and 2
   timed steps, the step by phase, peak memory, ``record_decisions`` and a
   frozen-decision step.
21. Cross-checks on n1936: the replay against direct AD at 320x180, 2 spp,
   depth 8 (loss rel 2e-3, radiometric gradients normalized 5e-3), and the
   card against the CPU at 64 wide, 2 spp, depth 8 (records equal on
   every lane with the CPU's plain version taking the card's sin and cos,
   and on > 0.998 of the lanes with each device's own; from the card's records,
   loss within rel 1e-4 and radiometric gradients within normalized 1e-3).
22. The depth-50 gradient, book1 at 1920x1080, 4 spp, depth 50 unless
   named: (A) the deep chunk, ``grad.loss_and_grad`` (two-level record,
   depth buckets; K2 twice, K3 three times), a warm and 2 timed steps, the
   step by phase, the capacities' fill, against ``grad_split=False`` on
   the same lanes (loss rel 1e-5, radiometric gradients normalized 1e-4);
   (B) the 500 spp budget, ``loss_and_grad_accum(chunk_spp=4,
   recover=True)``, 125 chunks timed to the loss on the host, and the host
   syncs of one chunk; (D) ``record_decisions`` at depth 50 and two
   frozen-decision steps through ``replay_bucketed`` (K4 and K3), against
   the frozen unsplit replay and the inline chunk (rel 1e-5);
   (C) (A) and (D) under ``CRUCIBLE_REPLAY_BLOCKED=0``: K4-legacy launches
   and K4 / K3 do not, the same losses, the table's leaves bit for bit and
   the camera's within normalized 1e-3; (E) the mirror shell (32x32, 2
   spp, depth 16): the default chunk poisons, the recovery ladder equals
   ``grad_split=False`` bit for bit, ``loss_and_grad_accum(chunk_spp=1)``
   recovers, and three recovering Adam steps equal one, a checkpoint, a
   load and two, bit for bit; (F) bouncing book1 320x180, 4 spp, depth 50
   (K8 record, the eager replay's buckets) against ``grad_split=False``.
23. Image textures and nested checkers (:func:`textured_path`, which says
   more): a generated 1024x512 earth map in a temporary asset directory;
   ``earth`` (400x225, 500 spp, d50) and ``nested_checkers`` (400 wide,
   100 spp, d50) through ``auto`` -> ``record`` (K2 a sample chunk, no K1),
   by phase; record against pixel (K10) on the card; K2 on one
   record-schedule chunk of earth and K10 on its primary rays, bit for bit
   against their plain versions; the texel gradient at 1920x1080, 4 spp,
   d8, by phase, two steps' gradients bit for bit, and the card against
   the CPU on the same records over a band of rows; ``train_demo`` at its
   default 1920 wide, 3 steps against 2, a checkpoint and a resume, bit
   for bit.
24. The command line (:func:`cli_path`, which says more):
   ``cli.main`` in this process for book1 at 1920 wide, 500 spp, depth 50
   (8 K1 chunks of its progress; the film against one dispatch) and for
   the default movie (6 frames, K9); ``python -m crucible_tpu_torch.cli``
   in a process of its own.
25. A mesh beside a big sphere table (main path 23, :func:`mesh_walk_path`,
   which says more): sphere_stress n7744 with torus_teapot's torus at
   1920x1080 32 spp d50 through auto (K5's walk then K7's, one launch) and
   its 4 spp d8 record, each against K1 + K7 bit for bit and against the
   plain pair; the same scene at 320x180 on the ``pixel`` schedule against
   the pair; bouncing stress n1936 with the torus rising through K6's walk
   then K7 moving's, against K8 + K7 moving.
26. The staged record (main path 24, :func:`staged_record_path`): book1
   1920x1080 4 spp d8 through ``replay.trace_record`` (K10 a bounce)
   against the record megakernel; K10 on its primary rays against its
   plain version; the gradient step of a 40-triangle fan without a BVH at
   1024x1024 4 spp d8 ('auto' -> the staged record), and card against CPU.
27. Sharded renders and gradients (main path 25, :func:`sharded_path`): a
   process group of one over tcp://127.0.0.1 with ``nccl``; book1
   1920x1080 32 spp d50 as 1 band and as 4 bands on cuda:0 against one
   dispatch, bit for bit, K1's launches counted; ``loss_and_grad_sharded``
   over 4 shards against one call.
28. Exact-time motion, a key strictly inside the shutter (main path 26,
   :func:`exact_path`, which says more): the JAX package's oracles at
   1920x1080 4 spp (the flash, the BVH wall teleport, the camera
   teleport); book1 under a camera keyed at 1/96 s through ``pixel`` (K9)
   and its gradient step (the staged record with K10, the replay with K4 /
   K3), each kernel against its plain version; bouncing book1 keyed at
   1/96 s through the exact branch (its lanes, chunks and peak memory) and
   its step by phase; the torus rising inside the shutter through the BVH
   walk's vertex hook at 320x180; card against CPU at 64 wide.
29. The golden check (main path 27, :func:`golden_path`,
   ``tools/torch_golden.py``): every config of
   ``tests/goldens/golden_tpu_v1.npz`` (the JAX package's renders at 64 px,
   8 spp, depth 8) through its production schedule on the card and
   ``book1_deep50`` through the deep gradient path's forward, held at the
   JAX harness's bounds; earth and load_teapot not held without their
   original assets; direct AD against the replay, three central-difference
   checks and the depth-50 gradients; each row's launches held to its
   route (K1, K5, K9, K2; K10, K2, K3).
30. The ``pixel`` schedule by stage (main path 28, :func:`pixel_profile_path`,
   ``tools/torch_profile_persistent.py``): book1 400 wide, 32 spp, depth 50
   at 2^20 target lanes; ray generation, K9 and the fused bounce an
   iteration (CUDA events and device time), the render's iterations (one
   K9 launch each), its split and the device's idle share.
31. Prints a JSON line describing each kernel (times at the comparison
   shape, where kernel and twin run the same inputs in full; K5's, K6's
   and others' also at their main shape), the card's line again, and, as
   the last line, ``{"ok": true, "device": {...}}``.

Any failed phase raises and the script exits non-zero. Without CUDA, or
without the package beside this file, it exits non-zero before printing a
result.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import warnings
from dataclasses import replace
from pathlib import Path

REPO = Path(__file__).resolve().parent

# Published peaks of one H100 SXM (NVIDIA data sheet): FP32 outside the
# tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# FP32 operations counted from the kernel sources (multiplies, adds,
# divides, square roots; compares and selects not counted):
SEARCH_OPS = 22  # one ray against one table row in the closest-hit loop
# K10's and K9's searches (csrc/sphere_hit.cu, csrc/sphere_shade.cu)
# per (ray, active row): up to the discriminant, then the square root and
# the two roots where it is not negative. HIT_DISC_OPS counts the static
# arithmetic, which K10 always takes and K9 takes where no staged row
# moves (book1, garden, n7744); SHADE_DISC_OPS the moving arithmetic
# (motion terms included), K9's on a table with motion columns.
HIT_DISC_OPS, SHADE_DISC_OPS, ROOT_OPS = 17, 35, 5
ROW_OPS = 52  # a replayed row: quadratic, hit point, normal, unit d, radiance
SCATTER_OPS = 45  # a continuing row: albedo, the sampled direction, scatter
ADJOINT_ROW_OPS = 60  # the adjoint of a row's radiance and pass-through
ADJOINT_SCATTER_OPS = 150  # the adjoint of a continuing row's scatter


def replay_ops(alive: int, cont: int) -> int:
    """FP32 operations of the replay forward (K4) over ``alive`` replayed
    rows, ``cont`` of them continuing."""
    return alive * ROW_OPS + cont * SCATTER_OPS


def replay_vjp_ops(alive: int, cont: int) -> int:
    """FP32 operations of the replay's VJP (K3): the forward once, then the
    adjoint of every row. K3 runs each row's forward twice (phase 1 stores
    the carries, the reverse sweep recomputes the row from its carry); that
    is how it is built, not work the function needs."""
    return replay_ops(alive, cont) + alive * ADJOINT_ROW_OPS + cont * ADJOINT_SCATTER_OPS


# K5's walk: a node's slab test (the margin's 6 adds, 6 subtractions and 6
# multiplies); a leaf row costs K10's HIT_DISC_OPS, plus ROOT_OPS where the
# discriminant is not negative.
SLAB_OPS = 18
# K8: a moving row adds w (cd.d) and w (cd.o) (7 operations each) and
# 2w s1 + w^2 s2 (4) to a search row; a moving camera costs CAM_OPS per
# sample issued (the lerps, two normalizations, the cross products, du, dv
# and pixel00).
MOTION_SEARCH_OPS = SEARCH_OPS + 18
CAM_OPS = 81
# K6's walk over the swept tree: K5's slab test a node, and a moving leaf
# row costs K10's HIT_DISC_OPS plus the motion terms (csrc/megakernel.cu
# tree_closest, moving_terms), ROOT_OPS more where the discriminant is not
# negative (counted by CULL_COUNTS).
MOVING_DISC_OPS = HIT_DISC_OPS + MOTION_SEARCH_OPS - SEARCH_OPS
# K7's walk: a node's slab test (6 subtractions and 6 multiplies), and a
# leaf row's Woop test (d'_z 5, o'_z 6, the division, t, o'_x and d'_x 11,
# u 2, o'_y and d'_y 11, v 2, u + v 1: 40 with t's multiply), the rows the
# plain walk tested (TRI_COUNTS), beside the sphere search's SEARCH_OPS.
TRI_SLAB_OPS = 12
WOOP_OPS = 40
# K7 moving's leaf row (csrc/megakernel.cu tri_closest<true>): the edge
# lerps 12, p = d x e2 9, det 5, its reciprocal 1, t = o - (v0 + w v0d) 9,
# u 6, q = t x e1 9, v 6, t 6, u + v 1: 64; beside the moving sphere
# search's MOTION_SEARCH_OPS a row and, with the camera, CAM_OPS a sample.
MT_MOVING_OPS = 64
N_SUB = 32768  # lanes of a 1920x1080 launch held against the twin
# K6's launches at 1920x1080 held against the plain walk: pixel blocks of
# the forward's 4080 and lanes of the record's 8,294,400. Every 320-wide
# launch is held in full. The plain walk's lockstep loop (one step a node,
# up to ~150 steps a search, each a few dozen small launches) bounds them.
# The walks' plain forwards (K5, K6, K7, K8) run by sample
# (run_megakernel_reference(by_sample=True): a lane's samples side by side,
# a step a bounce, each lane's sum in the kernel's order), several times
# fewer steps than one sample after another.
K6_MAIN_BLOCKS, K6_RECORD_LANES = 64, 4 * N_SUB


def bouncing_book1(demo, width: int, keyframe: float = 1.0 / 48.0, spheres: bool = True):
    """Book1 in motion, the bouncing spheres of "Ray Tracing: The Next
    Week" (section 2): every Lambertian small sphere rises by a random
    height (numpy seed 11) over the first 1/48 s, and so does the camera's
    position, by 0.5. Frame 0's shutter holds no keyframe strictly inside
    it, so its motion is linear. ``keyframe`` 1/96 s puts the key inside
    that shutter (exact-time motion); ``spheres`` False keys the camera
    alone. tests/torch_motion_scenes.py builds the same scene."""
    return bounce(demo.book1_end_scene(width=width), ("small",) if spheres else (), keyframe)


def bouncing_stress(demo, width: int, copies: int):
    """``demo.sphere_stress(width, copies)`` in motion as bouncing_book1
    moves book1 (book1's small spheres, then the copies' ``stress{k}``):
    copies=4 has 1,936 table rows, copies=16 7,744, whose moving table the
    megakernel walks in its swept tree (K6). tests/torch_motion_scenes.py
    builds the same scene."""
    return bounce(demo.sphere_stress(width=width, copies=copies), ("small", "stress"))


def bounce(sc, prefixes, keyframe: float = 1.0 / 48.0):
    """Raise every Lambertian sphere named ``<prefix><k>`` by U(0, 0.5)
    (numpy seed 11, in order) up to ``keyframe`` (1/48 s), and the camera's
    position by 0.5; returns ``sc``."""
    rng = __import__("numpy").random.default_rng(11)
    for prefix in prefixes:
        k = 0
        while sc.id_vendor.alias_lookup(f"{prefix}{k}") is not None:
            alias = f"{prefix}{k}"
            el = next(e for e in sc.elements if e.id == sc.id_vendor.alias_lookup(alias)[0])
            if type(el.material).__name__ == "Lambertian":
                sc.translate_y(float(rng.uniform(0.0, 0.5)), keyframe, "lerp", "local", alias)
            k += 1
    sc.cam_translate_y(0.5, keyframe, "lerp", "local", "from")
    return sc


def fan(scene, width: int, count: int = 80):
    """The 80-triangle fan over a ground sphere of the JAX package's
    tests/test_integrator.py:320-361, through ``scene`` (the port's
    models.scene); ``count``: its first triangles only (40: a mesh without
    a BVH). tests/torch_mesh_scenes.py builds the same scene."""
    sc = scene.Scene.new_image(1.0, width)
    cam = sc.scene_cam
    cam.look_from((0.0, 1.5, 4.0))
    cam.look_at((0.0, 0.3, 0.0))
    cam.set_vfov(45.0)
    sc.add_element(
        scene.Sphere((0.0, -100.0, 0.0), 100.0, scene.Lambertian.from_color((0.6, 0.6, 0.2))),
        "ground",
    )
    for i in range(count):
        a0, a1 = 2 * math.pi * i / 80, 2 * math.pi * (i + 1) / 80
        sc.add_element(scene.Triangle(
            (0.8 * math.cos(a0), 0.3 + 0.1 * math.sin(5 * a0), 0.8 * math.sin(a0)),
            (1.2 * math.cos(a1), 0.35, 1.2 * math.sin(a1)), (0.0, 0.5, 0.0),
            scene.Metal((0.8, 0.7, 0.6), 0.2)), f"tri{i}")
    return sc


def torus_teapot(scene, width: int, movie: bool = False):
    """demo.load_teapot's scene (camera, the metal, the checker ground) with
    a procedural torus of the teapot's 6,320 triangles in place of
    teapot.obj, which the repository lacks: axis vertical, centred at (0,
    0.61, 0), major radius 1.5, minor radius 0.6, 79 x 40 quads of two
    triangles; ``movie``: a 5 s movie at demo.moving_teapot's 50 spp, depth
    5. tests/torch_mesh_scenes.py builds the same scene."""
    if movie:
        sc = scene.Scene.new_movie(16.0 / 9.0, width, 24.0, 180.0, 5.0)
    else:
        sc = scene.Scene.new_image(16.0 / 9.0, width, 24, 180.0)
    cam = sc.scene_cam
    cam.set_samples(50 if movie else 200)
    cam.set_max_depth(5 if movie else 50)
    cam.look_from((13.0, 10.0, 3.0))
    cam.look_at((0.0, 0.0, 0.0))
    cam.set_vfov(20.0)
    cam.set_defocus_angle(0.6)
    cam.set_focus_dist(10.0)

    add_torus(scene, sc)
    checker = scene.CheckerTexture.from_colors(0.32, (0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    sc.add_element(
        scene.Sphere((0.0, -1000.0, 0.0), 1000.0, scene.Lambertian.from_texture(checker)),
        "ground",
    )
    return sc


def add_torus(scene, sc):
    """Add torus_teapot's torus to ``sc``: 6,320 metal triangles
    ``tri0``.. (axis vertical, centred at (0, 0.61, 0), major radius 1.5,
    minor radius 0.6, 79 x 40 quads of two triangles); returns ``sc``."""
    def point(i, j):
        th, ph = 2 * math.pi * i / 79, 2 * math.pi * j / 40
        rr = 1.5 + 0.6 * math.cos(ph)
        return (rr * math.cos(th), 0.61 + 0.6 * math.sin(ph), rr * math.sin(th))

    metal = scene.Metal((0.8, 0.3, 0.5), 0.05)
    k = 0
    for i in range(79):
        for j in range(40):
            a, b, c, d = point(i, j), point(i + 1, j), point(i + 1, j + 1), point(i, j + 1)
            for tri in ((a, b, c), (a, c, d)):
                sc.add_element(scene.Triangle(*tri, metal), f"tri{k}")
                k += 1
    return sc


def torus_beside_stress(demo, scene, width: int, copies: int, moving: bool = False):
    """A mesh beside a big sphere table: ``demo.sphere_stress(width,
    copies)`` with torus_teapot's torus around book1's glass sphere;
    ``moving``: bouncing stress with every triangle rising by 0.5 over the
    first 1/48 s too (linear in frame 0's shutter), a moving mesh beside a
    moving table. tests/torch_mesh_scenes.py builds the same scenes."""
    sc = (bouncing_stress(demo, width, copies) if moving
          else demo.sphere_stress(width=width, copies=copies))
    add_torus(scene, sc)
    if moving:
        for k in range(6320):
            sc.translate_y(0.5, 1.0 / 48.0, "lerp", "local", f"tri{k}")
    return sc


def moving_fan(scene, width: int):
    """The fan with each triangle translated by 0.5 along x over the first
    second, at frame 6 (the JAX package's tests/test_replay.py:210-220
    animation). tests/torch_mesh_scenes.py builds the same scene."""
    sc = fan(scene, width)
    for i in range(80):
        sc.translate_x(0.5, 1.0, "lerp", "world", f"tri{i}")
    sc.scene_cam.frame = 6
    return sc


def moving_torus_teapot(scene, width: int):
    """torus_teapot as demo.moving_teapot's movie (5 s at 24 fps, shutter
    180 degrees, 50 spp, depth 5) with its animation on every triangle:
    translated by (0, 5, 0) over 2.5 s, scaled to 0.5 by 3 s; at frame 30
    (shutter [1.25, 1.2708] s: both keyframes in motion, none inside).
    tests/torch_mesh_scenes.py builds the same scene."""
    sc = torus_teapot(scene, width, movie=True)
    for k in range(6320):
        sc.translate_point((0.0, 5.0, 0.0), 2.5, "lerp", "local", f"tri{k}")
        sc.scale_all_uniform(0.5, 3.0, "lerp", f"tri{k}")
    sc.scene_cam.frame = 30
    return sc


def rising_camera(sc):
    """Keyframe the camera's position up by 2 over the first 2.5 s (linear
    in frame 30's shutter); returns ``sc``."""
    sc.cam_translate_y(2.0, 2.5, "lerp", "local", "from")
    return sc


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` calls, by CUDA events."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn):
    """(result, milliseconds) of one synchronized call."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, 1e3 * (time.perf_counter() - t0)


def bound(ops: float, nbytes: float) -> tuple[float, str]:
    """(least milliseconds, what bounds it) from the published peaks."""
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def statistical_match(a, b, what: str) -> float:
    """Assert the cross-path bounds; return max |a - b|."""
    import torch

    close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item()
    dmean = abs(a.mean().item() - b.mean().item())
    err = (a - b).abs().max().item()
    print(f"  {what}: isclose {close:.5f}, |mean diff| {dmean:.3g}, max|diff| {err:.3g}")
    if not close > 0.99 or not dmean <= 2e-3:
        raise AssertionError(f"{what}: kernel and eager version disagree")
    return err


def bit_equal(a, b, what: str) -> float:
    """Assert a == b bit for bit; return max |a - b| (0)."""
    import torch

    err = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    print(f"  {what}: max|diff| {err:.3g}")
    if not torch.equal(a, b):
        raise AssertionError(f"{what}: kernel and eager twin differ")
    return err


def index_add_flush(dev) -> tuple[float, float]:
    """(0 + 1e-40 by torch's CUDA ``index_add``, 1e-40 * 1 by an elementwise
    product). The plain replay sums each lane's radiance with ``index_add``
    (``replay_kernel._walk``), built on the float atomic add, which flushes
    denormal results to zero (PTX ``red.add.f32``); its products keep them."""
    import torch

    tiny = torch.full((1,), 1e-40, device=dev)
    at = torch.zeros(1, dtype=torch.long, device=dev)
    summed = torch.zeros(1, device=dev).index_add(0, at, tiny)
    return summed.item(), (tiny * torch.ones(1, device=dev)).item()


def bit_equal_ftz(a, b, what: str) -> float:
    """Assert a == b bit for bit once a's denormal entries are flushed to
    zero: the plain replay on the card sums radiance with ``index_add``,
    which flushes a denormal sum to 0.0 where the kernel keeps it (see
    :func:`index_add_flush`). Return max |a - b|."""
    import torch

    tiny = (a != 0) & (a.abs() < torch.finfo(a.dtype).tiny)
    print(f"  {what}: {int(tiny.sum())} denormal entries in the kernel's output")
    return bit_equal(torch.where(tiny, torch.zeros_like(a), a), b, what)


def k3_scheme(got, want, what: str) -> float:
    """Hold K3's cotangents to the JAX replay backward's scheme; return the
    largest absolute difference."""
    worst = 0.0
    for name, a, b in zip(("g_table", "g_o", "g_d"), got, want):
        if not bool(a.isfinite().all()):
            raise AssertionError(f"{what} {name}: non-finite")
        scale = max(b.abs().max().item(), 1e-6)
        nd = (a - b).abs() / scale
        frac, top = (nd > 2e-4).float().mean().item(), nd.max().item()
        worst = max(worst, (a - b).abs().max().item())
        print(f"  {what} {name}: outliers {frac:.5f}, max normalized {top:.3g} "
              f"(scale {scale:.4g})")
        cap = 0.005 if name == "g_table" else 0.02
        if not (frac < cap and top < 0.1):
            raise AssertionError(f"{what} {name}: kernel and twin disagree")
    return worst


def search_ops(o, d, w, table, disc_ops: int) -> int:
    """FP32 operations of a closest-sphere search of these rays against the
    table's active rows: ``disc_ops`` for each (ray, active row) pair, and
    ROOT_OPS more where the discriminant is not negative (the kernels skip
    the rest), counted with the kernels' motion-form discriminant."""
    import torch

    act = table[:, 5] > 0
    rows = table[act]
    c, s0, cd = rows[:, 0:3], rows[:, 4], rows[:, 24:27]
    s1, s2 = rows[:, 28], rows[:, 29]
    a = (d * d).sum(1, keepdim=True)
    dot_o = (d * o).sum(1, keepdim=True)
    o_sq = (o * o).sum(1, keepdim=True)
    n_ok = 0
    step = max(1, (1 << 24) // max(rows.shape[0], 1))
    for lo in range(0, o.shape[0], step):
        sl = slice(lo, lo + step)
        wv = w[sl, None]
        dc = d[sl] @ c.t() + wv * (d[sl] @ cd.t())
        oc = o[sl] @ c.t() + wv * (o[sl] @ cd.t())
        csr = s0 + 2.0 * wv * s1 + wv * wv * s2
        h = dc - dot_o[sl]
        disc = h * h - a[sl] * (csr - 2.0 * oc + o_sq[sl])
        n_ok += int((disc >= 0).sum())
    return o.shape[0] * rows.shape[0] * disc_ops + n_ok * ROOT_OPS


# Main path 21 (textured_path): the image rows over which the card's texel
# gradient is held against the CPU's, the record-schedule chunk K2 is held
# on (400x225, depth 50), and the most of the band's texel lookups that may
# choose another texel on the card than on the CPU (about 5e-5 measured).
BAND_ROWS = 68
CHUNK_K2_SPP = 14
FLIP_LIMIT = 2.5e-4


def textured_path(dev, kernels: dict, mark) -> dict:
    """Main path 21, image textures and nested checkers through the
    ``record`` schedule, on ``dev`` -> its cells (times, launches, peaks).
    Adds this path's K2 and K10 launches to ``kernels``.

    1. A generated 1024x512 earth map (``io.procedural.generate_earth_texture``)
       goes into a temporary ``ASSET_DIR``: as ``earthmap.jpg`` where PIL
       imports, else as ``earthmap.hdr`` with the earth scene built around
       an ``ImageTexture`` of it. The line ``earth texture:`` says which.
    2. ``earth`` at its demo size, 400x225, 500 spp, depth 50, through
       ``render.render_image``: ``auto`` must take ``record``; K2 launches
       (one a sample chunk) and K1 does not; the time by phase (record,
       replay: ``replay.PHASE_SECONDS``) and the peak memory; writes
       ``build/chip_smoke_earth.png``.
    3. ``nested_checkers`` at 400 wide, 100 spp, depth 50, likewise
       (``build/chip_smoke_nested.png``).
    4. The ``record`` schedule against ``pixel`` on the card, earth at 8 spp
       and nested_checkers at 4 spp, depth 50: isclose(1e-3, 1e-3) on > 0.99
       of pixel values, means within 2e-3 (the JAX package's
       ``tests/test_replay.py:356-370`` bound). K10 (the pixel schedule's
       closest hit) launches there, and is held bit for bit against its
       plain version on earth's primary rays.
    5. K2's words (and fused radiance) on one record-schedule chunk of earth
       (400x225, 14 spp, depth 50) bit for bit against its plain version,
       timed beside its bound.
    6. The texel gradient, earth at 1920x1080, 4 spp, depth 8, every pixel:
       ``grad.loss_and_grad`` (K2 record, then the eager replay; K3 and K4
       never launch), a warm and 2 timed steps whose gradients must agree
       bit for bit (the replay's gathers add in a fixed order,
       ``ops.gather``), the step by phase, the shares of ``index_add`` and
       of the gathers' backward (sort, segment sum) under the profiler, the
       peak memory. Then the card against the CPU on the same records, over
       a band of ``BAND_ROWS`` image rows (the CPU's replay of the whole
       frame takes about a minute): loss within rel 1e-4, the radiometric
       leaves within normalized 1e-3. The card's sin, cos, atan2 and acos
       round unlike the CPU's, so a few lookups choose another texel on the
       two devices (``textures.TEXEL_IDS`` records each lookup's texel):
       their texels are left out of the texel comparison, and there may be
       at most ``FLIP_LIMIT`` of the band's lookups.
    7. ``train_demo`` on earth at its default width, 1920: 3 steps, and 2
       steps then a resume to 3, bit for bit; the loss goes down.

    Any failed check raises."""
    import numpy as np
    import torch
    from torch.profiler import DeviceType, ProfilerActivity, profile

    from crucible_tpu_torch import grad, train_demo
    from crucible_tpu_torch.io import hdr as hdr_io
    from crucible_tpu_torch.io.image import write_png
    from crucible_tpu_torch.io.procedural import generate_earth_texture
    from crucible_tpu_torch.models import demo, integrator, render, replay, textures
    from crucible_tpu_torch.models import scene as tscene
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import megakernel as mk
    from crucible_tpu_torch.ops.kernels import replay_kernel as rk
    from crucible_tpu_torch.ops.kernels import sphere_hit as sh

    cells = {}
    (REPO / "build").mkdir(exist_ok=True)
    tex_dir = tempfile.TemporaryDirectory()
    old_asset_dir = os.environ.get("ASSET_DIR")
    os.environ["ASSET_DIR"] = tex_dir.name
    texels = generate_earth_texture(512)
    try:
        from PIL import Image
        Image.fromarray(texels).save(Path(tex_dir.name) / "earthmap.jpg")
        import PIL
        earth_file, how = "earthmap.jpg", f"PIL {PIL.__version__} imports"
    except ImportError:
        hdr_io.write_hdr(Path(tex_dir.name) / "earthmap.hdr",
                         texels.astype(np.float32) / np.float32(255))
        earth_file, how = "earthmap.hdr", "PIL does not import: an .hdr in its place"
    print(f"earth texture: a generated {texels.shape[1]}x{texels.shape[0]} map as "
          f"{earth_file} ({how})")
    cells["earth_texture"] = earth_file

    def earth(width=400):
        if earth_file == "earthmap.jpg":
            return demo.earth(width=width)
        sc = tscene.Scene.new_image(16.0 / 9.0, width, 24, 180.0)
        cam = sc.scene_cam
        cam.set_samples(500)
        cam.set_max_depth(50)
        cam.look_from((0.0, 0.0, 12.0))
        cam.look_at((0.0, 0.0, 0.0))
        cam.set_vfov(20.0)
        sc.add_element(tscene.Sphere((0.0, 0.0, 0.0), 2.0, tscene.Lambertian.from_texture(
            tscene.ImageTexture(earth_file))), "earth")
        return sc

    def counts():
        return dict(k2=mk.RECORD_LAUNCHES["brute"], k1=mk.FORWARD_LAUNCHES["brute"],
                    k10=sh.LAUNCHES, k4=rk.LAUNCHES_FORWARD, k3=rk.LAUNCHES_BACKWARD)

    def zero_counts():
        mk.zero_counts()
        rk.zero_counts()
        sh.LAUNCHES = 0

    path_counts = {"k2": 0, "k10": 0}

    # --- 2, 3: the forward renders through auto -> record ------------------------
    def forward(name, sc):
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        spp, depth = sc.scene_cam.samples, sc.scene_cam.max_depth
        route = render.auto_schedule(sd, cp, dev)
        if route != "record":
            raise AssertionError(f"{name}: auto takes {route!r}, not 'record'")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()
        replay.PHASE_SECONDS = {}
        try:
            img, wall = host_ms(lambda: render.render_image(sc, device=dev))
            ms = {k: 1e3 * v for k, v in replay.PHASE_SECONDS.items()}
        finally:
            replay.PHASE_SECONDS = None
        got = counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        chunk = max(1, min(spp, replay.REC_BUDGET_BYTES // (4 * depth * w * h)))
        n_chunks = -(-spp // chunk)
        if tuple(img.shape) != (h, w, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"{name}: image shape {tuple(img.shape)} or non-finite")
        if not img.mean().item() > 0.0:
            raise AssertionError(f"{name}: a black image")
        if got["k2"] != n_chunks or got["k1"] or got["k3"] or got["k4"]:
            raise AssertionError(f"{name}: launches {got}, {n_chunks} chunks")
        other = wall - ms["record"] - ms["replay"]
        print(f"render_image {name} {w}x{h} {spp}spp d{depth} (auto -> record): "
              f"{wall / 1e3:.3f} s, {w * h * spp / wall / 1e3:.2f} Mrays/s, mean "
              f"{img.mean().item():.5f}; {n_chunks} chunks of {chunk} spp; by phase: record "
              f"{ms['record']:.1f} ms, replay {ms['replay']:.1f} ms, rays and sums "
              f"{other:.1f} ms; peak {peak:.2f} GiB; launches {got}; nvidia-smi: {smi()}")
        png = REPO / "build" / f"chip_smoke_{name}.png"
        write_png(png, render.to_u8(img))
        print(f"wrote {png.relative_to(REPO)}")
        path_counts["k2"] += got["k2"]
        cells[name] = dict(s=wall / 1e3, record_ms=ms["record"], replay_ms=ms["replay"],
                           other_ms=other, chunks=n_chunks, chunk_spp=chunk, peak_gib=peak,
                           launches=got)
        return sd, cp

    mark("main path 21a: earth 400x225 500 spp d50 (auto -> record)")
    esd, ecp = forward("earth", earth(400))
    mark("main path 21b: nested_checkers 400x225 100 spp d50 (auto -> record)")
    nsd, ncp = forward("nested", demo.nested_checkers(width=400))

    # --- 4: record against pixel, and K10 at the pixel schedule's shape --------
    mark("main path 21c: the record schedule against pixel on the card")
    for name, sd, cp, spp in (("earth", esd, ecp, 8), ("nested", nsd, ncp, 4)):
        zero_counts()
        imgs, times = {}, {}
        for schedule in ("record", "pixel"):
            imgs[schedule], times[schedule] = host_ms(lambda: render.render_image_persistent(
                sd, cp, 400, 225, spp, 50, 0, device=dev, schedule=schedule))
        got = counts()
        a, b = imgs["record"], imgs["pixel"]
        close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item()
        dmean = abs(a.mean().item() - b.mean().item())
        print(f"  {name} 400x225 {spp}spp d50: record {times['record']:.1f} ms, pixel "
              f"{times['pixel']:.1f} ms; isclose {close:.5f}, |mean diff| {dmean:.3g}, "
              f"max|diff| {(a - b).abs().max().item():.3g}; launches {got}")
        if not (close > 0.99 and dmean <= 2e-3):
            raise AssertionError(f"{name}: the record and pixel schedules disagree")
        if got["k10"] < 1 or got["k2"] < 1 or got["k1"]:
            raise AssertionError(f"{name}: launches {got}")
        path_counts["k2"] += got["k2"]
        path_counts["k10"] += got["k10"]
        cells[f"{name}_vs_pixel"] = dict(isclose=close, dmean=dmean, record_ms=times["record"],
                                         pixel_ms=times["pixel"], launches=got)
    p = 400 * 225
    pix = torch.arange(p, device=dev).repeat(8)
    smp = torch.arange(8, device=dev).repeat_interleave(p)
    o, d, _ = generate_rays(ecp, 400, 225, pix, smp, 0)
    c, r = esd.sph_center, esd.sph_radius
    csr = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r
    args = (o.contiguous(), d.contiguous(), c.contiguous(), csr.contiguous(),
            esd.sph_active.float().contiguous())
    out = sh.hit_spheres(*args)
    ref, plain_ms = host_ms(lambda: sh.hit_spheres_reference(*args))
    err = max(bit_equal(x, y, f"K10 earth 400x225 8spp primary rays {n}")
              for n, x, y in zip(("t", "idx", "hit"), out, ref))
    k10_ms = cuda_ms(lambda: sh.hit_spheres(*args), 5)
    table = integrator.make_sphere_table(esd)
    k10_bound, k10_by = bound(search_ops(o, d, torch.zeros_like(o[:, 0]), table, HIT_DISC_OPS),
                              nbytes(*args) + 9 * o.shape[0])
    print(f"K10 earth 400x225 8spp primary rays ({o.shape[0]} x {c.shape[0]} rows, "
          f"{out[2].float().mean().item():.3f} hit): kernel {k10_ms:.4f} ms, plain "
          f"{plain_ms:.1f} ms, bound {k10_bound:.5f} ms ({k10_by})")
    cells["k10_earth"] = dict(ms=k10_ms, plain_ms=plain_ms, bound_ms=k10_bound,
                              bound_by=k10_by, max_abs_err=err)
    del o, d, args, out, ref

    # --- 5: K2 on one record-schedule chunk of earth ------------------------------
    mark("main path 21d: K2 on one record-schedule chunk of earth, 400x225 14 spp d50")
    pix = torch.arange(p, device=dev, dtype=torch.int32).repeat(CHUNK_K2_SPP)
    smp = torch.arange(CHUNK_K2_SPP, device=dev, dtype=torch.int32).repeat_interleave(p)
    k2 = dict(smem=torch.tensor([0, 0, 400, 50, 0, 0, 0, 0], dtype=torch.int32, device=dev),
              pix=pix[None], sample0=smp[None], cam=integrator.mega_cam_vector(ecp, 400, 225),
              table=table.contiguous())
    acc, rec = mk.run_megakernel_record(**k2, max_depth=50, radiance=True)
    _, plain = mk.run_megakernel_record(**k2, max_depth=50)
    bit_equal(rec, plain, "K2 earth chunk fused vs plain records")
    (ref_acc, ref_rec), k2_plain = host_ms(
        lambda: mk.run_megakernel_record_reference(**k2, max_depth=50, radiance=True))
    k2_err = bit_equal(rec, ref_rec, f"K2 earth chunk ({pix.shape[0]} lanes) records")
    bit_equal(acc, ref_acc, "K2 earth chunk fused radiance")
    k2_ms = cuda_ms(lambda: mk.run_megakernel_record(**k2, max_depth=50), 3)
    searches = int((rec & 1).sum())
    n_active = int((table[:, 5] > 0).sum())
    k2_bound, k2_by = bound(searches * n_active * SEARCH_OPS,
                            nbytes(*k2.values()) + nbytes(rec))
    live = int(((rec & 1) > 0).any(dim=1).sum())
    print(f"K2 earth 400x225 14spp d50: kernel {k2_ms:.3f} ms, plain {k2_plain:.1f} ms, "
          f"bound {k2_bound:.4f} ms ({k2_by}; {searches} searches, {live} live rows, "
          f"{int((rec[live - 1] & 1).sum())} lanes alive in the last)")
    cells["k2_earth"] = dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by,
                             max_abs_err=k2_err, live_rows=live, searches=searches)
    del k2, acc, rec, plain, ref_acc, ref_rec, pix, smp

    # --- 6: the texel gradient at 1920x1080, 4 spp, depth 8 ----------------------
    mark("main path 21e: the texel gradient, earth 1920x1080 4 spp d8")
    w, h, spp = 1920, 1080, 4
    sc = earth(1920)
    sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    if replay._use_replay_kernel(sd):
        raise AssertionError("earth should take the eager replay")
    params = grad.extract_params(sd, cp)
    pix = torch.arange(w * h, device=dev)
    target = torch.zeros((w * h, 3), device=dev)
    kw = dict(width=w, height=h, spp=spp, max_depth=8)
    mrays = w * h * spp / 1e6

    def check(loss, grads):
        if not np.isfinite(loss.item()):
            raise AssertionError("texel step: non-finite loss")
        for key, g in grad.leaves(grads).items():
            if not bool(g.isfinite().all()):
                raise AssertionError(f"texel step: non-finite gradient {key}")
        if not grads["tex_images"][0].abs().max().item() > 0:
            raise AssertionError("texel step: the texel gradient is zero")

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    (loss0, grads0), ms = host_ms(lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw))
    check(loss0, grads0)
    step_ms = []
    for _ in range(2):
        (loss, g), t = host_ms(lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw))
        check(loss, g)
        step_ms.append(t)
        same = torch.equal(loss, loss0) and all(
            torch.equal(a, grad.leaves(g)[k]) for k, a in grad.leaves(grads0).items())
        if not same:
            raise AssertionError("texel step: two steps on the same inputs differ in a bit")
    got = counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"loss_and_grad earth 1920x1080 4spp d8 (auto -> replay, eager): warm "
          f"{ms / 1e3:.3f} s, steps " + ", ".join(f"{t / 1e3:.4f} s" for t in step_ms)
          + f" ({mrays / (min(step_ms) / 1e3):.2f} Mrays/s), loss {loss0.item():.6f}, "
          f"peak {peak:.2f} GiB, launches {got}; the 3 steps' losses and gradients bit for "
          f"bit; nvidia-smi: {smi()}")
    if got["k2"] != 3 or got["k3"] or got["k4"]:
        raise AssertionError(f"texel steps: launches {got}")
    path_counts["k2"] += got["k2"]
    del g

    leaves = {k: v.detach().requires_grad_(True) for k, v in grad.leaves(params).items()}
    sd2, cp2 = grad.apply_params(sd, cp, grad.with_leaves(params, leaves))
    pl, sl = grad._lanes(pix, spp, 0)
    (o, d, _), t_rays = host_ms(lambda: generate_rays(cp2, w, h, pl, sl, 0))
    rec, t_rec = host_ms(lambda: replay.trace_record_mega(sd2, cp2, w, h, pl, sl, 0, 8))

    def forward_loss():
        rad = replay.trace_replay(sd2, o, d, pl, sl, 0, 8, rec)
        return torch.mean((rad.reshape(spp, -1, 3).mean(dim=0) - target) ** 2)

    loss_f, t_fwd = host_ms(forward_loss)
    _, t_bwd = host_ms(lambda: torch.autograd.grad(loss_f, list(leaves.values()),
                                                   allow_unused=True))
    print(f"  by phase: rays {t_rays:.1f} ms, record {t_rec:.1f} ms, replay forward "
          f"{t_fwd:.1f} ms, replay backward {t_bwd:.1f} ms")
    del o, d, loss_f, leaves, sd2, cp2
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in rows) / 1e3

    def share(*words):
        return sum(e.self_device_time_total for e in rows
                   if any(x in e.key.lower() for x in words)) / 1e3

    ia, gb = share("indexfunc", "index_add"), share("segment", "sort", "unique")
    print(f"  profile of one step: {total:.1f} ms of device time in "
          f"{sum(e.count for e in rows)} launches; index_add {ia:.1f} ms = "
          f"{100 * ia / max(total, 1e-9):.1f}% of it, {100 * ia / min(step_ms):.1f}% of the "
          f"fastest step's wall time; the gathers' backward (sort, segment sum) {gb:.1f} ms "
          f"= {100 * gb / max(total, 1e-9):.1f}%, {100 * gb / min(step_ms):.1f}%")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:70]}")
    cells["texel_step"] = dict(warm_ms=ms, step_ms=step_ms, peak_gib=peak, rays_ms=t_rays,
                               record_ms=t_rec, forward_ms=t_fwd, backward_ms=t_bwd,
                               device_ms=total, index_add_ms=ia, gather_backward_ms=gb)

    # The card against the CPU on the same records, over a band of rows.
    y0 = (h - BAND_ROWS) // 2
    band = torch.arange(y0 * w, (y0 + BAND_ROWS) * w, device=dev)
    rec_band = rec.reshape(8, spp, w * h)[:, :, band].reshape(8, -1)
    cpu = torch.device("cpu")
    sd_c, cp_c = sc.build(device=cpu), sc.scene_cam.params(device=cpu)

    def band_step(where, sd_w, cp_w):
        p_w = grad.extract_params(sd_w, cp_w)
        args = (p_w, sd_w, cp_w, target[band].to(where), band.to(where), 0)
        textures.TEXEL_IDS = ids = []
        try:
            with torch.no_grad():
                grad.l2_loss(*args, rec=rec_band.to(where), **kw)
        finally:
            textures.TEXEL_IDS = None
        t0 = time.perf_counter()
        loss_w, g_w = grad.loss_and_grad(*args, rec=rec_band.to(where), **kw)
        t = time.perf_counter() - t0
        return loss_w.cpu(), {k: v.cpu() for k, v in grad.leaves(g_w).items()}, ids, t

    lc, gc, ids_c, _ = band_step(dev, sd, cp)
    lp, gp, ids_p, t_cpu = band_step(cpu, sd_c, cp_c)
    rel = abs(lc.item() - lp.item()) / lp.item()
    flipped = torch.cat([torch.cat([a[a != b], b[a != b]])
                         for a, b in zip(ids_c, ids_p)]).unique()
    lanes = sum(int((a != b).sum()) for a, b in zip(ids_c, ids_p))
    lookups = sum(a.numel() for a in ids_p)
    print(f"  card vs CPU, rows {y0}-{y0 + BAND_ROWS - 1} ({band.numel() * spp} lanes) on "
          f"the card's records: loss {lc.item():.8f} vs {lp.item():.8f} (rel {rel:.3g}); "
          f"CPU {t_cpu:.1f} s; {lanes} of {lookups} texel lookups ({lanes / lookups:.3g}, "
          f"at most {FLIP_LIMIT:g}) chose another texel, {flipped.numel()} texels left out")
    if not rel <= 1e-4:
        raise AssertionError("texel step: the card's and the CPU's losses disagree")
    if [a.shape for a in ids_c] != [a.shape for a in ids_p] or not lanes <= FLIP_LIMIT * lookups:
        raise AssertionError("texel step: too many lookups chose another texel on the card")
    worst = {}
    for key in gp:
        a, b = gc[key], gp[key]
        scale = max(b.abs().max().item(), 1e-6)
        diff = (a - b).abs() / scale
        if key.startswith("tex_images"):
            diff = diff.amax(dim=-1).reshape(-1)
            diff[flipped] = 0.0
        nd = diff.max().item()
        worst[key] = nd
        held = key.startswith("tex_") or key == "mat_emission"
        print(f"    {key}: max normalized diff {nd:.3g}"
              + (" (held at 1e-3)" if held else " (not held: camera and fuzz, fault C4)"))
        if held and not nd <= 1e-3:
            raise AssertionError(f"texel step {key}: card and CPU gradients disagree")
    cells["texel_card_vs_cpu"] = dict(rel=rel, flipped_texels=flipped.numel(),
                                      flipped_lookups=lanes, lookups=lookups,
                                      normalized=worst, cpu_s=t_cpu)
    del rec, params, grads0

    # --- 7: train_demo, 3 steps and a resume ---------------------------------------
    mark("main path 21f: train_demo, earth 1920 wide, 3 steps and a resume")
    zero_counts()
    with tempfile.TemporaryDirectory() as tmp:
        kw_t = dict(scene=earth, steps=3, verbose=False, device=dev)
        (p_full, l_full), s_full = host_ms(
            lambda: train_demo.run(out_dir=Path(tmp) / "full", **kw_t))
        train_demo.run(out_dir=Path(tmp) / "cut", **dict(kw_t, steps=2, ckpt_every=1))
        p_res, l_res = train_demo.run(out_dir=Path(tmp) / "cut", **kw_t)
    got = counts()
    same = [r["loss"] for r in l_res] == [r["loss"] for r in l_full] and all(
        torch.equal(a, grad.leaves(p_res)[k]) for k, a in grad.leaves(p_full).items())
    print(f"train_demo earth 1920 wide: 3 steps in {s_full / 1e3:.2f} s (target, "
          f"steps, recovered.png), steps " + ", ".join(f"{r['seconds']:.3f} s" for r in l_full)
          + f"; losses {[r['loss'] for r in l_full]}; resumed after 2: "
          f"{[r['loss'] for r in l_res]}; bit for bit: {same}; launches {got}")
    if not same or not l_full[-1]["loss"] < l_full[0]["loss"]:
        raise AssertionError("train_demo: the resumed run differs, or the loss did not go down")
    if got["k2"] < 1 or got["k3"] or got["k4"]:
        raise AssertionError(f"train_demo: launches {got}")
    path_counts["k2"] += got["k2"]
    cells["train_demo"] = dict(width=1920, s=s_full / 1e3,
                               losses=[r["loss"] for r in l_full],
                               step_s=[r["seconds"] for r in l_full])
    if old_asset_dir is None:
        os.environ.pop("ASSET_DIR", None)
    else:
        os.environ["ASSET_DIR"] = old_asset_dir
    tex_dir.cleanup()
    for name, key in (("megakernel_record", "k2"), ("sphere_hit", "k10")):
        kernels[name]["launches"] = kernels[name].get("launches", 0) + path_counts[key]
        kernels[name]["textured_path_launches"] = path_counts[key]
    cells["launches"] = path_counts
    print("textured path launches: " + json.dumps(path_counts))
    return cells


def loop_ppm(path, img_u8) -> None:
    """The P3 writer the port had before its numpy one (the JAX package's
    ``write_ppm``): one formatted line a pixel. Timed beside the new writer
    on the same frame, and held to the same bytes."""
    h, w = img_u8.shape[:2]
    body = "\n".join(f"{r} {g} {b}" for r, g, b in img_u8.reshape(-1, 3))
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n{body}\n")


def frame_phases(scene, dev, what: str, old_writer: bool = False) -> dict:
    """A movie frame of ``scene`` (its camera's current frame) by phase,
    each synchronized, in ms: the scene build and camera lowering (the
    cache dropped), the render from launch to synchronize, the fetch and
    quantization to u8 on the host, and the PPM write. ``render_movie``
    does the last two on its worker thread while the next frame builds and
    renders. With ``old_writer`` also the per-pixel writer's time
    (:func:`loop_ppm`), which must write the same bytes."""
    from crucible_tpu_torch.io.image import write_ppm
    from crucible_tpu_torch.models import render

    cam = scene.scene_cam
    scene._cache = None
    (sd, cp), build_ms = host_ms(lambda: (scene.build(device=dev), cam.params(device=dev)))
    img, render_ms = host_ms(lambda: render.render_image_data(
        sd, cp, cam.image_width, cam.image_height, cam.samples, cam.max_depth, scene.seed,
        device=dev))
    u8, fetch_ms = host_ms(lambda: render.to_u8(img.cpu()))
    out = dict(build_ms=build_ms, render_ms=render_ms, fetch_ms=fetch_ms)
    with tempfile.TemporaryDirectory() as tmp:
        out["write_ms"] = host_ms(lambda: write_ppm(Path(tmp) / "new.ppm", u8))[1]
        if old_writer:
            out["loop_write_ms"] = host_ms(lambda: loop_ppm(Path(tmp) / "old.ppm", u8))[1]
            if (Path(tmp) / "new.ppm").read_bytes() != (Path(tmp) / "old.ppm").read_bytes():
                raise AssertionError(f"{what}: the numpy PPM writer's bytes differ")
    print(f"{what} {cam.image_width}x{cam.image_height} {cam.samples}spp d{cam.max_depth}, "
          f"frame {cam.frame} by phase: build {build_ms:.1f} ms, launch to synchronize "
          f"{render_ms:.1f} ms, fetch + quantize {fetch_ms:.1f} ms, PPM write "
          f"{out['write_ms']:.1f} ms"
          + (f" (the per-pixel writer {out['loop_write_ms']:.1f} ms, the same bytes)"
             if old_writer else ""))
    return out


def python_builder(what: str):
    """Context: ``ops.bvh.build_bvh`` (which ``Scene.build`` and
    ``megakernel.swept_tables`` call) takes the Python builder. It counts
    the trees the Python builder built, and raises on leaving if that was
    none (a caller that reached the builder another way would compare the
    native tree with itself)."""
    import contextlib

    from crucible_tpu_torch.models import scene as tscene
    from crucible_tpu_torch.ops import bvh

    @contextlib.contextmanager
    def ctx():
        real = bvh.build_bvh
        built = [0]

        def plain(*args, use_native=True, **kwargs):
            built[0] += 1
            return real(*args, use_native=False, **kwargs)

        bvh.build_bvh = tscene.build_bvh = plain
        try:
            yield built
        finally:
            bvh.build_bvh = tscene.build_bvh = real
        if built[0] < 1:
            raise AssertionError(f"{what}: the Python builder built no tree")

    return ctx()


def builder_ab(scene, dev, what: str) -> dict:
    """``scene.build`` (its current frame, the cache dropped) with the
    native BVH builder and with the Python one, each timed after a warm
    build (the timelines' lowering is cached on first use); every tree
    field of the two builds (the mesh tree and its leaf order, the sphere
    tables' trees) held equal bit for bit."""
    import torch

    def build():
        scene._cache = None
        return host_ms(lambda: scene.build(device=dev))

    build()
    native, native_ms = build()
    with python_builder(what) as built:
        plain, python_ms = build()
    fields = [f for f in ("bvh_min", "bvh_max", "bvh_first", "bvh_count", "bvh_miss",
                          "tri_v0", "tri_v1", "tri_v2", "tri_mat", "sph_perm", "sph_nodes",
                          "sph_meta", "sph_swept_perm", "sph_swept_nodes", "sph_swept_meta")
              if getattr(native, f, None) is not None]
    for f in fields:
        if not torch.equal(getattr(native, f), getattr(plain, f)):
            raise AssertionError(f"{what}: the native and Python builders part on {f}")
    scene._cache = None
    print(f"{what} scene build, frame {scene.scene_cam.frame}: native BVH builder "
          f"{native_ms:.1f} ms, Python builder {python_ms:.1f} ms ({built[0]} Python "
          f"trees); {len(fields)} tree fields equal bit for bit")
    return dict(native_ms=native_ms, python_ms=python_ms, python_trees=built[0])


def cli_path(dev, kernels: dict, mark) -> dict:
    """Main path 22, the command line on ``dev`` -> its cells. Adds this
    path's K1 and K9 launches to ``kernels``.

    a. ``cli.main(["--file", ..., "--world", "1", "--width", "1920"])`` in
       this process: book1 at its own 500 spp, depth 50, on the card, with
       its progress (verbose) in 8 sample chunks, each one K1 launch and
       nothing else; the film (``build/chip_smoke_cli_book1.ppm``) against
       ``to_u8`` of one dispatch of ``render_image`` (one K1 launch and
       nothing else): u8 values equal on more than 0.999 of them, none
       apart by more than 1.
    b. ``--movie --world 1 --seconds 0.25 --rate 24``: first_movie's 6
       frames at 400x225, 50 spp, depth 5 (the pixel schedule, K9; no K1).
    c. ``python -m crucible_tpu_torch.cli --file ... --width 160 --spp 4``
       in a process of its own: exit 0, its film written.

    Any failed check raises."""
    import numpy as np

    from crucible_tpu_torch import cli
    from crucible_tpu_torch.io.image import read_ppm
    from crucible_tpu_torch.models import demo, render
    from crucible_tpu_torch.ops.kernels import megakernel as mk
    from crucible_tpu_torch.ops.kernels import sphere_hit as sh
    from crucible_tpu_torch.ops.kernels import sphere_shade as ss

    def zero():
        mk.zero_counts()
        ss.LAUNCHES = sh.LAUNCHES = 0

    def launched():
        got = {f"forward_{k}": n for k, n in mk.FORWARD_LAUNCHES.items() if n}
        got.update({f"record_{k}": n for k, n in mk.RECORD_LAUNCHES.items() if n})
        got.update({k: n for k, n in (("k9", ss.LAUNCHES), ("k10", sh.LAUNCHES)) if n})
        return got

    cells = {}
    (REPO / "build").mkdir(exist_ok=True)

    mark("main path 22a: cli.main --world 1 --width 1920 (book1 500 spp d50, verbose)")
    film = REPO / "build" / "chip_smoke_cli_book1"
    zero()
    rc, ms = host_ms(lambda: cli.main(["--file", str(film), "--world", "1", "--width", "1920"]))
    got = launched()
    if rc != 0 or got != {"forward_brute": 8}:
        raise AssertionError(f"cli book1: rc {rc}, launches {got} (8 K1 chunks expected)")
    k1 = got["forward_brute"]
    u8 = read_ppm(f"{film}.ppm")
    sc = demo.book1_end_scene(width=1920)
    sc.seed = 0
    zero()
    one, one_ms = host_ms(lambda: render.render_image(sc, device=dev))
    one_got = launched()
    if one_got != {"forward_brute": 1}:
        raise AssertionError(f"cli book1's one dispatch: launches {one_got} (one K1 expected)")
    k1 += one_got["forward_brute"]
    want = render.to_u8(one.cpu())
    if u8.shape != want.shape:
        raise AssertionError(f"cli book1: film {u8.shape}, one dispatch {want.shape}")
    diff = np.abs(u8.astype(np.int64) - want.astype(np.int64))
    equal = float((diff == 0).mean())
    if not equal > 0.999 or diff.max() > 1:
        raise AssertionError(f"cli book1: u8 equal on {equal}, max diff {diff.max()}")
    print(f"cli book1 1920x1080 500spp d50 (8 chunks): {ms / 1e3:.3f} s with the film "
          f"written, one-dispatch render_image {one_ms / 1e3:.3f} s; u8 equal on {equal:.6f}, "
          f"max diff {diff.max()}; launches {got}")
    cells["book1"] = dict(s=ms / 1e3, one_dispatch_s=one_ms / 1e3, u8_equal=equal)

    mark("main path 22b: cli.main --movie --world 1 --seconds 0.25 --rate 24")
    with tempfile.TemporaryDirectory() as tmp:
        zero()
        rc, ms = host_ms(lambda: cli.main(["--file", str(Path(tmp) / "movie"), "--movie",
                                           "--world", "1", "--seconds", "0.25", "--rate", "24"]))
        got = launched()
        frames = sorted((Path(tmp) / "movie" / "artifacts").glob("image*.ppm"))
        if rc != 0 or len(frames) != 6 or got.get("k9", 0) < 1 or set(got) != {"k9"}:
            raise AssertionError(f"cli movie: rc {rc}, {len(frames)} frames, launches {got}")
        shapes = {read_ppm(f).shape for f in frames}
        if shapes != {(225, 400, 3)}:
            raise AssertionError(f"cli movie: frame shapes {shapes}")
    k9 = got["k9"]
    print(f"cli --movie --world 1 (first_movie 400x225 50spp d5, 6 frames): {ms / 1e3:.3f} s, "
          f"{ms / 6e3:.3f} s a frame; launches {got}")
    cells["movie"] = dict(s=ms / 1e3, frames=6)

    mark("main path 22c: python -m crucible_tpu_torch.cli --width 160 --spp 4")
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(REPO))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "crucible_tpu_torch.cli", "--file", str(Path(tmp) / "sub"),
             "--width", "160", "--spp", "4"],
            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
        sub_s = time.perf_counter() - t0
        if proc.returncode != 0 or read_ppm(Path(tmp) / "sub.ppm").shape != (90, 160, 3):
            raise AssertionError(f"python -m crucible_tpu_torch.cli: exit {proc.returncode}\n"
                                 f"{proc.stderr[-4000:]}")
    print(f"python -m crucible_tpu_torch.cli --width 160 --spp 4: exit 0 in {sub_s:.2f} s "
          f"(process start, CUDA start, render, write)")
    cells["subprocess_s"] = sub_s

    counts = {"megakernel_forward": k1, "sphere_shade": k9}
    for name, n in counts.items():
        kernels[name]["launches"] += n
        kernels[name]["cli_path_launches"] = n
    cells["launches"] = counts
    return cells


def _launch_counter():
    """(zero, launched): set every launch count to 0; the counts since, by
    kernel (megakernel variants by mode, K9, K10, K4, K3)."""
    from crucible_tpu_torch.ops.kernels import megakernel as mk
    from crucible_tpu_torch.ops.kernels import replay_kernel as rk
    from crucible_tpu_torch.ops.kernels import sphere_hit as sh
    from crucible_tpu_torch.ops.kernels import sphere_shade as ss

    def zero():
        mk.zero_counts()
        rk.zero_counts()
        ss.LAUNCHES = sh.LAUNCHES = 0

    def launched():
        got = {f"forward_{k}": n for k, n in mk.FORWARD_LAUNCHES.items() if n}
        got.update({f"record_{k}": n for k, n in mk.RECORD_LAUNCHES.items() if n})
        got.update({k: n for k, n in (("k9", ss.LAUNCHES), ("k10", sh.LAUNCHES),
                                      ("k4", rk.LAUNCHES_FORWARD),
                                      ("k3", rk.LAUNCHES_BACKWARD)) if n})
        return got

    return zero, launched


def images_agree(a, b, what: str) -> dict:
    """Assert two schedules' images at fault C6's cross-path bounds
    (isclose(1e-3, 1e-3) on > 0.97 of values, means within 2e-3)."""
    import torch

    close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item()
    dmean = abs(a.mean().item() - b.mean().item())
    print(f"  {what}: isclose {close:.5f}, |mean diff| {dmean:.3g}")
    if not close > 0.97 or not dmean <= 2e-3:
        raise AssertionError(f"{what}: the two schedules disagree")
    return dict(isclose=close, mean_diff=dmean)


def mesh_walk_path(dev, kernels: dict, mark) -> dict:
    """Main path 23, a mesh beside a big sphere table (ROADMAP A11) ->
    its cells. Adds the pairs' entries to ``kernels``.

    a. sphere_stress n7744 with torus_teapot's 6,320-triangle torus,
       1920x1080: the forward render through auto (32 spp d50: one launch
       of K5's walk then K7's, ``walk_tri``) and the record the gradient
       step takes (4 spp d8, fused radiance: one ``walk_tri`` record
       launch), counted; then each against K1 + K7 (``cull=False``, and the
       record of the scene without its tree) bit for bit, and the pair's
       launches against their plain version (the forward on 8 pixel blocks
       by sample, the record on N_SUB lanes), timed beside their bound
       (the plain walks' counted work) and launch shape. The same scene at
       320x180 8 spp d50 on the ``pixel`` schedule (K10 and the lockstep
       BVH walk), as auto rendered it before the pair, against the pair at
       C6's bounds.
    b. bouncing stress n1936 with the torus rising: the same through K6's
       swept-tree walk then K7 moving's (``cull_tri``), against K8 + K7
       moving.

    Any failed check raises."""
    import torch

    from crucible_tpu_torch.io.image import write_png
    from crucible_tpu_torch.models import demo, integrator, render, replay
    from crucible_tpu_torch.models import scene as tscene
    from crucible_tpu_torch.ops.kernels import megakernel as mk

    zero, launched = _launch_counter()
    spp, depth, seed, rec_spp, rec_depth = 32, 50, 0, 4, 8
    (REPO / "build").mkdir(exist_ok=True)
    w, h = 1920, 1080
    n_blocks = (w // 32) * math.ceil(h / 16)
    blocks = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(23))[:8]
    lanes = (blocks.sort().values[:, None] * mk.TILE + torch.arange(mk.TILE)).reshape(-1).to(dev)
    sub = torch.randperm(w * h * rec_spp, generator=torch.Generator().manual_seed(24))[:N_SUB]
    sub = sub.sort().values.to(dev)
    cells = {}

    def lane_subset(inputs, at):
        return dict(inputs, pix=inputs["pix"][:, at], sample0=inputs["sample0"][:, at])

    def pair_ops(counts, flags):
        """The pair's FP32 work from the plain version's counts: the sphere
        walk's (K5's or K6's rows), the triangle walk's (Woop or moving
        rows), the camera's."""
        row = MOVING_DISC_OPS if flags["animated"] else HIT_DISC_OPS
        leaf = MT_MOVING_OPS if flags["animated"] else WOOP_OPS
        return (counts["nodes"] * SLAB_OPS + counts["rows"] * row + counts["roots"] * ROOT_OPS
                + counts["tri_nodes"] * TRI_SLAB_OPS + counts["tri_rows"] * leaf
                + (counts["issued"] * CAM_OPS if flags["cam_animated"] else 0))

    def plain(fn, walk_counts):
        """(result, ms, the plain pair's counted work) of one plain call."""
        mk.SEARCH_COUNTS.update(searches=0, issued=0)
        walk_counts.update(nodes=0, rows=0, roots=0)
        mk.TRI_COUNTS.update(nodes=0, rows=0)
        out, ms = host_ms(fn)
        return out, ms, dict(mk.SEARCH_COUNTS, **walk_counts,
                             tri_nodes=mk.TRI_COUNTS["nodes"], tri_rows=mk.TRI_COUNTS["rows"])

    for moving in (False, True):
        key, brute_key = ("cull_tri", "tri_motion") if moving else ("walk_tri", "tri")
        name = "K6 + K7 moving" if moving else "K5 + K7"
        scene_name = "bouncing stress n1936 + the rising torus" if moving else (
            "sphere_stress n7744 + the torus")
        mark(f"main path 23{'b' if moving else 'a'}: {name}, {scene_name}, 1920x1080")
        t0 = time.perf_counter()
        sc = torus_beside_stress(demo, tscene, w, 4 if moving else 16, moving)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        build_s = time.perf_counter() - t0
        if not (integrator.megakernel_supported(sd, cp) and sd.use_bvh
                and sd.sph_swept_nodes is not None and sd.animated == moving):
            raise AssertionError(f"{scene_name}: not a BVH mesh beside a walked table")
        flags = dict(animated=bool(sd.animated), cam_animated=bool(cp.animated))
        p = w * h
        pix = torch.arange(p, device=dev).repeat(rec_spp)
        smp = torch.arange(rec_spp, device=dev).repeat_interleave(p)

        # --- the main path: the forward render and the gradient's record --
        zero()
        img, fwd_ms = host_ms(lambda: render.render_image_persistent(
            sd, cp, w, h, spp, depth, seed, device=dev))
        (rec, rad), rec_ms = host_ms(lambda: replay.trace_record_mega(
            sd, cp, w, h, pix, smp, seed, rec_depth, radiance=True))
        got = launched()
        if got != {f"forward_{key}": 1, f"record_{key}": 1}:
            raise AssertionError(f"{scene_name}: launches {got}, one {key} a mode expected")
        if not (torch.isfinite(img).all() and ((rec & mk.F_TRI) > 0).any()):
            raise AssertionError(f"{scene_name}: a non-finite image or no triangle winner")
        write_png(REPO / "build" / f"chip_smoke_{key}.png", render.to_u8(img))
        print(f"{name} on {scene_name} ({sd.sph_center.shape[0]} rows, {sd.num_tris} "
              f"triangles; built in {build_s:.2f} s): render 32spp d50 {fwd_ms / 1e3:.3f} s, "
              f"record 4spp d8 {rec_ms:.1f} ms; launches {got}")

        # --- the brute search with the same triangle stage -----------------
        zero()
        brute_img, brute_fwd_ms = host_ms(lambda: render.render_image_persistent(
            sd, cp, w, h, spp, depth, seed, device=dev, cull=False))
        bsd = replace(sd, sph_perm=None, sph_cbounds=None)
        (b_rec, b_rad), brute_rec_ms = host_ms(lambda: replay.trace_record_mega(
            bsd, cp, w, h, pix, smp, seed, rec_depth, radiance=True))
        brute_got = launched()
        if brute_got != {f"forward_{brute_key}": 1, f"record_{brute_key}": 1}:
            raise AssertionError(f"{scene_name}: brute launches {brute_got}")
        bit_equal(img, brute_img, f"{name} render vs the brute search + K7")
        bit_equal(rec, b_rec, f"{name} records vs the brute search + K7")
        bit_equal(rad, b_rad, f"{name} fused radiance vs the brute search + K7")
        brute_name = "megakernel_tri_moving" if moving else "megakernel_tri"
        kernels[brute_name]["launches"] += 1
        kernels[f"{brute_name}_record"]["launches"] += 1
        del brute_img, b_rec, b_rad

        # --- the pair's launches: timed, shaped, against the plain version --
        brute, _ = integrator.mega_inputs(sd, cp, w, h, spp, depth, seed)
        brute.update(zip(("tri_nodes", "tris", "mats", "tri_meta"),
                         integrator.make_tri_tables(sd)))
        walk = dict(brute, table=integrator.permute_table(brute["table"], sd.sph_swept_perm),
                    swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
        tables = (walk["table"], walk["swept_nodes"], walk["swept_meta"], walk["tri_nodes"],
                  walk["tris"], walk["mats"], walk["tri_meta"])
        out = mk.run_megakernel(**walk, **flags)
        ms = cuda_ms(lambda: mk.run_megakernel(**walk, **flags), 2)
        brute_ms = cuda_ms(lambda: mk.run_megakernel(**brute, **flags), 1)
        shape = mk.flat_launch_shape(False, True, walk["table"].shape[0], walk["pix"].shape[1],
                                     nodes=int(walk["swept_nodes"].shape[0]),
                                     tri_nodes=int(walk["tri_nodes"].shape[0]), **flags)
        walk_counts = mk.CULL_COUNTS if moving else mk.WALK_COUNTS
        ref, plain_ms, counts = plain(lambda: mk.run_megakernel_reference(
            **lane_subset(walk, lanes), **flags, by_sample=True), walk_counts)
        err = bit_equal(out[:, lanes], ref, f"{name} 1920x1080 32spp d50 on 8 pixel blocks vs "
                                             "its plain version")
        scale = (int((walk["sample0"] < mk.NO_SAMPLE).sum())
                 / int((walk["sample0"][:, lanes] < mk.NO_SAMPLE).sum()))
        b, by = bound(pair_ops(counts, flags) * scale,
                      nbytes(*tables) + 5 * 4 * walk["pix"].shape[1])
        print(f"{name} 1920x1080 32spp d50 {flags}: {ms:.3f} ms (the brute search + K7 "
              f"{brute_ms:.3f} ms, {brute_ms / ms:.2f}x), plain {plain_ms:.1f} ms on 8 blocks, "
              f"bound {b:.4f} ms ({by}); shape {shape}; work {counts}, x{scale:.1f}")
        del out, ref, brute

        rec_in = dict(walk, pix=pix.to(torch.int32)[None], sample0=smp.to(torch.int32)[None])
        r_acc, r_rec = mk.run_megakernel_record(**rec_in, max_depth=rec_depth, radiance=True,
                                                **flags)
        rec_ms_k = cuda_ms(lambda: mk.run_megakernel_record(
            **rec_in, max_depth=rec_depth, radiance=True, **flags), 3)
        rec_shape = mk.flat_launch_shape(True, True, rec_in["table"].shape[0], p * rec_spp,
                                         nodes=int(walk["swept_nodes"].shape[0]),
                                         tri_nodes=int(walk["tri_nodes"].shape[0]), **flags)
        bit_equal(r_rec, rec, f"{name} record launch vs the main path's")
        (ref_acc, ref_rec), rec_plain_ms, rec_counts = plain(
            lambda: mk.run_megakernel_record_reference(
                **lane_subset(rec_in, sub), max_depth=rec_depth, radiance=True, **flags),
            walk_counts)
        bit_equal(r_rec[:, sub], ref_rec, f"{name} records on {N_SUB} lanes vs plain")
        rec_err = bit_equal(r_acc[:, sub], ref_acc, f"{name} fused radiance on {N_SUB} lanes "
                                                    "vs plain")
        rec_b, rec_by = bound(pair_ops(rec_counts, flags) * (p * rec_spp / N_SUB),
                              nbytes(*tables, r_rec) + 5 * 4 * p * rec_spp)
        print(f"{name} record 1920x1080 4spp d8: {rec_ms_k:.3f} ms, plain {rec_plain_ms:.1f} ms "
              f"on {N_SUB} lanes, bound {rec_b:.4f} ms ({rec_by}); shape {rec_shape}")
        del rec_in, r_acc, r_rec, rec, rad, walk, tables

        cell = dict(build_s=build_s, render_s=fwd_ms / 1e3, brute_render_s=brute_fwd_ms / 1e3,
                    record_ms=rec_ms, brute_record_ms=brute_rec_ms, launches=got)
        if not moving:
            # The pixel schedule (K10 and the lockstep BVH walk), which auto
            # took for this scene before the pair, against the pair: 320x180
            # 8 spp d50 (the pixel schedule's host loop at 1080p 32 spp
            # would take minutes).
            small = torus_beside_stress(demo, tscene, 320, 16)
            ssd, scp = small.build(device=dev), small.scene_cam.params(device=dev)
            zero()
            mega, mega_ms = host_ms(lambda: render.render_image_persistent(
                ssd, scp, 320, 180, 8, depth, seed, device=dev))
            pix_img, pixel_ms = host_ms(lambda: render.render_image_persistent(
                ssd, scp, 320, 180, 8, depth, seed, device=dev, schedule="pixel"))
            small_got = launched()
            print(f"  320x180 8spp d50: the pair {mega_ms:.1f} ms, pixel {pixel_ms:.1f} ms "
                  f"({pixel_ms / mega_ms:.1f}x); launches {small_got}")
            cell["pixel_320"] = dict(images_agree(mega, pix_img, f"{name} vs pixel, 320x180"),
                                     pair_ms=mega_ms, pixel_ms=pixel_ms)
            kernels["sphere_hit"]["launches"] += small_got.get("k10", 0)
            got = dict(got, forward_walk_tri=1 + small_got.get("forward_walk_tri", 0))
        cells[key] = cell
        common = dict(source="crucible_tpu_torch/csrc/megakernel.cu", route_of=name)
        kernels[f"megakernel_{key}"] = dict(
            common, replaces="crucible_tpu/ops/pallas/megakernel.py:1681",
            launches=got[f"forward_{key}"], max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b, bound_by=by, shape="1920x1080 32spp d50", brute_ms=brute_ms,
            plain_checked="8 pixel blocks", launch_shape=shape)
        kernels[f"megakernel_{key}_record"] = dict(
            common, replaces="crucible_tpu/ops/pallas/megakernel.py:1828",
            launches=got[f"record_{key}"], max_abs_err=rec_err, ms=rec_ms_k,
            plain_ms=rec_plain_ms, bound_ms=rec_b, bound_by=rec_by, shape="1920x1080 4spp d8",
            plain_checked=f"{N_SUB} lanes", launch_shape=rec_shape)
    return cells


def staged_record_path(dev, kernels: dict, mark) -> dict:
    """Main path 24, the staged record (ROADMAP A10) -> its cells.

    a. book1 1920x1080 4 spp d8: ``replay.trace_record`` (one K10 launch a
       bounce, counted) against the record megakernel (one K2 launch) on
       the same lanes: the essential bits on > 0.99 of entries, ids and
       flags on > 0.99 of the rows both record as hits (the JAX package's
       bounds between its two records); each timed. K10 against its plain
       version on the record's primary rays, bit for bit.
    b. The gradient step of the fan's first 40 triangles (a mesh without a
       BVH, which the record megakernel refuses), 1024x1024 4 spp d8:
       ``grad.loss_and_grad`` records through the staged record ('auto')
       and replays eagerly; timed, finite; K10 against its plain version
       on the step's primary rays and one-sphere table, bit for bit; and at 64
       wide the card's step against the CPU's (loss rel 1e-4, gradients
       normalized 1e-3).

    Any failed check raises."""
    import torch

    from crucible_tpu_torch import grad
    from crucible_tpu_torch.models import demo, integrator, replay
    from crucible_tpu_torch.models import scene as tscene
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import megakernel as mk
    from crucible_tpu_torch.ops.kernels import sphere_hit as sh

    zero, launched = _launch_counter()
    seed, spp, depth = 0, 4, 8
    cells = {}

    def k10_primary(sd, cp, w, h, pix, smp, what):
        """K10 against its plain version, bit for bit, on the first bounce
        of a staged record of lanes (pix, smp): their primary rays against
        the scene's sphere table (its centers, c.c - r*r and active rows)."""
        o, d, _ = generate_rays(cp, w, h, pix, smp, seed)
        table = integrator.make_sphere_table(sd)
        cols = (table[:, 0:3].contiguous(), table[:, 4].contiguous(),
                table[:, 5].contiguous())
        got = sh.hit_spheres(o.contiguous(), d.contiguous(), *cols)
        want = sh.hit_spheres_reference(o.contiguous(), d.contiguous(), *cols)
        for a, b, name in zip(got, want, ("t", "idx", "hit")):
            bit_equal(a, b, f"K10 on {what} {o.shape[0]} primary rays against "
                            f"{table.shape[0]} rows: {name}")

    mark("main path 24a: the staged record against the mega record, book1 1920x1080 4spp d8")
    sc = demo.book1_end_scene(width=1920)
    sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    p = 1920 * 1080
    pix = torch.arange(p, device=dev).repeat(spp)
    smp = torch.arange(spp, device=dev).repeat_interleave(p)

    def staged():
        o, d, _ = generate_rays(cp, 1920, 1080, pix, smp, seed)
        return replay.trace_record(sd, o, d, pix, smp, seed, depth)

    zero()
    rec_s, staged_ms = host_ms(staged)
    staged_got = launched()
    zero()
    rec_m, mega_ms = host_ms(lambda: replay.trace_record_mega(
        sd, cp, 1920, 1080, pix, smp, seed, depth))
    mega_got = launched()
    if set(staged_got) != {"k10"} or not 1 <= staged_got["k10"] <= depth:
        raise AssertionError(f"staged record launches {staged_got}: K10 a bounce expected")
    if mega_got != {"record_brute": 1}:
        raise AssertionError(f"mega record launches {mega_got}")
    ess = mk.F_ALIVE | mk.F_HIT | mk.F_SCAT
    ess_same = ((rec_s & ess) == (rec_m & ess)).float().mean().item()
    hit_both = ((rec_s & rec_m) & mk.F_HIT) > 0
    ids_same = ((rec_s >> 8)[hit_both] == (rec_m >> 8)[hit_both]).float().mean().item()
    flags_same = ((rec_s & 255)[hit_both] == (rec_m & 255)[hit_both]).float().mean().item()
    lanes_same = (rec_s == rec_m).all(dim=0).float().mean().item()
    print(f"staged record book1 1920x1080 4spp d8: {staged_ms:.1f} ms ({staged_got['k10']} K10 "
          f"launches), mega record {mega_ms:.1f} ms (K2); essential bits equal on {ess_same:.6f}, "
          f"ids on {ids_same:.6f} and flags on {flags_same:.6f} of rows both hit, whole lanes "
          f"on {lanes_same:.6f}")
    if not (ess_same > 0.99 and ids_same > 0.99 and flags_same > 0.99):
        raise AssertionError("the staged and the mega records disagree")
    cells["book1_record"] = dict(staged_ms=staged_ms, mega_ms=mega_ms, ess_equal=ess_same,
                                 ids_equal=ids_same, flags_equal=flags_same,
                                 lanes_equal=lanes_same, k10_launches=staged_got["k10"])
    kernels["sphere_hit"]["launches"] += staged_got["k10"]
    kernels["megakernel_record"]["launches"] += 1
    del rec_s, rec_m
    k10_primary(sd, cp, 1920, 1080, pix, smp, "the staged record's")
    del pix, smp

    mark("main path 24b: the gradient step of a fan without a BVH, 1024x1024 4spp d8")
    fan_sc = fan(tscene, 1024, count=40)
    fsd, fcp = fan_sc.build(device=dev), fan_sc.scene_cam.params(device=dev)
    if fsd.use_bvh or replay.resolve_record_mode("auto", fsd, fcp) != "staged":
        raise AssertionError("the 40-triangle fan should have no BVH and record staged")
    params = grad.extract_params(fsd, fcp)
    fp = 1024 * 1024
    args = (torch.zeros((fp, 3), device=dev), torch.arange(fp, device=dev), seed)
    kw = dict(width=1024, height=1024, spp=spp, max_depth=depth)
    grad.loss_and_grad(params, fsd, fcp, *args, **kw)  # warm
    zero()
    (loss, g), step_ms = host_ms(lambda: grad.loss_and_grad(params, fsd, fcp, *args, **kw))
    step_got = launched()
    if set(step_got) != {"k10"} or not torch.isfinite(loss) or not all(
            torch.isfinite(v).all() for v in grad.leaves(g).values()):
        raise AssertionError(f"fan step: launches {step_got}, loss {float(loss)}")
    (loss2, _), step2_ms = host_ms(lambda: grad.loss_and_grad(params, fsd, fcp, *args, **kw))
    if not torch.equal(loss, loss2):
        raise AssertionError("fan step: two steps differ")
    print(f"fan (40 triangles, no BVH) step 1024x1024 4spp d8 (staged record + eager replay): "
          f"{step_ms:.1f} / {step2_ms:.1f} ms, loss {float(loss):.6f}; launches {step_got}")
    kernels["sphere_hit"]["launches"] += step_got["k10"]
    # K10 at the step's first bounce, on the table of the fan's one sphere
    # (the staging of a table padded past its active rows).
    fpix = torch.arange(fp, device=dev).repeat(spp)
    k10_primary(fsd, fcp, 1024, 1024, fpix, torch.arange(spp, device=dev).repeat_interleave(fp),
                "the fan step's")
    del fpix
    # The card against the CPU at 64 wide.
    small = fan(tscene, 64, count=40)
    sides = []
    for where in (dev, torch.device("cpu")):
        ssd, scp = small.build(device=where), small.scene_cam.params(device=where)
        sp = 64 * 64
        sides.append(grad.loss_and_grad(
            grad.extract_params(ssd, scp), ssd, scp, torch.zeros((sp, 3), device=where),
            torch.arange(sp, device=where), seed, width=64, height=64, spp=2, max_depth=depth))
    (cl, cg), (hl, hg) = sides
    rel = abs(float(cl) - float(hl)) / abs(float(hl))
    worst = 0.0
    for key in ("tex_color", "mat_emission", "mat_fuzz"):
        scale = max(float(hg[key].abs().max()), 1e-6)
        worst = max(worst, float((cg[key].cpu() - hg[key]).abs().max()) / scale)
    print(f"fan step 64x64 2spp d8, card vs CPU: loss rel {rel:.3g}, radiometric gradients "
          f"normalized {worst:.3g}")
    if not (rel <= 1e-4 and worst <= 1e-3):
        raise AssertionError("fan step: card and CPU disagree")
    cells["fan_step"] = dict(ms=step_ms, ms_again=step2_ms, loss=float(loss),
                             card_vs_cpu_loss_rel=rel, card_vs_cpu_grad=worst,
                             k10_launches=step_got["k10"])
    return cells


def sharded_path(dev, kernels: dict, mark) -> dict:
    """Main path 25, sharded renders and gradients (ROADMAP A9) -> its
    cells, in a process group of one over tcp://127.0.0.1 with ``nccl``.

    book1 1920x1080 32 spp d50 through ``render_image_sharded_mega``: the
    default mesh (one position: this process's card) and four bands on
    cuda:0, against one dispatch of ``render_image_persistent``, each bit
    for bit; every call is made twice (a warm call and a timed one; the
    first sharded call also builds the scene on the card and sets up
    nccl), and each call's K1 launches are counted from 0 and held to one
    a band. Then ``loss_and_grad_sharded`` over four pixel shards of book1
    320x180 4 spp d8 (one K2 and one K3 launch a shard, counted; the sums
    ``all_reduce``d) against one ``loss_and_grad``: loss rel 1e-5,
    radiometric gradients normalized 1e-4 (the shards' sums add in another
    order); and shard 0's K2 (records and fused radiance, bit for bit) and
    K3 (``k3_scheme``) against their plain versions on that shard's lanes,
    records and loss cotangent. Any failed check raises; the group is
    destroyed."""
    import socket

    import torch
    import torch.distributed as dist

    from crucible_tpu_torch import grad
    from crucible_tpu_torch.models import demo, integrator, render
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import megakernel as mk
    from crucible_tpu_torch.ops.kernels import replay_kernel as rk
    from crucible_tpu_torch.parallel import mesh as pmesh
    from crucible_tpu_torch.parallel import render as prender

    zero, launched = _launch_counter()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1,
                            rank=0)
    cells = {}
    try:
        mark("main path 25a: book1 1920x1080 32spp d50 in bands (nccl, a world of one)")
        sc = demo.book1_end_scene(width=1920)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        k1 = 0

        def counted(label, fn, want):
            """(out, ms) of ``fn``, its K1 launches counted from 0 and held
            to ``want``; adds them to the path's K1 count."""
            nonlocal k1
            zero()
            out, ms = host_ms(fn)
            got = launched()
            if got != {"forward_brute": want}:
                raise AssertionError(f"{label}: launches {got}, {want} K1 expected")
            k1 += want
            return out, ms

        def one_dispatch():
            return render.render_image_persistent(sd, cp, 1920, 1080, 32, 50, sc.seed,
                                                  device=dev)

        counted("one dispatch (warm)", one_dispatch, 1)
        one, one_ms = counted("one dispatch", one_dispatch, 1)
        mesh1 = pmesh.make_mesh()
        if not (mesh1.group and mesh1.size == 1 and mesh1.device(0) == dev):
            raise AssertionError(f"the default mesh of a world of one: {mesh1}")
        mesh4 = pmesh.make_mesh(devices=[dev] * 4)
        runs = {}
        for label, mesh in (("1 band", mesh1), ("4 bands", mesh4)):
            def bands(mesh=mesh):
                return prender.render_image_sharded_mega(sc, mesh, samples=32, max_depth=50)

            img, first_ms = counted(label, bands, mesh.size)
            # Timed again warm: the first call also builds the scene on the
            # device and, for the first all_gather, sets up nccl.
            again, ms = counted(f"{label} (warm)", bands, mesh.size)
            bit_equal(img, one, f"book1 {label} vs one dispatch")
            bit_equal(again, img, f"book1 {label}, warm call vs first")
            runs[label] = (ms, first_ms)
            del img, again
        print(f"book1 1920x1080 32spp d50: one dispatch {one_ms:.1f} ms, 1 band "
              f"{runs['1 band'][0]:.1f} ms (first call {runs['1 band'][1]:.1f} ms), 4 bands "
              f"{runs['4 bands'][0]:.1f} ms (first call {runs['4 bands'][1]:.1f} ms); one K1 "
              f"launch a band, all_gather over nccl; {k1} K1 launches counted")
        cells["bands"] = dict(one_dispatch_ms=one_ms, one_band_ms=runs["1 band"][0],
                              four_bands_ms=runs["4 bands"][0],
                              one_band_first_ms=runs["1 band"][1],
                              four_bands_first_ms=runs["4 bands"][1], k1_launches=k1)
        del runs, one

        mark("main path 25b: loss_and_grad_sharded, book1 320x180 4spp d8, 4 shards")
        small = demo.book1_end_scene(width=320)
        ssd, scp = small.build(device=dev), small.scene_cam.params(device=dev)
        sp = 320 * 180
        params = grad.extract_params(ssd, scp)
        args = (torch.zeros((sp, 3), device=dev), torch.arange(sp, device=dev), 0)
        kw = dict(width=320, height=180, spp=4, max_depth=8)
        want_l, want_g = grad.loss_and_grad(params, ssd, scp, *args, **kw)
        zero()
        (got_l, got_g), shard_ms = host_ms(lambda: prender.loss_and_grad_sharded(
            params, ssd, scp, *args, mesh=mesh4, **kw))
        shard_got = launched()
        if shard_got != {"record_brute": 4, "k3": 4}:
            raise AssertionError(f"sharded gradient launches {shard_got}")
        rel = abs(float(got_l) - float(want_l)) / abs(float(want_l))
        worst = 0.0
        for key in ("tex_color", "mat_emission", "mat_fuzz"):
            scale = max(float(want_g[key].abs().max()), 1e-6)
            worst = max(worst, float((got_g[key] - want_g[key]).abs().max()) / scale)
        print(f"loss_and_grad_sharded 4 shards vs one call: {shard_ms:.1f} ms, loss rel "
              f"{rel:.3g}, radiometric gradients normalized {worst:.3g}; launches {shard_got}")
        if not (rel <= 1e-5 and worst <= 1e-4):
            raise AssertionError("the sharded gradient and one call disagree")
        # Shard 0's K2 and K3 against their plain versions on its inputs:
        # its 57,600 lanes, its records and the cotangent of its loss.
        lo, hi = pmesh.ray_sharding(mesh4, sp)[0]
        pl, sl = (x.to(torch.int32) for x in grad._lanes(torch.arange(lo, hi, device=dev), 4, 0))
        k2 = dict(smem=torch.tensor([0, 0, 320, 8, 0, 0, 0, 0], dtype=torch.int32, device=dev),
                  pix=pl[None], sample0=sl[None], cam=integrator.mega_cam_vector(scp, 320, 180),
                  table=integrator.make_sphere_table(ssd).contiguous())
        acc, rec = mk.run_megakernel_record(**k2, max_depth=8, radiance=True)
        ref_acc, ref_rec = mk.run_megakernel_record_reference(**k2, max_depth=8, radiance=True)
        what = f"shard 0 ({pl.shape[0]} lanes) of book1 320x180 4spp d8"
        bit_equal(rec, ref_rec, f"K2 records on {what} vs plain")
        k2_err = bit_equal(acc, ref_acc, f"K2 fused radiance on {what} vs plain")
        o, d, _ = generate_rays(scp, 320, 180, pl, sl, 0)
        img = acc.t().reshape(4, hi - lo, 3).mean(dim=0)
        g_rad = (2 * img / img.numel()).repeat(4, 1) / 4  # d loss / d radiance
        rargs = (k2["table"], o.contiguous(), d.contiguous(), torch.ones_like(pl), pl, sl, rec, 0)
        k3_err = k3_scheme(rk.replay_backward(*rargs, g_rad),
                           rk.replay_backward_reference(*rargs, g_rad), f"K3 on {what}")
        cells["gradient"] = dict(ms=shard_ms, loss_rel=rel, grad_normalized=worst,
                                 shard_k2_err=k2_err, shard_k3_err=k3_err)
        del k2, acc, rec, ref_acc, ref_rec, o, d, rargs
    finally:
        dist.destroy_process_group()
    kernels["megakernel_forward"]["launches"] += k1
    kernels["megakernel_forward"]["sharded_path_launches"] = k1
    kernels["megakernel_record"]["launches"] += shard_got["record_brute"]
    kernels["replay_backward"]["launches"] += shard_got["k3"]
    return cells


# Main path 26 (exact_path): frame 0's shutter at 24 fps and 180 degrees
# is [0, 1/48) s, and a key at 1/96 s falls strictly inside it.
EXACT_KEY = 1.0 / 96.0
# Bouncing book1 keyed inside the shutter renders at 1920x1080 d50 through
# the staged bounce's exact branch (every sphere's track evaluated at each
# ray's time, in plain torch: no kernel computes it, in the JAX package
# either), so its render is cut from the 32 spp of the other 1080p renders
# to 1: 8 spp took 135.7 s on an H100 (NVIDIA H100 80GB HBM3, 700 W).
EXACT_RENDER_SPP = 4
# The exact-time torus (main path 26d) walks its BVH in the eager lockstep
# loop with the vertex hook: 320x180, 2 spp, depth 8.
EXACT_TORUS_W, EXACT_TORUS_SPP, EXACT_TORUS_DEPTH = 320, 2, 8


def exact_flash(scene, width: int):
    """An emissive sphere of radius 50 NERP-teleports at t = 0.01 s from
    (400, 0, 0), outside the 16:9 view, to (0, 0, -3), around the camera:
    the JAX package's tests/test_timeline.py flash, its start moved out of
    a 16:9 frustum -> (scene, key, emission)."""
    emission = (1.0, 0.5, 0.25)
    sc = scene.Scene(aspect_ratio=16.0 / 9.0, image_width=width)
    sc.add_element(scene.Sphere((400.0, 0.0, 0.0), 50.0, scene.Emissive(emission)), "flash")
    sc.translate_point((0.0, 0.0, -3.0), 0.01, "nerp", "world", "flash")
    return sc, 0.01, emission


def exact_bvh_wall(scene, width: int):
    """200 emissive triangles (a BVH mesh) forming a 600-wide wall behind
    the camera NERP-shift in front of it at t = 0.008 s (the JAX package's
    BVH wall teleport) -> (scene, key, emission)."""
    emission, n, ext = (0.8, 0.1, 0.6), 10, 300.0
    sc = scene.Scene(aspect_ratio=16.0 / 9.0, image_width=width)
    for i in range(n):
        for j in range(n):
            x0, x1 = -ext + 2 * ext * i / n, -ext + 2 * ext * (i + 1) / n
            y0, y1 = -ext + 2 * ext * j / n, -ext + 2 * ext * (j + 1) / n
            for tag, tri in (("a", ((x0, y0, 5.0), (x1, y0, 5.0), (x1, y1, 5.0))),
                             ("b", ((x0, y0, 5.0), (x1, y1, 5.0), (x0, y1, 5.0)))):
                sc.add_element(scene.Triangle(*tri, scene.Emissive(emission)), f"t{i}_{j}{tag}")
                sc.translate_point((0.0, 0.0, -10.0), 0.008, "nerp", "local", f"t{i}_{j}{tag}")
    return sc, 0.008, emission


def exact_camera(scene, width: int):
    """The camera NERP-teleports from the origin to (0, 5, 0) at t = 0.015 s
    (the JAX package's camera teleport) -> (scene, key, position after)."""
    sc = scene.Scene(aspect_ratio=16.0 / 9.0, image_width=width)
    sc.cam_translate_point((0.0, 5.0, 0.0), 0.015, "nerp", "world", "from")
    return sc, 0.015, (0.0, 5.0, 0.0)


def exact_torus(scene, width: int):
    """torus_teapot with every triangle rising by 0.5 up to 1/96 s, a key
    inside frame 0's shutter: a tri_exact BVH mesh beside the ground."""
    sc = torus_teapot(scene, width)
    for k in range(6320):
        sc.translate_y(0.5, EXACT_KEY, "lerp", "local", f"tri{k}")
    return sc


def exact_path(dev, kernels: dict, mark) -> dict:
    """Main path 26, exact-time motion (ROADMAP A7): a keyframe strictly
    inside the shutter -> its cells. No kernel computes an exact-time search
    (the JAX package keeps such scenes off its kernels too): a scene's
    spheres and vertices are evaluated at each ray's time in plain torch on
    the staged bounce; a camera's tracks leave the scene's kernels in place.

    a. The JAX package's oracles at 1920x1080 4 spp (``render_rays``,
       depth 4): the flash and the BVH wall teleport (through the walk's
       vertex hook), each ray's radiance the emission past the key, else
       the sky, within 1e-5; the camera teleport's ray origins. No kernel
       launches. Timed, with the lanes, chunks and peak memory.
    b. Book1 with its camera alone keyed at 1/96 s (its table static):
       ``render_image`` 1920x1080 32 spp d50 (auto -> pixel: K9 only,
       counted), timed, peak memory; K9 on its primary rays bit for bit
       against its plain version; at 64 wide the replayed step on the card
       against the CPU's on the card's records and rays (loss rel 1e-4,
       radiometric gradients normalized 1e-3); the 1080p 4 spp d8 gradient
       step by phase (rays, the staged record with K10 a bounce, the
       replay forward with K4, its backward with K3; counted); K10 bit for
       bit on the step's primary rays, K4 bit for bit and K3 within
       ``k3_scheme`` on N_SUB lanes of its records.
    c. Bouncing book1 keyed at 1/96 s, all 488 rows: ``render_image``
       1920x1080 EXACT_RENDER_SPP spp d50 (auto -> pixel, the exact branch;
       no kernel), with the lanes, the chunks and the peak memory; the
       1080p 4 spp d8 step by phase; card against CPU at 64 wide as in b.
    d. The 6,320-triangle torus rising with a key inside the shutter
       (:func:`exact_torus`) at EXACT_TORUS_W x 180: its build, its render
       (the BVH walk's vertex hook) and its gradient step, timed.

    Any failed check raises."""
    import torch

    from crucible_tpu_torch import grad
    from crucible_tpu_torch.io.image import write_png
    from crucible_tpu_torch.models import demo, integrator, render, replay, skybox
    from crucible_tpu_torch.models import scene as tscene
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import replay_kernel as rk
    from crucible_tpu_torch.ops.kernels import sphere_hit as sh
    from crucible_tpu_torch.ops.kernels import sphere_shade as ss
    from torch.profiler import DeviceType, ProfilerActivity, profile

    zero, launched = _launch_counter()
    seed, cells = 0, {}
    w, h = 1920, 1080
    p = w * h
    cpu = torch.device("cpu")

    def lanes(width, height, spp, where=dev):
        n = width * height
        return (torch.arange(n, device=where).repeat(spp),
                torch.arange(spp, device=where).repeat_interleave(n))

    def peak_gib():
        return torch.cuda.max_memory_allocated() / 2**30

    def exact_shape(sd, r):
        return dict(lanes=r, chunk_lanes=min(r, integrator.exact_lanes(sd)),
                    chunks=len(integrator.exact_chunks(sd, r)))

    def card_vs_cpu(make, what):
        """The replayed step at 64 wide, 2 spp, d8 on the card and on the
        CPU from the same inputs, the card's records and primary rays
        (``grad.record_decisions``, ``generate_rays``): the loss (L2
        against zero) and its gradient in the radiometric leaves (albedo,
        emission: fault C4), held at loss rel 1e-4 and normalized 1e-3;
        the fuzz gradient's agreement is printed (fault C11: one grazing
        lane parts it on bouncing book1, tools/torch_exact_fuzz.py). The
        rays are the card's
        because a per-ray camera basis rounds its square roots on each
        device: one lane of 4,608 parting breaks 1e-4."""
        small = make(64)
        sw, sh_ = small.scene_cam.image_width, small.scene_cam.image_height
        csd, ccp = small.build(device=dev), small.scene_cam.params(device=dev)
        pixels = torch.arange(sw * sh_, device=dev)
        rec = grad.record_decisions(csd, ccp, pixels, seed, width=sw, height=sh_, spp=2,
                                    max_depth=8)
        pl, sl = lanes(sw, sh_, 2)
        o, d, _ = generate_rays(ccp, sw, sh_, pl, sl, seed)
        sides = []
        for where in (dev, cpu):
            ssd = small.build(device=where)
            leaves = {k: getattr(ssd, k).detach().clone().requires_grad_(True)
                      for k in ("mat_emission", "mat_fuzz")}
            color = ssd.tex.color.detach().clone().requires_grad_(True)
            ssd = replace(ssd, tex=replace(ssd.tex, color=color), **leaves)
            rad = replay.trace_replay(ssd, o.to(where), d.to(where), pl.to(where),
                                      sl.to(where), seed, 8, rec.to(where))
            loss = torch.mean(rad.reshape(2, -1, 3).mean(dim=0) ** 2)
            g = torch.autograd.grad(loss, [color, leaves["mat_emission"], leaves["mat_fuzz"]])
            sides.append((loss.detach().cpu(), [x.cpu() for x in g]))
        (cl, cg), (hl, hg) = sides
        rel = abs(float(cl) - float(hl)) / abs(float(hl))
        err = {key: float((a - b).abs().max()) / max(float(b.abs().max()), 1e-6)
               for key, a, b in zip(("tex_color", "mat_emission", "mat_fuzz"), cg, hg)}
        worst = max(err["tex_color"], err["mat_emission"])
        print(f"  {what} replayed step {sw}x{sh_} 2spp d8, card vs CPU on the card's records "
              f"and rays: loss rel {rel:.3g}, radiometric gradients normalized {worst:.3g} "
              f"(fuzz {err['mat_fuzz']:.3g}, scale {float(hg[2].abs().max()):.3g})")
        if not (rel <= 1e-4 and worst <= 1e-3):
            raise AssertionError(f"{what}: card and CPU disagree")
        return dict(loss_rel=rel, grad_normalized=worst, fuzz_normalized=err["mat_fuzz"])

    def step_by_phase(sd, cp, what, spp=4, width=w, height=h):
        """The gradient step cut into its phases, each synchronized: ray
        generation, the staged record, the replay forward (with the loss)
        and its backward, the launch counts read over the whole step ->
        (cell, launches)."""
        params = grad.extract_params(sd, cp)
        target = torch.zeros((width * height, 3), device=dev)
        leaves = {k: params[k].detach().requires_grad_(True) for k in grad.leaf_keys(params)}
        sd2, cp2 = grad.apply_params(sd, cp, {**params, **leaves})
        pl, sl = lanes(width, height, spp)
        zero()
        torch.cuda.reset_peak_memory_stats()
        (o, d, _), t_rays = host_ms(lambda: generate_rays(cp2, width, height, pl, sl, seed))
        rec, t_rec = host_ms(lambda: replay.trace_record(sd2, o, d, pl, sl, seed, 8))

        def forward():
            rad = replay.trace_replay(sd2, o, d, pl, sl, seed, 8, rec)
            return torch.mean((rad.reshape(spp, -1, 3).mean(dim=0) - target) ** 2)

        loss, t_fwd = host_ms(forward)
        g, t_bwd = host_ms(lambda: torch.autograd.grad(loss, list(leaves.values()),
                                                       allow_unused=True))
        got, peak = launched(), peak_gib()
        loss = loss.detach()
        total = t_rays + t_rec + t_fwd + t_bwd
        if not torch.isfinite(loss) or not all(x is None or bool(torch.isfinite(x).all())
                                               for x in g):
            raise AssertionError(f"{what} step: non-finite loss or gradients")
        print(f"  {what} step {width}x{height} {spp}spp d8 by phase: rays {t_rays:.1f} ms, "
              f"staged record {t_rec:.1f} ms, replay forward {t_fwd:.1f} ms, backward "
              f"{t_bwd:.1f} ms (sum {total:.1f} ms), loss {float(loss):.6f}, peak memory "
              f"{peak:.2f} GiB; launches {got}")
        return dict(rays_ms=t_rays, record_ms=t_rec, forward_ms=t_fwd, backward_ms=t_bwd,
                    step_ms=total, peak_gib=peak, loss=float(loss)), got

    # --- a. the JAX package's oracles at 1080p -----------------------------------
    mark("main path 26a: exact-time oracles at 1920x1080 4spp (flash, BVH wall, camera)")
    pix, smp = lanes(w, h, 4)
    for name, make in (("flash", exact_flash), ("bvh_wall", exact_bvh_wall)):
        sc, key, emission = make(tscene, w)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        if not sd.motion_exact or (sd.use_bvh and sd.tri_exact) != (name == "bvh_wall"):
            raise AssertionError(f"{name}: not the exact-time scene expected")
        zero()
        torch.cuda.reset_peak_memory_stats()
        rad, ms = host_ms(lambda: integrator.render_rays(sd, cp, w, h, pix, smp, seed, 4))
        got, peak = launched(), peak_gib()
        after = integrator.exact_time(sd, integrator.shutter_fraction(pix, smp, seed)) >= \
            torch.tensor(key, dtype=torch.float32, device=dev)
        _, d, _ = generate_rays(cp, w, h, pix, smp, seed)
        expected = torch.where(after[:, None], torch.tensor(emission, device=dev),
                               skybox.radiance(sd.sky_kind, sd.sky_image, d))
        err, frac = (rad - expected).abs().max().item(), after.float().mean().item()
        shape = exact_shape(sd, pix.shape[0])
        print(f"exact {name} 1920x1080 4spp d4 (render_rays): {ms:.1f} ms, max|diff| to the "
              f"oracle {err:.3g}, {frac:.4f} of rays past the key, {shape['chunks']} chunks of "
              f"{shape['chunk_lanes']} lanes, peak memory {peak:.2f} GiB; launches {got}")
        if got or not (err <= 1e-5 and 0.1 < frac < 0.9):
            raise AssertionError(f"exact {name}: the oracle does not hold")
        cells[name] = dict(ms=ms, max_err=err, past_key=frac, peak_gib=peak, **shape)
        del rad, expected, d, after
    sc, key, after_pos = exact_camera(tscene, w)
    cp = sc.scene_cam.params(device=dev)
    (o, _, times), ms = host_ms(lambda: generate_rays(cp, w, h, pix, smp, seed))
    after = times >= torch.tensor(key, dtype=torch.float32, device=dev)
    expected = torch.where(after[:, None], torch.tensor(after_pos, device=dev),
                           torch.zeros(3, device=dev))
    err, frac = (o - expected).abs().max().item(), after.float().mean().item()
    print(f"exact camera teleport 1920x1080 4spp: generate_rays {ms:.1f} ms, max|diff| of the "
          f"origins to the oracle {err:.3g}, {frac:.4f} past the key")
    if not (cp.motion_exact and err <= 1e-5 and 0.1 < frac < 0.9):
        raise AssertionError("exact camera teleport: the oracle does not hold")
    cells["camera_teleport"] = dict(ms=ms, max_err=err, past_key=frac)
    del o, times, after, expected, pix, smp

    # --- b. the camera alone keyed inside the shutter: K9, K10, K4, K3 ----------------
    mark("main path 26b: book1 with its camera keyed at 1/96 s (K9, K10, K4, K3)")
    sc = bouncing_book1(demo, w, EXACT_KEY, spheres=False)
    sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    if (sd.motion_exact or not cp.motion_exact or not integrator.fused_supported(sd)
            or render.auto_schedule(sd, cp, dev) != "pixel"):
        raise AssertionError("book1 under a camera track should take the pixel schedule (K9)")
    render.render_image(sc, 1, 2, device=dev)  # warm
    zero()
    torch.cuda.reset_peak_memory_stats()
    img, ms = host_ms(lambda: render.render_image(sc, 32, 50, device=dev))
    got, peak = launched(), peak_gib()
    if set(got) != {"k9"} or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"book1 under a camera track: launches {got}")
    write_png(REPO / "build" / "chip_smoke_exact_camera.png", render.to_u8(img))
    print(f"render_image book1 camera keyed at 1/96 s 1920x1080 32spp d50 (auto -> pixel): "
          f"{ms / 1e3:.3f} s, {p * 32 / ms / 1e3:.2f} Mpaths/s, peak memory {peak:.2f} GiB, "
          f"mean {img.mean().item():.5f}; launches {got}")
    kernels["sphere_shade"]["launches"] += got["k9"]
    k9_share = got["k9"] * kernels["sphere_shade"]["main_ms"] / ms
    print(f"  K9's share of the render: {got['k9']} launches x "
          f"{kernels['sphere_shade']['main_ms']:.4f} ms (its main shape's time) = "
          f"{got['k9'] * kernels['sphere_shade']['main_ms'] / 1e3:.3f} s of {ms / 1e3:.3f} s "
          f"({100 * k9_share:.1f}%)")
    cells["camera_render"] = dict(ms=ms, peak_gib=peak, k9_launches=got["k9"],
                                  k9_share=k9_share)
    table = integrator.make_sphere_table(sd).contiguous()
    o, d, _ = generate_rays(cp, w, h, torch.arange(p, device=dev),
                            torch.zeros(p, dtype=torch.int64, device=dev), seed)
    o, d = o.contiguous(), d.contiguous()
    w0 = torch.zeros((p,), device=dev)
    bit_equal(ss.hit_spheres_fetch(o, d, w0, table),
              ss.hit_spheres_fetch_reference(o, d, w0, table),
              f"K9 on the camera-track primary rays ({p} rays, {table.shape[0]} rows)")
    del img, o, d, w0
    cells["camera_card_vs_cpu"] = card_vs_cpu(
        lambda width: bouncing_book1(demo, width, EXACT_KEY, spheres=False),
        "book1 under a camera track")  # also the first launches of K10, K4 and K3
    cell, got = step_by_phase(sd, cp, "book1 under a camera track")
    if set(got) != {"k10", "k4", "k3"} or not 1 <= got["k10"] <= 8 or got["k4"] != 1 \
            or got["k3"] != 1:
        raise AssertionError(f"book1 under a camera track, step: launches {got}")
    kernels["sphere_hit"]["launches"] += got["k10"]
    kernels["replay_forward"]["launches"] += got["k4"]
    kernels["replay_backward"]["launches"] += got["k3"]
    cells["camera_step"] = dict(cell, launches=got)
    pl, sl = lanes(w, h, 4)
    o, d, _ = generate_rays(cp, w, h, pl, sl, seed)
    o, d = o.contiguous(), d.contiguous()
    cols = (table[:, 0:3].contiguous(), table[:, 4].contiguous(), table[:, 5].contiguous())
    for a, b, name in zip(sh.hit_spheres(o, d, *cols), sh.hit_spheres_reference(o, d, *cols),
                          ("t", "idx", "hit")):
        bit_equal(a, b, f"K10 on the step's {o.shape[0]} primary rays: {name}")
    rec = replay.trace_record(sd, o, d, pl, sl, seed, 8)
    sub = torch.randperm(o.shape[0], generator=torch.Generator().manual_seed(0))[:N_SUB]
    sub = sub.sort().values.to(dev)
    args = (table, o[sub].contiguous(), d[sub].contiguous(),
            torch.ones((N_SUB,), dtype=torch.int32, device=dev), pl[sub].to(torch.int32),
            sl[sub].to(torch.int32), rec[:, sub].contiguous(), seed)
    del rec, o, d, pl, sl
    bit_equal(rk.replay_forward(*args), rk.replay_forward_reference(*args),
              f"K4 on {N_SUB} lanes of the step's staged records")
    g_rad = torch.randn((N_SUB, 3), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    k3_scheme(rk.replay_backward(*args, g_rad), rk.replay_backward_reference(*args, g_rad),
              f"K3 on {N_SUB} lanes of the step's staged records")

    # --- c. bouncing book1 keyed inside the shutter: the exact branch ------------------
    mark("main path 26c: bouncing book1 keyed at 1/96 s, 1920x1080, the exact branch")
    sc = bouncing_book1(demo, w, EXACT_KEY)
    sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    if (not sd.motion_exact or integrator.fused_supported(sd)
            or render.auto_schedule(sd, cp, dev) != "pixel"):
        raise AssertionError("bouncing book1 keyed inside the shutter should take the pixel "
                             "schedule's staged bounce")
    r = (p + 511) // 512 * 512  # the pixel schedule's lanes: one sample group at 1080p
    shape = exact_shape(sd, r)
    zero()
    torch.cuda.reset_peak_memory_stats()
    img, ms = host_ms(lambda: render.render_image(sc, EXACT_RENDER_SPP, 50, device=dev))
    got, peak = launched(), peak_gib()
    if got or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bouncing book1 exact: launches {got} (no kernel expected)")
    write_png(REPO / "build" / "chip_smoke_exact_bounce.png", render.to_u8(img))
    print(f"render_image bouncing book1 keyed at 1/96 s 1920x1080 {EXACT_RENDER_SPP}spp d50 "
          f"(auto -> pixel, the exact branch): {ms / 1e3:.3f} s, "
          f"{p * EXACT_RENDER_SPP / ms / 1e3:.3f} Mpaths/s, {shape['lanes']} lanes in "
          f"{shape['chunks']} chunks of {shape['chunk_lanes']} a bounce "
          f"({sd.sph_center.shape[0]} rows, {sd.sph_tr_t0.shape[1]} translate and "
          f"{sd.sph_sc_t0.shape[1]} scale segments), peak memory {peak:.2f} GiB, mean "
          f"{img.mean().item():.5f}")
    cells["bounce_render"] = dict(ms=ms, spp=EXACT_RENDER_SPP, peak_gib=peak,
                                  rows=int(sd.sph_center.shape[0]), **shape)
    del img
    # One chunk of the exact branch (the primary rays of its first lanes),
    # timed and under the profiler: where a bounce's time goes.
    n1 = shape["chunk_lanes"]
    pl1 = torch.arange(n1, device=dev)
    sl1 = torch.zeros_like(pl1)
    o1, d1, _ = generate_rays(cp, w, h, pl1, sl1, seed)
    w1 = integrator.shutter_fraction(pl1, sl1, seed)
    integrator.intersect_scene(sd, o1, d1, w1)  # warm
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, chunk_ms = host_ms(lambda: integrator.intersect_scene(sd, o1, d1, w1))
    chunk_bytes = torch.cuda.max_memory_allocated() - base
    per_entry = chunk_bytes / (n1 * sd.sph_center.shape[0])
    budgeted = integrator.EXACT_BUDGET_BYTES // n1 // sd.sph_center.shape[0]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        integrator.intersect_scene(sd, o1, d1, w1)
        torch.cuda.synchronize()
    rows = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                  key=lambda e: -e.self_device_time_total)
    device_ms = sum(e.self_device_time_total for e in rows) / 1e3
    top = [(e.key[:60], e.self_device_time_total / 1e3, e.count) for e in rows[:6]]
    print(f"  one chunk of the exact branch ({n1} lanes x {sd.sph_center.shape[0]} rows, "
          f"intersect_scene): {chunk_ms:.2f} ms, {device_ms:.2f} ms on the device in "
          f"{sum(e.count for e in rows)} launches, {chunk_bytes / 2**30:.3f} GiB at its peak "
          f"above its inputs ({per_entry:.1f} B a lane and row; exact_lanes counts "
          f"{budgeted}); " + "; ".join(f"{k} {t:.2f} ms x{c}" for k, t, c in top))
    cells["bounce_chunk"] = dict(ms=chunk_ms, device_ms=device_ms, peak_bytes=chunk_bytes,
                                 bytes_per_lane_row=per_entry, budgeted=budgeted,
                                 launches=sum(e.count for e in rows), top=top)
    del o1, d1, w1
    cells["bounce_card_vs_cpu"] = card_vs_cpu(
        lambda width: bouncing_book1(demo, width, EXACT_KEY), "bouncing book1 keyed at 1/96 s")
    cell, got = step_by_phase(sd, cp, "bouncing book1 keyed at 1/96 s")
    if got:
        raise AssertionError(f"bouncing book1 exact step: launches {got} (no kernel expected)")
    cells["bounce_step"] = dict(cell, **exact_shape(sd, 4 * p))

    # --- d. a BVH mesh keyed inside the shutter: the walk's vertex hook -----------------
    mark("main path 26d: the 6,320-triangle torus rising with a key inside the shutter")
    sc = exact_torus(tscene, EXACT_TORUS_W)
    tw, th = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, build_ms = host_ms(lambda: sc.build(device=dev))
    cp = sc.scene_cam.params(device=dev)
    if not (sd.use_bvh and sd.tri_exact and sd.motion_exact) or integrator.megakernel_supported(
            sd, cp):
        raise AssertionError("the exact-time torus should be a tri_exact BVH mesh")
    zero()
    torch.cuda.reset_peak_memory_stats()
    img, ms = host_ms(lambda: render.render_image(sc, EXACT_TORUS_SPP, EXACT_TORUS_DEPTH,
                                                  device=dev))
    got, peak = launched(), peak_gib()
    if got or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"exact torus: launches {got} (no kernel expected)")
    write_png(REPO / "build" / "chip_smoke_exact_torus.png", render.to_u8(img))
    print(f"render_image exact-time torus {tw}x{th} {EXACT_TORUS_SPP}spp d{EXACT_TORUS_DEPTH} "
          f"(auto -> pixel, the BVH walk's vertex hook): {ms / 1e3:.3f} s, build "
          f"{build_ms / 1e3:.3f} s ({sd.tri_tr_t0.shape[0]} vertex track rows), peak memory "
          f"{peak:.2f} GiB, mean {img.mean().item():.5f}")
    cells["torus_render"] = dict(ms=ms, build_ms=build_ms, peak_gib=peak)
    cell, got = step_by_phase(sd, cp, "exact-time torus", spp=EXACT_TORUS_SPP, width=tw,
                              height=th)
    if got:
        raise AssertionError(f"exact torus step: launches {got} (no kernel expected)")
    cells["torus_step"] = cell
    return cells


# Main path 27 (golden_path): the kernels each config's route launches on the
# card, by launch-counter key (:func:`_launch_counter`); the gradient check's
# over all its checks. The fused record pass gives the replay's primal, so K4
# runs in none of them (the JAX harness's replay_given likewise).
GOLDEN_ROUTES = {
    "smoke_scene": ("forward_brute",),
    "book1_end_scene": ("forward_brute",),
    "checkered_spheres": ("forward_brute",),
    "earth": ("record_brute",),
    "load_teapot": ("forward_tri",),
    "garden_skybox": ("k9",),
    "sphere_stress": ("forward_walk",),
    "nested_checkers": ("record_brute",),
    "book1_deep50": ("record_brute",),
}
GRADCHECK_ROUTE = ("k10", "record_brute", "k3")
# Launch-counter keys -> the names of the kernels line.
KERNEL_OF_COUNT = {
    "forward_brute": "megakernel_forward", "forward_walk": "megakernel_walk",
    "forward_tri": "megakernel_tri", "record_brute": "megakernel_record",
    "k9": "sphere_shade", "k10": "sphere_hit", "k4": "replay_forward", "k3": "replay_backward",
}


def golden_path(dev, kernels: dict, mark) -> dict:
    """Main path 27, the golden check on the card (``tools/torch_golden.py``):
    every config of ``tests/goldens/golden_tpu_v1.npz`` through its
    production schedule (``auto``; ``book1_deep50`` through the deep
    gradient path's forward), held to the JAX package's image at the JAX
    harness's bounds; earth and load_teapot held where their original
    assets resolve, else printed as not held (earth over a generated map,
    through ``record``). Then the gradient check: direct AD against the
    replay (smoke, book1), three central-difference checks, the depth-50
    gradients finite. One JSON line a config and one for the gradient
    check. Each row's launches are counted from 0 and must hold the kernels
    of its route (``GOLDEN_ROUTES``, ``GRADCHECK_ROUTE``); they are added to
    ``kernels``. Any failed check raises."""
    from tools import torch_golden as tg

    cells, counts = {}, {}

    def route(what, got, want):
        missing = [k for k in want if not got.get(k)]
        if missing:
            raise AssertionError(f"golden {what}: no launch of {missing} (launches {got})")
        for key, n in got.items():
            if key not in KERNEL_OF_COUNT:
                raise AssertionError(f"golden {what}: an unexpected kernel {key} ({got})")
            counts[key] = counts.get(key, 0) + n

    mark("main path 27a: the golden check, every config of golden_tpu_v1.npz")
    t0 = time.perf_counter()
    verdict = tg.golden(str(dev))
    for row in verdict["configs"]:
        print("golden " + json.dumps(row))
        if "launches" in row:
            route(row["config"], row["launches"], GOLDEN_ROUTES[row["config"]])
    cells["golden_s"] = time.perf_counter() - t0
    if not verdict["ok"]:
        raise AssertionError(f"golden drift in: {verdict['drifted']}")

    mark("main path 27b: the gradient check (AD vs replay, central differences, depth 50)")
    t0 = time.perf_counter()
    checked = tg.gradcheck(str(dev))
    print("gradcheck " + json.dumps(checked))
    total = {}
    for got in checked["launches"].values():
        for key, n in got.items():
            total[key] = total.get(key, 0) + n
    route("gradcheck", total, GRADCHECK_ROUTE)
    cells["gradcheck_s"] = time.perf_counter() - t0
    cells["gradcheck_launches"] = total
    if not checked["ok"]:
        raise AssertionError(f"gradcheck drift in: {checked['failed']}")
    for key, n in counts.items():
        name = KERNEL_OF_COUNT[key]
        kernels[name]["launches"] += n
        kernels[name]["golden_path_launches"] = n
    cells["launches"] = counts
    print("golden path launches: " + json.dumps(counts))
    return cells


def pixel_profile_path(dev, kernels: dict, mark) -> dict:
    """Main path 28, one iteration of the ``pixel`` schedule by stage
    (``tools/torch_profile_persistent.py``): book1 400 wide at 2^20 target
    lanes, ``generate_rays``, K9 alone and ``bounce_step_fused`` timed by
    CUDA events, then ``trace_persistent`` at 32 spp, depth 50, its
    iterations (one K9 launch each, held by the tool) and its time split
    into iters x (raygen + bounce) and the bookkeeping. The render's K9
    launches are added to ``kernels``. Any failed check raises."""
    from tools import torch_profile_persistent as tpp

    mark("main path 28: the pixel schedule by stage, book1 400w 32 spp d50")
    out = tpp.profile(400, 32, dev)
    times = ("raygen_ms", "k9_ms", "bounce_ms", "total_ms", "image_mean")
    if not (out["iters"] > 0 and all(math.isfinite(out[k]) and out[k] > 0 for k in times)):
        raise AssertionError(f"pixel profile: {out}")
    kernels["sphere_shade"]["launches"] += out["k9_launches"]
    kernels["sphere_shade"]["pixel_profile_launches"] = out["k9_launches"]
    return out


def main() -> None:
    if not (REPO / "crucible_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"chip_smoke: no crucible_tpu_torch package beside {__file__}")
    sys.path.insert(0, str(REPO))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")

    from crucible_tpu_torch import grad
    from crucible_tpu_torch.io.image import write_png
    from crucible_tpu_torch.models import demo, integrator, render
    from crucible_tpu_torch.models import replay, skybox, textures
    from crucible_tpu_torch.models import scene as tscene
    from crucible_tpu_torch.ops import intersect
    from crucible_tpu_torch.models.camera import generate_rays
    from crucible_tpu_torch.ops.kernels import build, megakernel as mk
    from crucible_tpu_torch.ops.kernels import replay_kernel as rk
    from crucible_tpu_torch.ops.kernels import sphere_hit as sh
    from crucible_tpu_torch.ops.kernels import sphere_shade as ss
    from tools.torch_replay_ab import deep_buckets

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    card = card_line()
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t_start = time.perf_counter()

    def mark(section):
        """Print the seconds since the card check before a section."""
        print(f"[{time.perf_counter() - t_start:.1f} s] {section}", flush=True)

    # --- build ----------------------------------------------------------------
    libs, build_s, log = build.build()
    print(f"build: {build_s:.2f} s -> "
          + ", ".join(str(p.relative_to(REPO)) for p in libs.values()))
    for line in log.splitlines():
        if line.startswith("---") or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    for stem in libs:
        build.load(stem)
    from crucible_tpu_torch import native

    t0 = time.perf_counter()
    native.load()
    print(f"native BVH builder: {native.library_path().relative_to(REPO)} "
          f"({time.perf_counter() - t0:.2f} s with g++ where it was not built)")
    kernels = {}

    # --- K1: forward megakernel vs eager twin -----------------------------------
    mark('K1: forward megakernel vs eager twin')
    def compare_k1(scene, spp, depth, lanes=None):
        sd = scene.build(device=dev)
        cp = scene.scene_cam.params(device=dev)
        w, h = scene.scene_cam.image_width, scene.scene_cam.image_height
        inputs, lane_of = integrator.mega_inputs(sd, cp, w, h, spp, depth, 0)
        out = mk.run_megakernel(**inputs, animated=False)
        ms = cuda_ms(lambda: mk.run_megakernel(**inputs, animated=False), 3)
        full = inputs
        if lanes is not None:  # eager version on a subset of the lanes
            inputs = dict(inputs, pix=inputs["pix"][:, lanes],
                          sample0=inputs["sample0"][:, lanes])
            out = out[:, lanes]
        ref, plain_ms = host_ms(lambda: mk.run_megakernel_reference(**inputs))
        return out, ref, lane_of, ms, plain_ms, full

    out, ref, _, ms, plain_ms, _ = compare_k1(demo.smoke_scene(width=64), 8, 8)
    err = (out - ref).abs().max().item()
    print(f"K1 smoke 64w 8spp d8: kernel {ms:.3f} ms, eager {plain_ms:.1f} ms, "
          f"max|diff| {err:.3g}")
    if not err <= 1e-4:
        raise AssertionError(f"smoke: kernel and eager version differ by {err}")

    def brute_shape(record, radiance, inputs, what, **flags):
        """The flat loop's launch shape (K1, K2; K8's brute search and K6
        with their flags: grid, resident blocks, registers, spill bytes,
        shared memory), printed; from the wrapper's cached shape, which the
        launches use."""
        nodes = inputs.get("swept_nodes")
        shape = mk.flat_launch_shape(record, radiance, inputs["table"].shape[0],
                                     inputs["pix"].shape[1],
                                     nodes=0 if nodes is None else nodes.shape[0], **flags)
        print(f"  {what} launch: grid {shape['grid']} x {shape['threads']} threads, "
              f"{shape['blocks_per_sm']} resident blocks an SM x {shape['sms']} SMs, "
              f"{shape['registers']} registers a thread, {shape['spill_bytes']} B local "
              f"memory a thread (stack and spill), {shape['smem_bytes']} B shared memory")
        return {k: shape[k] for k in ("grid", "blocks_per_sm", "registers", "spill_bytes",
                                      "smem_bytes")}

    def replay_shape(kind, n, r, what):
        """K4's / K3's (or the legacy pair's) launch shape, printed: grid,
        resident blocks, registers, spill bytes, shared memory and, for
        the backward, where its table-cotangent partial lives."""
        shape = rk.launch_shape(kind, n, r)
        print(f"  {what} launch: grid {shape['grid']} x {shape['threads']} threads, "
              f"{shape['blocks_per_sm']} resident blocks an SM x {shape['sms']} SMs, "
              f"{shape['registers']} registers a thread, {shape['spill_bytes']} spill bytes, "
              f"{shape['smem_bytes']} B shared memory"
              + (f", partial in {'shared' if shape['shared_partial'] else 'global'} memory"
                 if "backward" in kind else ""))
        return {k: shape[k] for k in ("grid", "blocks_per_sm", "registers", "spill_bytes",
                                      "smem_bytes")}

    out, ref, lane_of, ms320, plain320, k1_in = compare_k1(
        demo.book1_end_scene(width=320), 8, 50
    )
    print(f"K1 book1 320w 8spp d50: kernel {ms320:.3f} ms, eager {plain320:.1f} ms")
    brute_shape(False, True, k1_in, "K1 book1 320w")
    err320 = bit_equal(out, ref, "K1 book1 320w 8spp d50 vs plain")
    # The work K1 did: each (pixel, sample) path's closest-hit searches, as
    # the record kernel counts them for the same paths (alive rows).
    sc = demo.book1_end_scene(width=320)
    p320 = 320 * 180
    k1_rec = replay.trace_record_mega(
        sc.build(device=dev), sc.scene_cam.params(device=dev), 320, 180,
        torch.arange(p320, device=dev).repeat(8),
        torch.arange(8, device=dev).repeat_interleave(p320), 0, 50,
    )
    n_active = int((k1_in["table"][:, 5] > 0).sum())
    searches = int((k1_rec & 1).sum())
    del k1_rec
    k1_bound, k1_by = bound(
        searches * n_active * SEARCH_OPS,
        nbytes(*k1_in.values()) + 3 * k1_in["pix"].numel() * 4,
    )
    print(f"  K1 work: {searches} searches x {n_active} rows; bound {k1_bound:.3f} ms "
          f"({k1_by})")
    kernels["megakernel_forward"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1681",
        max_abs_err=err320, ms=ms320, plain_ms=plain320,
        bound_ms=k1_bound, bound_by=k1_by,
    )

    # Full forward launch; eager version on 64 pixel blocks spread over it.
    g = torch.Generator().manual_seed(0)
    n_blocks = (1920 // 32) * math.ceil(1080 / 16)
    blocks = torch.randperm(n_blocks, generator=g)[:64].sort().values
    lanes = (blocks[:, None] * mk.TILE + torch.arange(mk.TILE)).reshape(-1).to(dev)
    out, ref, _, ms_full, plain_sub, k1_full = compare_k1(
        demo.book1_end_scene(width=1920), 32, 50, lanes=lanes
    )
    print(f"K1 book1 1920x1080 32spp d50: kernel {ms_full:.1f} ms "
          f"({1920 * 1080 * 32 / ms_full / 1e3:.2f} Mrays/s); eager on "
          f"{lanes.numel()} lanes {plain_sub:.1f} ms")
    bit_equal(out, ref, f"K1 book1 1080p on {lanes.numel()} lanes vs plain")
    bit_equal(mk.run_megakernel(**k1_full, animated=False)[:, lanes], out,
              "K1 book1 1080p, launch vs launch")
    k1_shape = brute_shape(False, True, k1_full, "K1 book1 1080p")
    del k1_full
    # Its work, counted by the record kernel 4 samples at a time.
    sc = demo.book1_end_scene(width=1920)
    sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    p_full = 1920 * 1080
    searches = 0
    for s0 in range(0, 32, 4):
        rec = replay.trace_record_mega(
            sd, cp, 1920, 1080, torch.arange(p_full, device=dev).repeat(4),
            torch.arange(s0, s0 + 4, device=dev).repeat_interleave(p_full), 0, 50,
        )
        searches += int((rec & 1).sum())
    del rec
    # Bytes: each pixel's id, first sample and sums, and the table.
    b, by = bound(searches * n_active * SEARCH_OPS,
                  (2 + 3) * p_full * 4 + nbytes(k1_in["table"]))
    print(f"  K1 1080p work: {searches} searches x {n_active} rows; bound {b:.3f} ms ({by}); "
          f"K1 at {100 * b / ms_full:.1f}% of it on {card}")
    kernels["megakernel_forward"].update(
        main_ms=ms_full, main_bound_ms=b, grid=k1_shape["grid"],
        blocks_per_sm=k1_shape["blocks_per_sm"], registers=k1_shape["registers"])

    # --- K2, K4, K3 at the comparison shape: book1 320w, 4 spp, depth 8 -------
    mark('K2, K4, K3 at the comparison shape: book1 320w, 4 spp, depth 8')
    def grad_inputs(make, width, spp, depth):
        """Inputs of K2 and of the replay kernels for every pixel of
        ``make(width=width)`` at ``spp`` samples, lanes sample-major as
        ``grad`` lays them out."""
        sc = make(width=width)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        p = w * h
        pix = torch.arange(p, device=dev, dtype=torch.int32).repeat(spp)
        smp = torch.arange(spp, device=dev, dtype=torch.int32).repeat_interleave(p)
        smem = torch.tensor([0, 0, w, depth, 0, 0, 0, 0], dtype=torch.int32, device=dev)
        k2 = dict(smem=smem, pix=pix[None], sample0=smp[None],
                  cam=integrator.mega_cam_vector(cp, w, h),
                  table=integrator.make_sphere_table(sd).contiguous())
        o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
        return k2, (k2["table"], o.contiguous(), d.contiguous(), torch.ones_like(pix),
                    pix, smp)

    def k2_check(k2, depth, what, sub=None):
        acc, rec = mk.run_megakernel_record(**k2, max_depth=depth, radiance=True)
        _, plain = mk.run_megakernel_record(**k2, max_depth=depth)
        bit_equal(rec, plain, f"{what} fused vs plain records")
        if sub is not None:
            k2 = dict(k2, pix=k2["pix"][:, sub], sample0=k2["sample0"][:, sub])
            acc, rec = acc[:, sub], rec[:, sub]
        (ref_acc, ref_rec), plain_ms = host_ms(
            lambda: mk.run_megakernel_record_reference(**k2, max_depth=depth, radiance=True)
        )
        bit_equal(rec, ref_rec, f"{what} records")
        return bit_equal(acc, ref_acc, f"{what} fused radiance"), plain_ms, plain

    k2_check(grad_inputs(demo.smoke_scene, 64, 4, 8)[0], 8, "K2 smoke 64w 4spp d8")

    k2, rin = grad_inputs(demo.book1_end_scene, 320, 4, 8)
    k2_err, k2_plain, rec320 = k2_check(k2, 8, "K2 book1 320w 4spp d8")
    k2_ms = cuda_ms(lambda: mk.run_megakernel_record(**k2, max_depth=8, radiance=True), 3)
    n_active = int((k2["table"][:, 5] > 0).sum())
    searches = int((rec320 & 1).sum())
    k2_bound, k2_by = bound(
        searches * n_active * SEARCH_OPS,
        nbytes(*k2.values()) + nbytes(rec320) + 3 * rec320.shape[1] * 4,
    )
    print(f"K2 book1 320w 4spp d8: kernel {k2_ms:.3f} ms, twin {k2_plain:.1f} ms, "
          f"bound {k2_bound:.4f} ms ({k2_by}, {searches} searches)")
    kernels["megakernel_record"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1828",
        max_abs_err=k2_err, ms=k2_ms, plain_ms=k2_plain,
        bound_ms=k2_bound, bound_by=k2_by,
    )

    def replay_work(rec):
        alive = int((rec & 1).sum())
        cont = int(((rec & 8) > 0).sum())
        return alive, cont

    rargs = (*rin, rec320, 0)
    rad = rk.replay_forward(*rargs)
    ref, k4_plain = host_ms(lambda: rk.replay_forward_reference(*rargs))
    k4_err = bit_equal(rad, ref, "K4 book1 320w 4spp d8 radiance")
    k4_ms = cuda_ms(lambda: rk.replay_forward(*rargs), 3)
    alive, cont = replay_work(rec320)
    k4_in = nbytes(*rin, rec320)
    k4_bound, k4_by = bound(replay_ops(alive, cont), k4_in + nbytes(rad))
    print(f"K4 book1 320w 4spp d8: kernel {k4_ms:.3f} ms, twin {k4_plain:.1f} ms, "
          f"bound {k4_bound:.4f} ms ({k4_by}; {alive} alive rows, {cont} continuing)")
    kernels["replay_forward"] = dict(
        source="crucible_tpu_torch/csrc/replay_kernel.cu",
        replaces="crucible_tpu/ops/pallas/replay_kernel.py:851",
        max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain,
        bound_ms=k4_bound, bound_by=k4_by,
    )

    g_rad = torch.randn(rad.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    got = rk.replay_backward(*rargs, g_rad)
    again = rk.replay_backward(*rargs, g_rad)
    bit_equal(got[0], again[0], "K3 g_table, launch vs launch")
    want, k3_plain = host_ms(lambda: rk.replay_backward_reference(*rargs, g_rad))
    k3_err = k3_scheme(got, want, "K3 book1 320w 4spp d8")
    k3_ms = cuda_ms(lambda: rk.replay_backward(*rargs, g_rad), 3)
    k3_bound, k3_by = bound(
        replay_vjp_ops(alive, cont),
        k4_in + nbytes(g_rad, *got),
    )
    print(f"K3 book1 320w 4spp d8: kernel {k3_ms:.3f} ms, twin {k3_plain:.1f} ms, "
          f"bound {k3_bound:.4f} ms ({k3_by})")
    kernels["replay_backward"] = dict(
        source="crucible_tpu_torch/csrc/replay_kernel.cu",
        replaces="crucible_tpu/ops/pallas/replay_kernel.py:871",
        max_abs_err=k3_err, ms=k3_ms, plain_ms=k3_plain,
        bound_ms=k3_bound, bound_by=k3_by,
    )
    del k2, rin, rargs, rec320, got, again, want, g_rad

    # --- K2, K4, K3 at the gradient step's shape: 1920x1080, 4 spp, depth 8 ---
    mark("K2, K4, K3 at the gradient step's shape: 1920x1080, 4 spp, depth 8")
    k2, rin = grad_inputs(demo.book1_end_scene, 1920, 4, 8)
    r = rin[1].shape[0]
    sub = torch.randperm(r, generator=torch.Generator().manual_seed(1))[:N_SUB]
    sub = sub.sort().values.to(dev)
    k2_check(k2, 8, f"K2 1920x1080 4spp d8 on {N_SUB} lanes", sub=sub)
    rec = mk.run_megakernel_record(**k2, max_depth=8)[1]
    acc2, rec2 = mk.run_megakernel_record(**k2, max_depth=8, radiance=True)
    acc3, rec3 = mk.run_megakernel_record(**k2, max_depth=8, radiance=True)
    bit_equal(rec3, rec2, "K2 1080p records, launch vs launch")
    bit_equal(acc3, acc2, "K2 1080p fused radiance, launch vs launch")
    del acc2, rec2, acc3, rec3
    k2_shape = brute_shape(True, True, k2, "K2 1080p (fused)")
    brute_shape(True, False, k2, "K2 1080p (plain)")
    ms = cuda_ms(lambda: mk.run_megakernel_record(**k2, max_depth=8, radiance=True), 3)
    searches = int((rec & 1).sum())
    b, by = bound(searches * n_active * SEARCH_OPS,
                  nbytes(*k2.values()) + nbytes(rec) + 3 * r * 4)
    print(f"K2 1920x1080 4spp d8 (fused): {ms:.3f} ms, bound {b:.3f} ms ({by}); "
          f"K2 at {100 * b / ms:.1f}% of it on {card}")
    kernels["megakernel_record"].update(
        main_ms=ms, main_bound_ms=b, grid=k2_shape["grid"],
        blocks_per_sm=k2_shape["blocks_per_sm"], registers=k2_shape["registers"])
    rargs = (*rin, rec, 0)
    rad = rk.replay_forward(*rargs)
    sub_args = tuple(x[sub] for x in rin[1:]) + (rec[:, sub], 0)
    bit_equal(rad[sub], rk.replay_forward_reference(rin[0], *sub_args),
              f"K4 1920x1080 on {N_SUB} lanes")
    ms = cuda_ms(lambda: rk.replay_forward(*rargs), 3)
    alive, cont = replay_work(rec)
    k4_in = nbytes(*rin, rec)
    b, by = bound(replay_ops(alive, cont), k4_in + nbytes(rad))
    print(f"K4 1920x1080 4spp d8: {ms:.3f} ms, bound {b:.3f} ms ({by}); "
          f"K4 at {100 * b / ms:.1f}% of it on {card}")
    kernels["replay_forward"].update(
        main_ms=ms, main_bound_ms=b, **replay_shape("forward", rin[0].shape[0], r, "K4 1080p"))
    g_rad = torch.randn(rad.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    got = rk.replay_backward(*rargs, g_rad)
    bit_equal(got[0], rk.replay_backward(*rargs, g_rad)[0], "K3 1080p g_table, twice")
    got_sub = rk.replay_backward(rin[0], *sub_args, g_rad[sub])
    want_sub = rk.replay_backward_reference(rin[0], *sub_args, g_rad[sub])
    k3_scheme(got_sub, want_sub, f"K3 on {N_SUB} lanes of 1080p")
    k3_scheme((got_sub[0], got[1][sub], got[2][sub]), want_sub,
              "K3 1080p launch, lane cotangents")
    ms = cuda_ms(lambda: rk.replay_backward(*rargs, g_rad), 3)
    b, by = bound(replay_vjp_ops(alive, cont),
                  k4_in + nbytes(g_rad, *got))
    print(f"K3 1920x1080 4spp d8: {ms:.3f} ms, bound {b:.3f} ms ({by}); "
          f"{alive} alive rows, {cont} continuing; K3 at {100 * b / ms:.1f}% of it on {card}")
    kernels["replay_backward"].update(
        main_ms=ms, main_bound_ms=b, **replay_shape("backward", rin[0].shape[0], r, "K3 1080p"))
    del k2, rin, rargs, rec, rad, got, g_rad, got_sub, want_sub

    # --- K4, K3 at the depth-50 chunk's three buckets: 1920x1080, 4 spp -------
    mark("K4, K3 at the depth-50 chunk's three buckets: 1920x1080, 4 spp")

    # K4 is held bit for bit with its plain version, whose index_add
    # flushes a denormal radiance sum to 0.0: where this card's index_add
    # does, the kernel's denormal outputs are flushed before the comparison.
    summed, product = index_add_flush(dev)
    flushes = summed == 0.0 and product != 0.0
    print(f"  index_add(0, 1e-40) = {summed:.6g}, 1e-40 * 1 = {product:.6g}: index_add "
          f"{'flushes' if flushes else 'keeps'} denormals")
    k4_plain_equal = bit_equal_ftz if flushes else bit_equal
    sc = demo.book1_end_scene(width=1920)
    pl, sl = grad._lanes(torch.arange(1920 * 1080, device=dev), 4, 0)
    buckets = deep_buckets(sc.build(device=dev), sc.scene_cam.params(device=dev),
                           1920, 1080, pl, sl)
    del pl, sl
    deep_k4, deep_k3 = {}, {}
    for name, args, acc in buckets:
        r = args[1].shape[0]
        kw = dict(accum_from=acc)
        sub = torch.randperm(r, generator=torch.Generator().manual_seed(2))[:N_SUB]
        sub = sub.sort().values.to(dev)
        sub_args = (args[0], *(x[sub] for x in args[1:6]), args[6][:, sub].contiguous())
        rad = rk.replay_forward(*args, 0, **kw)
        k4_plain_equal(rad[sub], rk.replay_forward_reference(*sub_args, 0, **kw),
                       f"K4 deep {name} ({r} lanes) on {sub.numel()} lanes")
        g_rad = torch.randn(rad.shape, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        got = rk.replay_backward(*args, 0, g_rad, **kw)
        bit_equal(got[0], rk.replay_backward(*args, 0, g_rad, **kw)[0],
                  f"K3 deep {name} g_table, launch vs launch")
        want_sub = rk.replay_backward_reference(*sub_args, 0, g_rad[sub], **kw)
        got_sub = rk.replay_backward(*sub_args, 0, g_rad[sub], **kw)
        k3_scheme(got_sub, want_sub, f"K3 deep {name} on {sub.numel()} lanes")
        k3_scheme((got_sub[0], got[1][sub], got[2][sub]), want_sub,
                  f"K3 deep {name} launch, lane cotangents")
        ms4 = cuda_ms(lambda: rk.replay_forward(*args, 0, **kw), 5)
        ms3 = cuda_ms(lambda: rk.replay_backward(*args, 0, g_rad, **kw), 5)
        alive, cont = replay_work(args[6])
        b4, by4 = bound(replay_ops(alive, cont), nbytes(*args) + nbytes(rad))
        b3, by3 = bound(replay_vjp_ops(alive, cont),
                        nbytes(*args) + nbytes(g_rad, *got))
        print(f"deep bucket {name} ({r} lanes, accum_from {acc}, {alive} alive rows, {cont} "
              f"continuing): K4 {ms4:.3f} ms, bound {b4:.4f} ms ({by4}); K3 {ms3:.3f} ms, bound "
              f"{b3:.4f} ms ({by3}) on {card}")
        deep_k4[name] = dict(lanes=r, ms=ms4, bound_ms=b4, bound_by=by4)
        deep_k3[name] = dict(lanes=r, ms=ms3, bound_ms=b3, bound_by=by3,
                             **replay_shape("backward", args[0].shape[0], r, f"K3 deep {name}"))
        del rad, g_rad, got, want_sub, got_sub, args
    del buckets
    kernels["replay_forward"]["deep_buckets"] = deep_k4
    kernels["replay_backward"]["deep_buckets"] = deep_k3

    # --- K4-legacy against its plain version and K4 / K3: 320w and 1080p ------
    mark('K4-legacy against its plain version and K4 / K3: 320w and 1080p, 4 spp, d8')

    def legacy_layout(args):
        """K4's arguments (rays (R, 3), ids (R,)) in K4-legacy's layouts:
        rays (3, R), ids (1, R)."""
        table, o, d, valid, pix_l, smp_l, rec_l, seed = args
        r_l = o.shape[0]
        return (table, o.t().contiguous(), d.t().contiguous(), valid.reshape(1, r_l),
                pix_l.reshape(1, r_l), smp_l.reshape(1, r_l), rec_l, seed)

    legacy = {}
    for width, shape in ((320, "320w"), (1920, "1080p")):
        k2, rin = grad_inputs(demo.book1_end_scene, width, 4, 8)
        rec = mk.run_megakernel_record(**k2, max_depth=8)[1]
        rargs = (*rin, rec, 0)
        largs = legacy_layout(rargs)
        r = rin[1].shape[0]
        sub = None
        if width > 320:  # plain versions on N_SUB lanes, as for K4 / K3
            sub = torch.randperm(r, generator=torch.Generator().manual_seed(1))[:N_SUB]
            sub = sub.sort().values.to(dev)
        rk.zero_counts()
        rad3 = rk.replay_legacy_forward(*largs)
        if rk.LAUNCHES_LEGACY_FORWARD != 1:
            raise AssertionError("K4-legacy forward did not launch")
        bit_equal(rad3, rk.replay_forward(*rargs).t(), f"K4-legacy vs K4 {shape}")
        if sub is None:
            plain, plain_ms = host_ms(lambda: rk.replay_legacy_forward_reference(*largs))
            err_f = bit_equal(rad3, plain, f"K4-legacy {shape} radiance vs plain")
        else:
            sub_l = legacy_layout((rin[0], *(x[sub] for x in rin[1:]), rec[:, sub], 0))
            plain, plain_ms = host_ms(lambda: rk.replay_legacy_forward_reference(*sub_l))
            err_f = bit_equal(rad3[:, sub], plain, f"K4-legacy {shape} on {N_SUB} lanes vs plain")
        ms_l = cuda_ms(lambda: rk.replay_legacy_forward(*largs), 3)
        ms_k4 = cuda_ms(lambda: rk.replay_forward(*rargs), 3)
        alive, cont = replay_work(rec)
        k4_in = nbytes(*rin, rec)
        fb, fby = bound(replay_ops(alive, cont), k4_in + nbytes(rad3))
        g_rad = torch.randn((r, 3), device=dev,
                            generator=torch.Generator(device=dev).manual_seed(0))
        g3 = g_rad.t().contiguous()
        got = rk.replay_legacy_backward(*largs, g3)
        bit_equal(got[0], rk.replay_legacy_backward(*largs, g3)[0],
                  f"K4-legacy backward {shape} g_table, launch vs launch")
        k3 = rk.replay_backward(*rargs, g_rad)
        bit_equal(got[0], k3[0], f"K4-legacy backward {shape} g_table vs K3")
        bit_equal(got[1], k3[1].t(), f"K4-legacy backward {shape} g_o vs K3")
        bit_equal(got[2], k3[2].t(), f"K4-legacy backward {shape} g_d vs K3")
        if sub is None:
            want, bplain_ms = host_ms(lambda: rk.replay_legacy_backward_reference(*largs, g3))
            err_b = k3_scheme((got[0], got[1].t(), got[2].t()),
                              (want[0], want[1].t(), want[2].t()), f"K4-legacy backward {shape}")
        else:
            g3_sub = g_rad[sub].t().contiguous()
            want, bplain_ms = host_ms(
                lambda: rk.replay_legacy_backward_reference(*sub_l, g3_sub))
            got_sub = rk.replay_legacy_backward(*sub_l, g3_sub)
            err_b = k3_scheme((got_sub[0], got_sub[1].t(), got_sub[2].t()),
                              (want[0], want[1].t(), want[2].t()),
                              f"K4-legacy backward on {N_SUB} lanes of {shape}")
        bms_l = cuda_ms(lambda: rk.replay_legacy_backward(*largs, g3), 3)
        bms_k3 = cuda_ms(lambda: rk.replay_backward(*rargs, g_rad), 3)
        bb, bby = bound(replay_vjp_ops(alive, cont),
                        k4_in + nbytes(g_rad, *got))
        print(f"K4-legacy {shape} 4spp d8: forward {ms_l:.3f} ms (K4 {ms_k4:.3f}), plain "
              f"{plain_ms:.1f} ms, bound {fb:.4f} ms ({fby}); backward {bms_l:.3f} ms "
              f"(K3 {bms_k3:.3f}), plain {bplain_ms:.1f} ms, bound {bb:.4f} ms ({bby}); "
              f"{alive} alive rows, {cont} continuing")
        legacy[shape] = dict(fwd=(err_f, ms_l, ms_k4, plain_ms, fb, fby),
                             bwd=(err_b, bms_l, bms_k3, bplain_ms, bb, bby),
                             rows=rin[0].shape[0], lanes=r)
        del k2, rin, rargs, largs, rec, rad3, plain, got, k3, want, g_rad, g3
    for kind, name, line in (("fwd", "replay_legacy_forward", 516),
                             ("bwd", "replay_legacy_backward", 535)):
        err, ms, ms_blk, plain_ms, b, by = legacy["320w"][kind]
        _, ms_main, ms_blk_main, _, b_main, by_main = legacy["1080p"][kind]
        kernels[name] = dict(
            source="crucible_tpu_torch/csrc/replay_kernel.cu",
            replaces=f"crucible_tpu/ops/pallas/replay_kernel.py:{line}",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b, bound_by=by,
            blocked_ms=ms_blk, ms_1080p=ms_main, blocked_ms_1080p=ms_blk_main,
            bound_ms_1080p=b_main, launches=0,
            **replay_shape(f"legacy_{name.split('_')[-1]}", legacy["1080p"]["rows"],
                           legacy["1080p"]["lanes"], f"K4-legacy {name.split('_')[-1]} 1080p"),
        )

    # --- the gradient step on the card vs on the CPU (twins), small -----------
    mark('the gradient step on the card vs on the CPU (twins), small')
    sc = demo.book1_end_scene(width=64)
    kw = dict(width=64, height=36, spp=2, max_depth=8)
    results = []
    for where in (dev, torch.device("cpu")):
        sd, cp = sc.build(device=where), sc.scene_cam.params(device=where)
        results.append(grad.loss_and_grad(
            grad.extract_params(sd, cp), sd, cp, torch.zeros((64 * 36, 3), device=where),
            torch.arange(64 * 36, device=where), 0, **kw,
        ))
    (lc, gc), (lp, gp) = results
    rel = abs(lc.item() - lp.item()) / lp.item()
    print(f"loss_and_grad book1 64w 2spp d8, card vs CPU: loss {lc.item():.6f} vs "
          f"{lp.item():.6f} (rel {rel:.2g})")
    if not rel <= 1e-4:
        raise AssertionError("the gradient step on the card and on the CPU disagree")
    for key in grad.TENSOR_KEYS:
        a, b = gc[key].cpu(), gp[key]
        nd = ((a - b).abs().max() / max(b.abs().max().item(), 1e-6)).item()
        print(f"  {key}: max normalized diff {nd:.3g}")
        if not nd <= 1e-3:
            raise AssertionError(f"{key}: card and CPU gradients disagree")

    # --- K10: closest sphere hit vs its plain version ---------------------------
    mark('K10: closest sphere hit vs its plain version')
    def k10_args(sd, o, d):
        c = sd.sph_center
        r = sd.sph_radius
        csr = c[:, 0] * c[:, 0] + c[:, 1] * c[:, 1] + c[:, 2] * c[:, 2] - r * r
        return (o.contiguous(), d.contiguous(), c.contiguous(), csr.contiguous(),
                sd.sph_active.float().contiguous())

    def k10_check(args, what):
        out = sh.hit_spheres(*args)
        ref, plain_ms = host_ms(lambda: sh.hit_spheres_reference(*args))
        err = max(bit_equal(a, b, f"{what} {name}")
                  for name, a, b in zip(("t", "idx", "hit"), out, ref))
        print(f"  {what}: {out[2].float().mean().item():.3f} of the rays hit")
        return plain_ms, err

    def random_rays(n, seed):
        """n rays from above book1's ground toward random points on it."""
        gen = torch.Generator(device=dev).manual_seed(seed)
        u = torch.rand((n, 6), device=dev, generator=gen)
        o = torch.stack([30 * u[:, 0] - 15, 0.5 + 4.5 * u[:, 1], 30 * u[:, 2] - 15], 1)
        target = torch.stack([22 * u[:, 3] - 11, 1.2 * u[:, 4], 22 * u[:, 5] - 11], 1)
        return o, target - o

    sc = demo.book1_end_scene(width=320)
    b1_sd, b1_cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    b1_table = integrator.make_sphere_table(b1_sd).contiguous()
    o, d = random_rays(1 << 20, 2)
    args = k10_args(b1_sd, o, d)
    plain_ms, _ = k10_check(args, "K10 2^20 random rays x book1")
    ms = cuda_ms(lambda: sh.hit_spheres(*args), 5)
    print(f"K10 2^20 rays x {b1_table.shape[0]} rows: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms")
    p320 = 320 * 180
    pix = torch.arange(p320, device=dev).repeat(4)
    smp = torch.arange(4, device=dev).repeat_interleave(p320)
    o, d, _ = generate_rays(b1_cp, 320, 180, pix, smp, 0)
    k10_check(k10_args(b1_sd, o, d), "K10 book1 320w 4spp primary rays")
    # The direct-AD step's launches: its first bounce, on the 1920x1080 4 spp
    # primary rays (the main shape, timed), and its second, on rays that
    # start on sphere surfaces (some inside a dielectric sphere).
    sc = demo.book1_end_scene(width=1920)
    b1080_sd, b1080_cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    p_full = 1920 * 1080
    pix = torch.arange(p_full, device=dev).repeat(4)
    smp = torch.arange(4, device=dev).repeat_interleave(p_full)
    o, d, _ = generate_rays(b1080_cp, 1920, 1080, pix, smp, 0)
    args = k10_args(b1080_sd, o, d)
    k10_plain, k10_err = k10_check(args, "K10 1920x1080 4spp primary rays")
    k10_ms = cuda_ms(lambda: sh.hit_spheres(*args), 3)
    k10_bound, k10_by = bound(
        search_ops(o, d, torch.zeros(o.shape[0], device=dev), b1_table, HIT_DISC_OPS),
        nbytes(*args) + 9 * o.shape[0],
    )
    k10_shape = sh.launch_shape(b1_table.shape[0], o.shape[0])
    print(f"K10 1920x1080 4spp primary rays ({o.shape[0]} x {b1_table.shape[0]} rows): "
          f"kernel {k10_ms:.3f} ms, plain {k10_plain:.1f} ms, bound {k10_bound:.4f} ms "
          f"({k10_by})")
    print(f"K10 launch shape: {json.dumps(k10_shape)}")
    kernels["sphere_hit"] = dict(
        source="crucible_tpu_torch/csrc/sphere_hit.cu",
        replaces="crucible_tpu/ops/pallas/sphere_hit.py:103",
        max_abs_err=k10_err, ms=k10_ms, plain_ms=k10_plain,
        bound_ms=k10_bound, bound_by=k10_by, shape=k10_shape,
    )
    r = o.shape[0]
    with torch.no_grad():
        o, d, *_ = integrator._trace_bounce(
            b1080_sd, pix, smp, 0, 0, o, d, torch.ones((r, 3), device=dev),
            torch.zeros((r, 3), device=dev), torch.ones((r,), dtype=torch.bool, device=dev),
        )
    args = k10_args(b1080_sd, o, d)
    k10_check(args, "K10 1920x1080 4spp second-bounce rays")
    ms = cuda_ms(lambda: sh.hit_spheres(*args), 3)
    print(f"K10 1920x1080 4spp second-bounce rays: kernel {ms:.3f} ms")
    kernels["sphere_hit"]["second_bounce_ms"] = ms
    del o, d, args, pix, smp
    # A table past the rows a block stages at a time: the kernel's chunks.
    stress_sd = demo.sphere_stress(width=320, copies=16).build(device=dev)
    o, d = random_rays(1 << 20, 5)
    args = k10_args(stress_sd, o, d)
    n_rows = stress_sd.sph_center.shape[0]
    if n_rows <= sh.STAGE_ROWS:
        raise AssertionError(f"n7744's {n_rows} rows do not pass the staged {sh.STAGE_ROWS}")
    plain_ms, _ = k10_check(args, f"K10 2^20 random rays x sphere_stress n7744 ({n_rows} rows, "
                            f"{sh.launch_shape(n_rows, o.shape[0])['chunks']} chunks)")
    ms = cuda_ms(lambda: sh.hit_spheres(*args), 3)
    print(f"K10 2^20 rays x {n_rows} rows: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms")
    kernels["sphere_hit"]["past_capacity_ms"] = ms
    del o, d, args

    # --- K9: fused hit + fetch vs its plain version -----------------------------
    mark('K9: fused hit + fetch vs its plain version')
    def k9_check(o, d, w, table, what):
        args = (o.contiguous(), d.contiguous(), w.contiguous(), table.contiguous())
        out = ss.hit_spheres_fetch(*args)
        ref, plain_ms = host_ms(lambda: ss.hit_spheres_fetch_reference(*args))
        err = bit_equal(out, ref, f"{what}, all {ss.C_OUT} rows")
        if not torch.equal(out.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"{what}: kernel and plain version differ in a bit")
        print(f"  {what}: {(out[0] < ss.BIG).float().mean().item():.3f} of the rays hit")
        return args, err, plain_ms

    def k9_time(args, disc_ops, what, reps=5):
        """K9's CUDA-event time on ``args`` beside its bound and launch shape."""
        ms = cuda_ms(lambda: ss.hit_spheres_fetch(*args), reps)
        r = args[0].shape[0]
        lim, by = bound(search_ops(*args, disc_ops), nbytes(*args) + ss.C_OUT * 4 * r)
        shape = ss.launch_shape(args[3].shape[0], r)
        print(f"K9 {what} ({r} rays x {args[3].shape[0]} rows): kernel {ms:.4f} ms, bound "
              f"{lim:.4f} ms ({by}); launch: {json.dumps(shape)}")
        return ms, lim, by, shape

    o, d = random_rays(1 << 20, 3)
    k9_check(o, d, torch.zeros(o.shape[0], device=dev), b1_table, "K9 2^20 random rays x book1")
    gen = torch.Generator(device=dev).manual_seed(4)
    moving = b1_table.clone()
    cd = 0.6 * torch.rand((moving.shape[0], 3), device=dev, generator=gen) - 0.3
    rd = 0.1 * torch.rand((moving.shape[0],), device=dev, generator=gen) - 0.05
    moving[:, 24:27], moving[:, 27] = cd, rd
    moving[:, 28] = (moving[:, 0:3] * cd).sum(1) - moving[:, 3] * rd
    moving[:, 29] = (cd * cd).sum(1) - rd * rd
    w = torch.rand((o.shape[0],), device=dev, generator=gen)
    k9_in, _, _ = k9_check(o, d, w, moving, "K9 2^20 random rays x book1 with motion, random w")
    moving_ms, *_ = k9_time(k9_in, SHADE_DISC_OPS, "2^20 random rays x book1 with motion")
    # Past the rows a block stages at a time: n7744's four chunks.
    stress_table = integrator.make_sphere_table(stress_sd).contiguous()
    o, d = random_rays(1 << 20, 5)
    k9_in, _, _ = k9_check(o, d, torch.zeros(o.shape[0], device=dev), stress_table,
                           f"K9 2^20 random rays x sphere_stress n7744 "
                           f"({ss.launch_shape(stress_table.shape[0], o.shape[0])['chunks']} "
                           f"chunks)")
    stress_ms, *_ = k9_time(k9_in, HIT_DISC_OPS, "2^20 random rays x n7744", reps=3)
    del stress_sd, stress_table
    # The pixel schedule's launches under a keyed camera (main path 26b: 746
    # of them at 1920x1080 32 spp d50): book1's 1920x1080 primary rays of
    # one sample against its 488 static rows; timed as the kernel's main
    # shape.
    pix = torch.arange(p_full, device=dev)
    o, d, _ = generate_rays(b1080_cp, 1920, 1080, pix, torch.zeros_like(pix), 0)
    k9_in, main_err, main_plain = k9_check(o, d, torch.zeros(p_full, device=dev), b1_table,
                                           "K9 book1 1920x1080 primary rays")
    main_ms, main_bound, main_by, main_shape = k9_time(k9_in, HIT_DISC_OPS,
                                                       "book1 1920x1080 primary rays", reps=10)
    sc = demo.garden_skybox(width=1920)
    g_sd, g_cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
    g_table = integrator.make_sphere_table(g_sd).contiguous()
    o, d, _ = generate_rays(g_cp, 1920, 1080, pix, torch.zeros_like(pix), 0)
    k9_in, k9_err, k9_plain = k9_check(o, d, torch.zeros(p_full, device=dev), g_table,
                                       "K9 garden 1920x1080 primary rays")
    k9_ms, k9_bound, k9_by, g_shape = k9_time(k9_in, HIT_DISC_OPS, "garden 1920x1080 primary rays",
                                              reps=10)
    print(f"K9 garden 1920x1080: plain {k9_plain:.2f} ms; book1 1920x1080: plain "
          f"{main_plain:.2f} ms")
    kernels["sphere_shade"] = dict(
        source="crucible_tpu_torch/csrc/sphere_shade.cu",
        replaces="crucible_tpu/ops/pallas/sphere_shade.py:136",
        max_abs_err=max(k9_err, main_err), ms=k9_ms, plain_ms=k9_plain,
        bound_ms=k9_bound, bound_by=k9_by, main_ms=main_ms, main_bound_ms=main_bound,
        main_bound_by=main_by, main_plain_ms=main_plain, moving_ms=moving_ms,
        past_capacity_ms=stress_ms, shape=main_shape, garden_shape=g_shape,
    )
    del o, d, w, moving, k9_in, pix

    # --- the pixel schedule: card vs CPU, and vs the mega schedule ------------
    mark('the pixel schedule: card vs CPU, and vs the mega schedule')
    sc = demo.garden_skybox(width=64)
    card_img = render.render_image(sc, samples=4, max_depth=8)
    cpu_img = render.render_image(sc, samples=4, max_depth=8, device="cpu")
    statistical_match(card_img.cpu(), cpu_img, "pixel schedule garden 64w 4spp d8, card vs CPU")
    imgs = {}
    for schedule in ("pixel", "mega"):
        imgs[schedule], ms = host_ms(lambda: render.render_image_persistent(
            b1_sd, b1_cp, 320, 180, 8, 50, 0, schedule=schedule))
        print(f"  book1 320w 8spp d50, {schedule} schedule: {ms:.1f} ms")
    a, b = imgs["pixel"], imgs["mega"]
    close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item()
    dmean = abs(a.mean().item() - b.mean().item())
    print(f"  pixel vs mega: isclose {close:.5f}, |mean diff| {dmean:.3g}")
    if not (close > 0.97 and dmean <= 2e-3):
        raise AssertionError("the pixel and mega schedules disagree on book1")
    del imgs, a, b, card_img, cpu_img

    # --- K5: the static tree walk vs its plain version and vs K1 / K2 ---------
    mark('K5: the static tree walk vs its plain version and vs K1 / K2')
    def stress_inputs(copies, width):
        """sphere_stress at ``width``: (scene, camera, w, h, K5's tree as the
        wrappers take it, with its permutation)."""
        sc = demo.sphere_stress(width=width, copies=copies)
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        tree = dict(swept_nodes=sd.sph_swept_nodes, swept_meta=sd.sph_swept_meta)
        return sd, cp, sc.scene_cam.image_width, sc.scene_cam.image_height, tree

    def lane_subset(inputs, lanes):
        return dict(inputs, pix=inputs["pix"][:, lanes], sample0=inputs["sample0"][:, lanes])

    def walk_ops(counts):
        return (counts["nodes"] * SLAB_OPS + counts["rows"] * HIT_DISC_OPS
                + counts["roots"] * ROOT_OPS)

    def plain_walk(fn):
        """(result, ms, the walk's counted work) of one plain-walk call."""
        mk.SEARCH_COUNTS.update(searches=0, issued=0)
        mk.WALK_COUNTS.update(nodes=0, rows=0, roots=0)
        out, ms = host_ms(fn)
        return out, ms, dict(mk.SEARCH_COUNTS, **mk.WALK_COUNTS)

    def per_search(counts):
        """Nodes and rows the plain walk tested a search."""
        s = max(counts["searches"], 1)
        return dict(nodes_per_search=counts["nodes"] / s, rows_per_search=counts["rows"] / s)

    def tree_shape(record, inputs, what, **flags):
        """A tree walk's launch shape (K5, K6) for ``inputs``, printed."""
        shape = mk.flat_launch_shape(record, True, inputs["table"].shape[0],
                                     inputs["pix"].shape[1],
                                     nodes=int(inputs["swept_nodes"].shape[0]), **flags)
        print(f"  {what} launch shape: {shape}")
        return shape

    def k5_forward(copies, width, spp, depth, lanes=None):
        """K5's forward launch on sphere_stress against the plain walk and
        against K1 on the original table (on ``lanes`` of it if given)."""
        sd, cp, w, h, tree = stress_inputs(copies, width)
        brute, _ = integrator.mega_inputs(sd, cp, w, h, spp, depth, 0)
        walk = dict(brute, table=integrator.permute_table(brute["table"], sd.sph_swept_perm),
                    **tree)
        out = mk.run_megakernel(**walk, animated=False)
        ms = cuda_ms(lambda: mk.run_megakernel(**walk, animated=False), 2)
        what = f"K5 n{sd.sph_center.shape[0]} {width}w {spp}spp d{depth}"
        shape = tree_shape(False, walk, what)
        valid_all = int((walk["sample0"] < mk.NO_SAMPLE).sum())
        r_all = walk["pix"].shape[1]
        if lanes is not None:
            brute, walk = lane_subset(brute, lanes), lane_subset(walk, lanes)
            out = out[:, lanes]
            what += f" on {lanes.numel()} lanes"
        ref, plain_ms, counts = plain_walk(
            lambda: mk.run_megakernel_reference(**walk, by_sample=True))
        err = bit_equal(out, ref, f"{what} vs plain walk")
        bit_equal(out, mk.run_megakernel(**brute, animated=False), f"{what} vs K1")
        k1_ms = cuda_ms(lambda: mk.run_megakernel(**brute, animated=False), 1)
        k5_ms = cuda_ms(lambda: mk.run_megakernel(**walk, animated=False), 1)
        # Scale the checked lanes' work to the whole launch; bytes: the
        # permuted table, the tree, each lane's ids and sums.
        scale = valid_all / int((walk["sample0"] < mk.NO_SAMPLE).sum())
        b, by = bound(walk_ops(counts) * scale,
                      nbytes(walk["table"], *tree.values()) + 5 * 4 * r_all)
        print(f"{what}: K5 {ms:.3f} ms, plain walk {plain_ms:.1f} ms, bound {b:.4f} ms ({by}); "
              f"on the checked lanes K5 {k5_ms:.3f} ms vs K1 {k1_ms:.3f} ms "
              f"({k1_ms / k5_ms:.2f}x); work {counts}, x{scale:.2f}; {per_search(counts)}")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                    k1_ms=k1_ms, k5_ms=k5_ms, speedup=k1_ms / k5_ms, launch_shape=shape,
                    **per_search(counts))

    k5_fwd = {}
    for copies in (16, 4):
        k5_fwd[copies] = k5_forward(copies, 320, 8, 50)
    n_blocks = (1920 // 32) * math.ceil(1080 / 16)
    blocks = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(5))[:64]
    lanes = (blocks.sort().values[:, None] * mk.TILE + torch.arange(mk.TILE)).reshape(-1).to(dev)
    k5_main = k5_forward(16, 1920, 32, 50, lanes=lanes)
    print(f"  K5 n7744 1920x1080 32spp d50: {k5_main['ms']:.1f} ms "
          f"({1920 * 1080 * 32 / k5_main['ms'] / 1e3:.2f} Mrays/s)")

    # The leaf size: K5 over trees of 8, 4, 16 and 8 spheres a leaf, at
    # n7744 320w and on the 1920x1080 launch, in turns.
    k5_leaf_ms, scenes = {}, {width: stress_inputs(16, width) for width in (320, 1920)}
    for leaf in (8, 4, 16, 8):
        for width, spp in ((320, 8), (1920, 32)):
            sd, cp, w, h, _ = scenes[width]
            arrays = (t.cpu().numpy() for t in (sd.sph_center, sd.sph_radius, sd.sph_active))
            perm, nodes, meta = (torch.from_numpy(t).to(dev)
                                 for t in mk.swept_tables(*arrays, leaf_size=leaf))
            x, _ = integrator.mega_inputs(sd, cp, w, h, spp, 50, 0)
            x = dict(x, table=integrator.permute_table(x["table"], perm), swept_nodes=nodes,
                     swept_meta=meta)
            ms = cuda_ms(lambda: mk.run_megakernel(**x, animated=False), 1 if width == 1920 else 3)
            k5_leaf_ms.setdefault(f"leaf{leaf}_{width}w", []).append(ms)
            print(f"  K5 n7744 {width}w {spp}spp d50 at leaf {leaf} ({nodes.shape[0]} nodes): "
                  f"{ms:.3f} ms")
            del x
    del scenes
    kernels["megakernel_walk"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1681",
        **{k: k5_fwd[16][k] for k in ("ms", "plain_ms", "max_abs_err", "bound_ms", "bound_by")},
        ms_n1936=k5_fwd[4]["ms"], bound_ms_n1936=k5_fwd[4]["bound_ms"],
        plain_ms_n1936=k5_fwd[4]["plain_ms"], launch_shape=k5_fwd[16]["launch_shape"],
        main_ms=k5_main["ms"], main_bound_ms=k5_main["bound_ms"],
        main_plain_ms_checked_lanes=k5_main["plain_ms"],
        main_checked_lanes_ms=k5_main["k5_ms"], main_checked_lanes_k1_ms=k5_main["k1_ms"],
        main_checked_lanes_speedup=k5_main["speedup"], main_launch_shape=k5_main["launch_shape"],
        main_nodes_per_search=k5_main["nodes_per_search"],
        main_rows_per_search=k5_main["rows_per_search"], leaf_ms=k5_leaf_ms,
    )

    def k5_record(copies, width, spp, depth, sub=None):
        """K5's record launches (fused and plain) on sphere_stress(copies)
        against the plain walk and K2 on the original table (on ``sub`` of
        the lanes if given) -> (entry, replay-kernel inputs, records)."""
        sd, cp, w, h, tree = stress_inputs(copies, width)
        p = w * h
        pix = torch.arange(p, device=dev, dtype=torch.int32).repeat(spp)
        smp = torch.arange(spp, device=dev, dtype=torch.int32).repeat_interleave(p)
        smem = torch.tensor([0, 0, w, depth, 0, 0, 0, 0], dtype=torch.int32, device=dev)
        brute = dict(smem=smem, pix=pix[None], sample0=smp[None],
                     cam=integrator.mega_cam_vector(cp, w, h),
                     table=integrator.make_sphere_table(sd).contiguous())
        walk = dict(brute, table=integrator.permute_table(brute["table"], sd.sph_swept_perm),
                    **tree)
        what = f"K5 record n{sd.sph_center.shape[0]} {width}w {spp}spp d{depth}"
        acc, rec = mk.run_megakernel_record(**walk, max_depth=depth, radiance=True)
        plain = mk.run_megakernel_record(**walk, max_depth=depth)[1]
        bit_equal(rec, plain, f"{what}: fused vs plain records")
        ms = cuda_ms(lambda: mk.run_megakernel_record(**walk, max_depth=depth,
                                                      radiance=True), 3)
        shape = tree_shape(True, walk, what)
        o, d, _ = generate_rays(cp, w, h, pix, smp, 0)
        rin = (brute["table"], o.contiguous(), d.contiguous(), torch.ones_like(pix), pix, smp)
        full_rec, r = rec, pix.numel()
        if sub is not None:
            brute, walk = lane_subset(brute, sub), lane_subset(walk, sub)
            acc, rec = acc[:, sub], rec[:, sub]
            what += f" on {sub.numel()} lanes"
        (ref_acc, ref_rec), plain_ms, counts = plain_walk(
            lambda: mk.run_megakernel_record_reference(**walk, max_depth=depth,
                                                       radiance=True))
        bit_equal(rec, ref_rec, f"{what}: records vs plain walk")
        err = bit_equal(acc, ref_acc, f"{what}: fused radiance vs plain walk")
        b_acc, b_rec = mk.run_megakernel_record(**brute, max_depth=depth, radiance=True)
        bit_equal(rec, b_rec, f"{what}: records vs K2")
        bit_equal(acc, b_acc, f"{what}: fused radiance vs K2")
        scale = r / rec.shape[1]
        b, by = bound(walk_ops(counts) * scale,
                      nbytes(walk["table"], *tree.values(), full_rec) + 5 * 4 * r)
        print(f"{what}: K5 {ms:.3f} ms, plain walk {plain_ms:.1f} ms, bound {b:.4f} ms "
              f"({by}); work {counts}, x{scale:.2f}; {per_search(counts)}")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                    launch_shape=shape), rin, full_rec

    k5_rec, rin, rec320 = k5_record(4, 320, 4, 8)
    r = 1920 * 1080 * 4
    sub = torch.randperm(r, generator=torch.Generator().manual_seed(6))[:N_SUB].sort().values
    k5_rec_main, _, _ = k5_record(4, 1920, 4, 8, sub=sub.to(dev))
    # n7744 (copies=16), whose 1080p 4 spp d8 record pass the gradient step
    # of main path 9 launches: in full at 320w and on the same 32768 lanes.
    k5_rec16, _, _ = k5_record(16, 320, 4, 8)
    k5_rec16_main, _, _ = k5_record(16, 1920, 4, 8, sub=sub.to(dev))
    kernels["megakernel_walk_record"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1828",
        **k5_rec, main_ms=k5_rec_main["ms"], main_bound_ms=k5_rec_main["bound_ms"],
        ms_n7744=k5_rec16["ms"], plain_ms_n7744=k5_rec16["plain_ms"],
        bound_ms_n7744=k5_rec16["bound_ms"], main_ms_n7744=k5_rec16_main["ms"],
        main_bound_ms_n7744=k5_rec16_main["bound_ms"],
        main_launch_shape_n7744=k5_rec16_main["launch_shape"],
    )

    # --- K4 and K3 at n1936's 1936 rows -----------------------------------------
    mark("K4 and K3 at n1936's 1936 rows")
    rargs = (*rin, rec320, 0)
    rad = rk.replay_forward(*rargs)
    bit_equal(rad, rk.replay_forward_reference(*rargs), "K4 n1936 320w 4spp d8 radiance")
    g_rad = torch.randn(rad.shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    got = rk.replay_backward(*rargs, g_rad)
    bit_equal(got[0], rk.replay_backward(*rargs, g_rad)[0], "K3 n1936 g_table, launch vs launch")
    want, plain_ms = host_ms(lambda: rk.replay_backward_reference(*rargs, g_rad))
    err = k3_scheme(got, want, "K3 n1936 320w 4spp d8")
    ms = cuda_ms(lambda: rk.replay_backward(*rargs, g_rad), 3)
    alive, cont = replay_work(rec320)
    b, by = bound(replay_vjp_ops(alive, cont),
                  nbytes(*rin, rec320, g_rad, *got))
    print(f"K3 n1936 ({rin[0].shape[0]} rows) 320w 4spp d8: kernel {ms:.3f} ms, twin "
          f"{plain_ms:.1f} ms, bound {b:.4f} ms ({by})")
    kernels["replay_backward"].update(
        ms_1936_rows=ms, plain_ms_1936_rows=plain_ms, bound_ms_1936_rows=b,
        max_abs_err_1936_rows=err,
        shape_1936_rows=replay_shape("backward", rin[0].shape[0], rin[1].shape[0], "K3 n1936"))
    del rin, rargs, rec320, rad, got, want, g_rad

    # --- K8: the motion variants vs their plain versions ------------------------
    mark('K8: the motion variants vs their plain versions')
    def k8_inputs(sc, spp, depth):
        sd, cp = sc.build(device=dev), sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        return sd, cp, integrator.mega_inputs(sd, cp, w, h, spp, depth, 0)[0]

    def plain_forward(fn):
        """(result, ms, the plain forward's counted searches) of one call."""
        mk.SEARCH_COUNTS.update(searches=0, issued=0)
        mk.WALK_COUNTS.update(nodes=0, rows=0, roots=0)
        out, ms = host_ms(fn)
        return out, ms, dict(mk.SEARCH_COUNTS, **mk.WALK_COUNTS)

    def k8_ops(counts, n_rows, animated, cam_animated):
        row_ops = MOTION_SEARCH_OPS if animated else SEARCH_OPS
        return counts["searches"] * n_rows * row_ops + cam_animated * counts["issued"] * CAM_OPS

    flag_sets = {"animated": dict(animated=True, cam_animated=False),
                 "camera": dict(animated=False, cam_animated=True),
                 "both": dict(animated=True, cam_animated=True)}
    b_sd, b_cp, b_in = k8_inputs(bouncing_book1(demo, 320), 8, 50)
    if not (b_sd.animated and b_cp.animated) or b_sd.motion_exact or b_cp.motion_exact:
        raise AssertionError("bouncing book1 should move linearly in frame 0")
    n_active = int((b_in["table"][:, 5] > 0).sum())
    k8 = {}
    for tag, flags in flag_sets.items():
        out = mk.run_megakernel(**b_in, **flags)
        ms = cuda_ms(lambda: mk.run_megakernel(**b_in, **flags), 3)
        ref, plain_ms, counts = plain_forward(
            lambda: mk.run_megakernel_reference(**b_in, **flags, by_sample=True))
        err = bit_equal(out, ref, f"K8 {tag} bouncing book1 320w 8spp d50 vs plain")
        b, by = bound(k8_ops(counts, n_active, **flags),
                      nbytes(*b_in.values()) + 3 * b_in["pix"].numel() * 4)
        print(f"K8 {tag} bouncing book1 320w 8spp d50: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms, bound {b:.4f} ms ({by}; {counts['searches']} searches "
              f"x {n_active} rows, {counts['issued']} samples)")
        k8[tag] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                       launch_shape=brute_shape(False, True, b_in, f"K8 {tag} 320w", **flags))

    # What motion costs: K8 (both variants) beside K1 on the same lanes.
    _, _, s_in = k8_inputs(demo.book1_end_scene(width=320), 8, 50)
    both = flag_sets["both"]
    for what, x in (("static book1", s_in), ("bouncing book1", b_in)):
        k1_ms = cuda_ms(lambda: mk.run_megakernel(**x, animated=False), 3)
        k8_ms = cuda_ms(lambda: mk.run_megakernel(**x, **both), 3)
        a, b = mk.run_megakernel(**x, animated=False), mk.run_megakernel(**x, **both)
        close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item()
        print(f"K8 beside K1 on {what} 320w 8spp d50 (same lanes): K1 {k1_ms:.3f} ms, "
              f"K8 {k8_ms:.3f} ms, ratio {k8_ms / k1_ms:.3f}; lane sums isclose {close:.5f}")
        k8[f"k1_ms_{what.split()[0]}"], k8[f"k8_ms_{what.split()[0]}"] = k1_ms, k8_ms

    # The walk with a moving camera (K5's walk in K8's camera variant).
    sc = demo.sphere_stress(width=320, copies=4)
    sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    w_sd, _, w_in = k8_inputs(sc, 8, 50)
    bvh = dict(swept_nodes=w_sd.sph_swept_nodes, swept_meta=w_sd.sph_swept_meta)
    walk = dict(w_in, table=integrator.permute_table(w_in["table"], w_sd.sph_swept_perm), **bvh)
    cam_only = flag_sets["camera"]
    out = mk.run_megakernel(**walk, **cam_only)
    ms = cuda_ms(lambda: mk.run_megakernel(**walk, **cam_only), 3)
    ref, plain_ms, counts = plain_forward(
        lambda: mk.run_megakernel_reference(**walk, cam_animated=True, by_sample=True))
    what = f"K8 walk camera n{w_sd.sph_center.shape[0]} 320w 8spp d50"
    err = bit_equal(out, ref, f"{what} vs plain walk")
    bit_equal(out, mk.run_megakernel(**w_in, **cam_only), f"{what} vs K8 brute camera")
    b, by = bound(walk_ops(counts) + counts["issued"] * CAM_OPS,
                  nbytes(walk["table"], *bvh.values()) + 5 * 4 * w_in["pix"].numel())
    print(f"{what}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.4f} ms ({by}); "
          f"work {counts}")
    k8["walk"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                      launch_shape=tree_shape(False, walk, what, **cam_only))

    # The main path's launch: bouncing book1 1920x1080 32 spp d50, plain on
    # 64 pixel blocks (lanes are independent); K1 on the same launch.
    _, _, m_in = k8_inputs(bouncing_book1(demo, 1920), 32, 50)
    out = mk.run_megakernel(**m_in, **both)
    main_shape = brute_shape(False, True, m_in, "K8 both 1080p", **both)
    main_ms = cuda_ms(lambda: mk.run_megakernel(**m_in, **both), 2)
    main_k1_ms = cuda_ms(lambda: mk.run_megakernel(**m_in, animated=False), 2)
    blocks = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(7))[:64]
    lanes = (blocks.sort().values[:, None] * mk.TILE + torch.arange(mk.TILE)).reshape(-1).to(dev)
    sub = lane_subset(m_in, lanes)
    ref, plain_sub, counts = plain_forward(
        lambda: mk.run_megakernel_reference(**sub, **both, by_sample=True))
    bit_equal(out[:, lanes], ref, f"K8 both bouncing book1 1920x1080 32spp d50 on "
                                  f"{lanes.numel()} lanes vs plain")
    scale = int((m_in["sample0"] < mk.NO_SAMPLE).sum()) / int((sub["sample0"] < mk.NO_SAMPLE).sum())
    main_b, main_by = bound(k8_ops(counts, n_active, **both) * scale,
                            nbytes(*m_in.values()) + 3 * m_in["pix"].numel() * 4)
    print(f"K8 both bouncing book1 1920x1080 32spp d50: {main_ms:.1f} ms "
          f"({1920 * 1080 * 32 / main_ms / 1e3:.2f} Mrays/s), K1 on the same launch "
          f"{main_k1_ms:.1f} ms (ratio {main_ms / main_k1_ms:.3f}); plain on "
          f"{lanes.numel()} lanes {plain_sub:.1f} ms; bound {main_b:.3f} ms ({main_by}; "
          f"work on the checked lanes {counts}, x{scale:.2f})")
    del m_in, sub, out, ref
    kernels["megakernel_motion"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1681",
        **k8["both"],
        ms_animated=k8["animated"]["ms"], bound_ms_animated=k8["animated"]["bound_ms"],
        ms_camera=k8["camera"]["ms"], bound_ms_camera=k8["camera"]["bound_ms"],
        ms_walk_camera=k8["walk"]["ms"], plain_ms_walk_camera=k8["walk"]["plain_ms"],
        bound_ms_walk_camera=k8["walk"]["bound_ms"],
        launch_shape_walk_camera=k8["walk"]["launch_shape"],
        main_ms=main_ms, main_bound_ms=main_b, main_k1_ms=main_k1_ms,
        main_launch_shape=main_shape,
        **{key: v for key, v in k8.items() if key.startswith(("k1_ms", "k8_ms"))},
    )

    # The pixel schedule (K9 with each path's w) against the mega schedule.
    imgs = {}
    for schedule in ("pixel", "mega"):
        imgs[schedule], ms = host_ms(lambda: render.render_image_persistent(
            b_sd, b_cp, 320, 180, 8, 50, 0, schedule=schedule))
        print(f"  bouncing book1 320w 8spp d50, {schedule} schedule: {ms:.1f} ms")
    a, b = imgs["pixel"], imgs["mega"]
    close = torch.isclose(a, b, rtol=1e-3, atol=1e-3).float().mean().item()
    dmean = abs(a.mean().item() - b.mean().item())
    print(f"  bouncing book1 pixel vs mega: isclose {close:.5f}, |mean diff| {dmean:.3g}")
    if not (close > 0.97 and dmean <= 2e-3):
        raise AssertionError("the pixel and mega schedules disagree on bouncing book1")
    del imgs, a, b, b_in, s_in, w_in, walk

    # --- K8 record: the motion variants in record mode vs their plain version -
    mark('K8 record: the motion variants in record mode vs their plain version')
    def k8_record_check(k2, depth, flags, what, sub=None, bvh=None):
        """K8's record launches (fused and plain) against the plain loop (on
        ``sub`` of the lanes if given) -> (max|diff|, plain ms, the plain
        loop's counted work, the fused launch's records)."""
        bvh = bvh or {}
        acc, rec = mk.run_megakernel_record(**k2, **bvh, max_depth=depth, radiance=True, **flags)
        _, plain = mk.run_megakernel_record(**k2, **bvh, max_depth=depth, **flags)
        bit_equal(rec, plain, f"{what}: fused vs plain records")
        full_rec = rec
        if sub is not None:
            k2 = lane_subset(k2, sub)
            acc, rec = acc[:, sub], rec[:, sub]
        (ref_acc, ref_rec), plain_ms, counts = plain_forward(
            lambda: mk.run_megakernel_record_reference(**k2, **bvh, max_depth=depth,
                                                       radiance=True, **flags))
        bit_equal(rec, ref_rec, f"{what}: records vs plain")
        err = bit_equal(acc, ref_acc, f"{what}: fused radiance vs plain")
        return err, plain_ms, counts, full_rec

    def bouncing(width):
        return bouncing_book1(demo, width)

    k8r = {}
    bk2, _ = grad_inputs(bouncing, 320, 4, 8)
    n_active = int((bk2["table"][:, 5] > 0).sum())
    for tag, flags in flag_sets.items():
        what = f"K8 record {tag} bouncing book1 320w 4spp d8"
        err, plain_ms, counts, rec = k8_record_check(bk2, 8, flags, what)
        ms = cuda_ms(lambda: mk.run_megakernel_record(**bk2, max_depth=8, radiance=True,
                                                      **flags), 3)
        b, by = bound(k8_ops(counts, n_active, **flags),
                      nbytes(*bk2.values()) + nbytes(rec) + 3 * 4 * rec.shape[1])
        print(f"{what}: kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.4f} ms ({by}; "
              f"{counts['searches']} searches x {n_active} rows, {counts['issued']} samples)")
        k8r[tag] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                        launch_shape=brute_shape(True, True, bk2, what, **flags))
    k2_ms = cuda_ms(lambda: mk.run_megakernel_record(**bk2, max_depth=8, radiance=True), 3)
    print(f"  K2 on the same lanes (static kernel, bouncing table): {k2_ms:.3f} ms; K8 both / K2 "
          f"{k8r['both']['ms'] / k2_ms:.3f}")

    # The walk with a moving camera in record mode, n1936 320w 4 spp d8.
    sc = demo.sphere_stress(width=320, copies=4)
    sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    w_sd = sc.build(device=dev)
    wk2, _ = grad_inputs(lambda width: sc, 320, 4, 8)
    walk = dict(wk2, table=integrator.permute_table(wk2["table"], w_sd.sph_swept_perm))
    bvh = dict(swept_nodes=w_sd.sph_swept_nodes, swept_meta=w_sd.sph_swept_meta)
    cam_only = flag_sets["camera"]
    what = f"K8 record walk camera n{w_sd.sph_center.shape[0]} 320w 4spp d8"
    err, plain_ms, counts, rec = k8_record_check(walk, 8, cam_only, what, bvh=bvh)
    b_acc, b_rec = mk.run_megakernel_record(**wk2, max_depth=8, radiance=True, **cam_only)
    acc, _ = mk.run_megakernel_record(**walk, **bvh, max_depth=8, radiance=True, **cam_only)
    bit_equal(rec, b_rec, f"{what}: records vs K8 brute camera")
    bit_equal(acc, b_acc, f"{what}: fused radiance vs K8 brute camera")
    ms = cuda_ms(lambda: mk.run_megakernel_record(**walk, **bvh, max_depth=8, radiance=True,
                                                  **cam_only), 3)
    b, by = bound(walk_ops(counts) + counts["issued"] * CAM_OPS,
                  nbytes(walk["table"], *bvh.values(), rec) + 5 * 4 * rec.shape[1])
    print(f"{what}: kernel {ms:.3f} ms, plain walk {plain_ms:.1f} ms, bound {b:.4f} ms ({by}); "
          f"work {counts}")
    k8r["walk"] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                       launch_shape=tree_shape(True, dict(walk, **bvh), what, **cam_only))
    del wk2, walk, b_acc, b_rec, acc

    # A static table given the animated flag (all-zero motion columns): K2's words.
    sk2, _ = grad_inputs(demo.book1_end_scene, 320, 4, 8)
    if bool(sk2["table"][:, 24:30].any()):
        raise AssertionError("static book1's table should have zero motion columns")
    a2, r2 = mk.run_megakernel_record(**sk2, max_depth=8, radiance=True)
    a8, r8 = mk.run_megakernel_record(**sk2, max_depth=8, radiance=True, animated=True)
    bit_equal(r8, r2, "K8 record (animated, zero motion) vs K2 records, book1 320w 4spp d8")
    bit_equal(a8, a2, "K8 record (animated, zero motion) vs K2 fused radiance")
    del sk2, a2, r2, a8, r8

    # The main path's launch: bouncing book1 1920x1080, 4 spp, d8 (both flags),
    # plain on 32768 lanes; K2 on the same launch.
    mk2, _ = grad_inputs(bouncing, 1920, 4, 8)
    r = mk2["pix"].shape[1]
    sub = torch.randperm(r, generator=torch.Generator().manual_seed(8))[:N_SUB].sort().values
    _, _, counts, rec = k8_record_check(mk2, 8, both, f"K8 record both 1920x1080 4spp d8 on "
                                                      f"{N_SUB} lanes", sub=sub.to(dev))
    rec_main_shape = brute_shape(True, True, mk2, "K8 record both 1080p (fused)", **both)
    brute_shape(True, False, mk2, "K8 record both 1080p (plain)", **both)
    rec_main_ms = cuda_ms(lambda: mk.run_megakernel_record(**mk2, max_depth=8, radiance=True,
                                                           **both), 3)
    rec_main_k2_ms = cuda_ms(lambda: mk.run_megakernel_record(**mk2, max_depth=8,
                                                              radiance=True), 3)
    scale = r / N_SUB
    rec_main_b, rec_main_by = bound(k8_ops(counts, n_active, **both) * scale,
                                    nbytes(*mk2.values()) + nbytes(rec) + 3 * 4 * r)
    print(f"K8 record both bouncing book1 1920x1080 4spp d8 (fused): {rec_main_ms:.3f} ms, K2 "
          f"on the same launch {rec_main_k2_ms:.3f} ms (ratio {rec_main_ms / rec_main_k2_ms:.3f}); "
          f"bound {rec_main_b:.3f} ms ({rec_main_by}; work on the checked lanes {counts}, "
          f"x{scale:.1f})")
    del mk2, rec
    kernels["megakernel_motion_record"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1828",
        **k8r["both"],
        ms_animated=k8r["animated"]["ms"], bound_ms_animated=k8r["animated"]["bound_ms"],
        plain_ms_animated=k8r["animated"]["plain_ms"],
        ms_camera=k8r["camera"]["ms"], bound_ms_camera=k8r["camera"]["bound_ms"],
        plain_ms_camera=k8r["camera"]["plain_ms"],
        ms_walk_camera=k8r["walk"]["ms"], plain_ms_walk_camera=k8r["walk"]["plain_ms"],
        bound_ms_walk_camera=k8r["walk"]["bound_ms"],
        launch_shape_walk_camera=k8r["walk"]["launch_shape"], k2_ms_same_lanes=k2_ms,
        main_ms=rec_main_ms, main_bound_ms=rec_main_b, main_k2_ms=rec_main_k2_ms,
        main_launch_shape=rec_main_shape,
    )

    # --- K6: the swept-tree walk vs its plain version and vs K8 / K1 ----------
    mark('K6: the swept-tree walk vs its plain version and vs K8 / K1')
    def plain_cull(fn):
        """(result, ms, the plain loop's counted work: searches, samples
        issued, and the swept-tree walk's nodes, rows and roots) of one call."""
        mk.SEARCH_COUNTS.update(searches=0, issued=0)
        mk.CULL_COUNTS.update(nodes=0, rows=0, roots=0)
        out, ms = host_ms(fn)
        return out, ms, dict(mk.SEARCH_COUNTS, **mk.CULL_COUNTS)

    def cull_ops(counts, animated, cam_animated):
        row = MOVING_DISC_OPS if animated else HIT_DISC_OPS
        return (counts["nodes"] * SLAB_OPS + counts["rows"] * row + counts["roots"] * ROOT_OPS
                + cam_animated * counts["issued"] * CAM_OPS)

    def swept_for(sd, leaf=None, rows=None):
        """K6's tree of ``sd`` (perm, nodes, meta): the scene's own, or
        built at ``leaf`` spheres a leaf over its first ``rows`` rows."""
        if leaf is None and rows is None:
            return sd.sph_swept_perm, sd.sph_swept_nodes, sd.sph_swept_meta
        keep = slice(0, rows)
        arrays = [x[keep].cpu().numpy() for x in (sd.sph_center, sd.sph_radius,
                                                  sd.sph_active, sd.sph_center_d,
                                                  sd.sph_radius_d)]
        tables = mk.sphere_bvh_tables(*arrays[:3], leaf or mk.SWEPT_LEAF, *arrays[3:])
        return tuple(torch.from_numpy(x).to(dev) for x in tables)

    built = {}

    def cull_inputs(copies, width, spp, depth, record=False, leaf=None, rows=None):
        """Bouncing stress (copies) at ``width``: (its scene data, the
        brute inputs on the original table, K6's: the table in the swept
        tree's order and the tree, the scene's or at ``leaf``); record mode
        lays the lanes out sample-major. ``rows`` keeps the table's first
        rows only (the crossover). Each scene is built once."""
        if (copies, width) not in built:
            sc = bouncing_stress(demo, width, copies)
            built[copies, width] = (sc, sc.build(device=dev), sc.scene_cam.params(device=dev))
        sc, sd, cp = built[copies, width]
        if not (sd.animated and cp.animated and sd.sph_swept_nodes is not None):
            raise AssertionError("bouncing stress should move and carry its swept tree")
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        brute, _ = integrator.mega_inputs(sd, cp, w, h, spp, depth, 0)
        if rows is not None:
            brute["table"] = brute["table"][:rows].contiguous()
        if record:
            p = w * h
            brute["pix"] = torch.arange(p, device=dev, dtype=torch.int32).repeat(spp)[None]
            brute["sample0"] = torch.arange(spp, device=dev,
                                            dtype=torch.int32).repeat_interleave(p)[None]
        perm, nodes, meta = swept_for(sd, leaf, rows)
        cull = dict(brute, table=integrator.permute_table(brute["table"], perm),
                    swept_nodes=nodes, swept_meta=meta)
        return sd, brute, cull

    both = flag_sets["both"]

    def k6_forward(copies, width, spp, depth, lanes=None):
        """K6's forward launch (moving spheres and camera) on bouncing
        stress against the plain version (on ``lanes`` if given) and, where
        K8's brute search holds the table, against it on the original
        table."""
        sd, brute, cull = cull_inputs(copies, width, spp, depth)
        n = sd.sph_center.shape[0]
        what = f"K6 n{n} {width}w {spp}spp d{depth}"
        out = mk.run_megakernel(**cull, **both)
        ms = cuda_ms(lambda: mk.run_megakernel(**cull, **both), 1 if width == 1920 else 2)
        if n <= mk.MAX_ROWS_ANIMATED:  # every lane against the brute search
            bit_equal(out, mk.run_megakernel(**brute, **both), f"{what} vs K8 brute")
        r_all = cull["pix"].shape[1]
        valid_all = int((cull["sample0"] < mk.NO_SAMPLE).sum())
        shape = brute_shape(False, True, cull, what, **both)
        sub = cull
        if lanes is not None:
            sub, out = lane_subset(cull, lanes), out[:, lanes]
            what += f" on {lanes.numel()} lanes"
        ref, plain_ms, counts = plain_cull(
            lambda: mk.run_megakernel_reference(**sub, **both, by_sample=True))
        err = bit_equal(out, ref, f"{what} vs plain")
        scale = valid_all / int((sub["sample0"] < mk.NO_SAMPLE).sum())
        b, by = bound(cull_ops(counts, **both) * scale, nbytes(*cull.values()) + 3 * 4 * r_all)
        print(f"{what}: K6 {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.4f} ms ({by}); "
              f"work {counts}, x{scale:.2f}; {per_search(counts)}")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                    launch_shape=shape, **per_search(counts))

    def block_lanes(n_blocks, seed, count=64):
        """The lanes of ``count`` random pixel blocks of a launch's ``n_blocks``."""
        blocks = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(seed))[:count]
        return (blocks.sort().values[:, None] * mk.TILE
                + torch.arange(mk.TILE)).reshape(-1).to(dev)

    # n1936 and n7744 at 320w in full (n1936 also against K8's brute
    # search); the n7744 1920x1080 launch on K6_MAIN_BLOCKS of its 4080
    # pixel blocks (the plain walk's time bounds them).
    k6 = {copies: k6_forward(copies, 320, 8, 50) for copies in (4, 16)}
    k6_main = k6_forward(16, 1920, 32, 50,
                         lanes=block_lanes(n_blocks, 9, count=K6_MAIN_BLOCKS))
    print(f"  K6 n7744 1920x1080 32spp d50: {k6_main['ms']:.1f} ms "
          f"({1920 * 1080 * 32 / k6_main['ms'] / 1e3:.2f} Mrays/s)")

    # The leaf size: K6 over trees of 4, 8 and 16 spheres a leaf, at n7744
    # 320w and on the 1920x1080 launch, in turns (8 first and last).
    leaf_ms = {}
    for leaf in (8, 4, 16, 8):
        for width, spp in ((320, 8), (1920, 32)):
            _, _, x = cull_inputs(16, width, spp, 50, leaf=leaf)
            ms = cuda_ms(lambda: mk.run_megakernel(**x, **both), 1 if width == 1920 else 3)
            leaf_ms.setdefault(f"leaf{leaf}_{width}w", []).append(ms)
            print(f"  K6 n7744 {width}w {spp}spp d50 at leaf {leaf} "
                  f"({x['swept_nodes'].shape[0]} nodes): {ms:.3f} ms")
            del x

    # The same walk over a static table's tree (book1, zero deltas) is K5,
    # a pure skip over K1's search.
    s_sd, s_cp, s_in = k8_inputs(demo.book1_end_scene(width=320), 8, 50)
    zero = torch.zeros_like(s_sd.sph_center)
    tree = swept_for(replace(s_sd, sph_center_d=zero, sph_radius_d=zero[:, 0]),
                     leaf=mk.SWEPT_LEAF)
    s_cull = dict(s_in, table=integrator.permute_table(s_in["table"], tree[0]),
                  swept_nodes=tree[1], swept_meta=tree[2])
    out = mk.run_megakernel(**s_cull, animated=False)
    bit_equal(out, mk.run_megakernel(**s_in, animated=False),
              "K5 static book1 320w 8spp d50 vs K1")
    ref, plain_ms, counts = plain_walk(
        lambda: mk.run_megakernel_reference(**s_cull, by_sample=True))
    bit_equal(out, ref, "K5 static book1 320w 8spp d50 vs plain")
    k5_static_ms = cuda_ms(lambda: mk.run_megakernel(**s_cull, animated=False), 3)
    k5_static_k1_ms = cuda_ms(lambda: mk.run_megakernel(**s_in, animated=False), 3)
    print(f"K5 static book1 320w 8spp d50: K5 {k5_static_ms:.3f} ms, K1 {k5_static_k1_ms:.3f} "
          f"ms, plain {plain_ms:.1f} ms; work {counts}; {per_search(counts)}")
    kernels["megakernel_walk"].update(ms_static_book1=k5_static_ms,
                                      k1_ms_static_book1=k5_static_k1_ms,
                                      plain_ms_static_book1=plain_ms)
    del s_in, s_cull, out, ref

    # The animated CULL_MIN_ROWS crossover: K6 and the K8 brute search on
    # the same lanes of bouncing stress n1936 and of its first 1,024 rows,
    # in turns (K8, K6, K6, K8).
    crossover = {}
    for rows in (None, 1024):
        for width, spp in ((320, 8), (1920, 32)):
            _, brute, cull = cull_inputs(4, width, spp, 50, rows=rows)
            reps = 3 if width == 320 else 1
            t = [cuda_ms(lambda: mk.run_megakernel(**brute, **both), reps),
                 cuda_ms(lambda: mk.run_megakernel(**cull, **both), reps),
                 cuda_ms(lambda: mk.run_megakernel(**cull, **both), reps),
                 cuda_ms(lambda: mk.run_megakernel(**brute, **both), reps)]
            n = brute["table"].shape[0]
            bit_equal(mk.run_megakernel(**cull, **both), mk.run_megakernel(**brute, **both),
                      f"K6 vs K8 brute, bouncing stress n{n} {width}w")
            crossover[f"n{n}_{width}w"] = dict(k8_ms=[t[0], t[3]], k6_ms=[t[1], t[2]])
            print(f"K6 vs K8 brute, bouncing stress n{n} {width}w {spp}spp d50 (same lanes, "
                  f"in turns): K8 {t[0]:.2f} / {t[3]:.2f} ms, K6 {t[1]:.2f} / {t[2]:.2f} ms "
                  f"(K8 / K6 {(t[0] + t[3]) / (t[1] + t[2]):.3f})")
    del brute, cull
    kernels["megakernel_cull"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1681",
        **k6[16], ms_n1936=k6[4]["ms"], plain_ms_n1936=k6[4]["plain_ms"],
        bound_ms_n1936=k6[4]["bound_ms"], main_ms=k6_main["ms"],
        main_bound_ms=k6_main["bound_ms"], main_plain_ms_checked_lanes=k6_main["plain_ms"],
        main_launch_shape=k6_main["launch_shape"],
        main_nodes_per_search=k6_main["nodes_per_search"],
        main_rows_per_search=k6_main["rows_per_search"],
        leaf_ms=leaf_ms, crossover=crossover,
    )

    # K6 in record mode (fused and plain), against the plain version and, at
    # n1936, K8's brute record on the original table.
    def k6_record(copies, width, sub=None):
        sd, brute, cull = cull_inputs(copies, width, 4, 8, record=True)
        n = sd.sph_center.shape[0]
        what = f"K6 record n{n} {width}w 4spp d8"
        tree = dict(swept_nodes=cull.pop("swept_nodes"), swept_meta=cull.pop("swept_meta"))
        if sub is not None:
            what += f" on {sub.numel()} lanes"
        mk.CULL_COUNTS.update(nodes=0, rows=0, roots=0)
        err, plain_ms, counts, rec = k8_record_check(cull, 8, both, what, sub=sub, bvh=tree)
        counts = dict(counts, **mk.CULL_COUNTS)  # the plain loop's, run once there
        ms = cuda_ms(lambda: mk.run_megakernel_record(**cull, **tree, max_depth=8,
                                                      radiance=True, **both), 3)
        if n <= mk.MAX_ROWS_ANIMATED and sub is None:
            acc, _ = mk.run_megakernel_record(**cull, **tree, max_depth=8, radiance=True, **both)
            b_acc, b_rec = mk.run_megakernel_record(**brute, max_depth=8, radiance=True, **both)
            bit_equal(rec, b_rec, f"{what}: records vs K8 brute record")
            bit_equal(acc, b_acc, f"{what}: fused radiance vs K8 brute record")
        shape = brute_shape(True, True, dict(cull, **tree), what, **both)
        r = cull["pix"].shape[1]
        scale = r / (r if sub is None else sub.numel())
        b, by = bound(cull_ops(counts, **both) * scale,
                      nbytes(*cull.values(), *tree.values(), rec) + 3 * 4 * r)
        print(f"{what}: K6 {ms:.3f} ms (fused), plain {plain_ms:.1f} ms, bound {b:.4f} ms "
              f"({by}); work {counts}, x{scale:.2f}; {per_search(counts)}")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                    launch_shape=shape, **per_search(counts))

    k6r = {copies: k6_record(copies, 320) for copies in (4, 16)}
    r = 1920 * 1080 * 4
    sub = torch.randperm(r, generator=torch.Generator().manual_seed(10))[:K6_RECORD_LANES]
    k6r_main = k6_record(16, 1920, sub=sub.sort().values.to(dev))
    kernels["megakernel_cull_record"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1828",
        **k6r[16], ms_n1936=k6r[4]["ms"], plain_ms_n1936=k6r[4]["plain_ms"],
        bound_ms_n1936=k6r[4]["bound_ms"], main_ms=k6r_main["ms"],
        main_bound_ms=k6r_main["bound_ms"], main_plain_ms_checked_lanes=k6r_main["plain_ms"],
        main_launch_shape=k6r_main["launch_shape"],
        main_nodes_per_search=k6r_main["nodes_per_search"],
        main_rows_per_search=k6r_main["rows_per_search"],
    )

    # --- K7: the triangle-BVH stage vs its plain version -----------------------
    mark('K7: the triangle-BVH stage vs its plain version')
    def mesh_inputs(sc, spp, depth, record=False, leaf_size=None):
        """(scene data, the kernel's inputs with the mesh's tables, the
        scene's motion flags) for every pixel of ``sc``; record mode lays
        the lanes out sample-major."""
        sd = sc.build(leaf_size=leaf_size, device=dev)
        cp = sc.scene_cam.params(device=dev)
        w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
        inputs, _ = integrator.mega_inputs(sd, cp, w, h, spp, depth, sc.seed)
        inputs.update(zip(("tri_nodes", "tris", "mats", "tri_meta"),
                          integrator.make_tri_tables(sd)))
        if record:
            p = w * h
            inputs["pix"] = torch.arange(p, device=dev, dtype=torch.int32).repeat(spp)[None]
            inputs["sample0"] = torch.arange(
                spp, device=dev, dtype=torch.int32).repeat_interleave(p)[None]
        return sd, inputs, dict(animated=bool(sd.animated), cam_animated=bool(cp.animated))

    def plain_tri(fn):
        """(result, ms, the plain loop's counted work) of one plain K7 call."""
        mk.SEARCH_COUNTS.update(searches=0, issued=0)
        mk.TRI_COUNTS.update(nodes=0, rows=0)
        out, ms = host_ms(fn)
        return out, ms, dict(mk.SEARCH_COUNTS, **mk.TRI_COUNTS)

    def tri_ops(counts, n_rows, flags):
        """K7's work under K8's flags: the (moving) search's rows, a Woop or
        a moving row's leaf test, the camera per issued sample."""
        row_ops = MOTION_SEARCH_OPS if flags["animated"] else SEARCH_OPS
        leaf_ops = MT_MOVING_OPS if flags["animated"] else WOOP_OPS
        return (counts["searches"] * n_rows * row_ops + counts["nodes"] * TRI_SLAB_OPS
                + counts["rows"] * leaf_ops
                + (counts["issued"] * CAM_OPS if flags["cam_animated"] else 0))

    def tri_shape(record, inputs, what, flags):
        """K7's launch shape for ``inputs``, printed."""
        shape = mk.flat_launch_shape(record, True, inputs["table"].shape[0],
                                     inputs["pix"].shape[1],
                                     tri_nodes=int(inputs["tri_nodes"].shape[0]), **flags)
        print(f"  {what} launch shape: {shape}")
        return shape

    def tri_bytes(inputs, *extra):
        """Bytes read and written once: the tables, each lane's ids and sums."""
        tables = (inputs[k] for k in ("table", "tri_nodes", "tris", "mats", "tri_meta"))
        return nbytes(*tables, *extra) + 5 * 4 * inputs["pix"].shape[1]

    def k7_forward(sc, spp, depth, what, lanes=None, reps=2):
        """K7's forward launch (Woop or moving rows, with or without K8's
        camera, as the scene gives them) against the plain version, on
        ``lanes`` of it if given, bit for bit; the counted work scaled to the
        whole launch."""
        sd, full, flags = mesh_inputs(sc, spp, depth)
        out = mk.run_megakernel(**full, **flags)
        ms = cuda_ms(lambda: mk.run_megakernel(**full, **flags), reps)
        shape = tri_shape(False, full, what, flags)
        inputs = full
        if lanes is not None:
            inputs, out = lane_subset(full, lanes), out[:, lanes]
            what += f" on {lanes.numel()} lanes"
        ref, plain_ms, counts = plain_tri(
            lambda: mk.run_megakernel_reference(**inputs, **flags, by_sample=True))
        err = bit_equal(out, ref, f"{what} vs plain")
        n_rows = int((full["table"][:, 5] > 0).sum())
        scale = (int((full["sample0"] < mk.NO_SAMPLE).sum())
                 / int((inputs["sample0"] < mk.NO_SAMPLE).sum()))
        b, by = bound(tri_ops(counts, n_rows, flags) * scale, tri_bytes(full))
        print(f"{what} {flags}: {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b:.4f} ms "
              f"({by}); {sd.num_tris} triangles, {sd.bvh_min.shape[0]} nodes (leaf "
              f"{sd.bvh_leaf_size}); work {counts}, x{scale:.2f}")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                    launch_shape=shape)

    def k7_record(sc, spp, depth, what, sub=None):
        """K7's record launches (fused and plain, with the scene's motion
        flags) against the plain version, on ``sub`` of the lanes if given,
        bit for bit."""
        _, full, flags = mesh_inputs(sc, spp, depth, record=True)
        acc, rec = mk.run_megakernel_record(**full, max_depth=depth, radiance=True, **flags)
        zero, plain = mk.run_megakernel_record(**full, max_depth=depth, **flags)
        bit_equal(rec, plain, f"{what}: fused vs plain records")
        if bool(zero.any()):
            raise AssertionError(f"{what}: the plain record launch summed radiance")
        ms = cuda_ms(lambda: mk.run_megakernel_record(
            **full, max_depth=depth, radiance=True, **flags), 3)
        ms_unfused = cuda_ms(lambda: mk.run_megakernel_record(
            **full, max_depth=depth, **flags), 3)
        shape = tri_shape(True, full, what, flags)
        full_rec, inputs = rec, full
        if sub is not None:
            inputs, acc, rec = lane_subset(full, sub), acc[:, sub], rec[:, sub]
            what += f" on {sub.numel()} lanes"
        (ref_acc, ref_rec), plain_ms, counts = plain_tri(
            lambda: mk.run_megakernel_record_reference(**inputs, max_depth=depth,
                                                       radiance=True, **flags))
        bit_equal(rec, ref_rec, f"{what}: records vs plain")
        err = bit_equal(acc, ref_acc, f"{what}: fused radiance vs plain")
        tri_words = int(((full_rec & mk.F_TRI) > 0).sum())
        if not tri_words:
            raise AssertionError(f"{what}: no triangle won")
        n_rows = int((full["table"][:, 5] > 0).sum())
        scale = full_rec.shape[1] / rec.shape[1]
        b, by = bound(tri_ops(counts, n_rows, flags) * scale, tri_bytes(full, full_rec))
        print(f"{what} {flags}: record fused {ms:.3f} ms, plain {ms_unfused:.3f} ms; plain "
              f"version {plain_ms:.1f} ms; bound {b:.4f} ms ({by}); {tri_words} triangle "
              f"words of {int(((full_rec & mk.F_HIT) > 0).sum())} hits; work {counts}, "
              f"x{scale:.2f}")
        return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, bound_ms=b, bound_by=by,
                    ms_unfused=ms_unfused, launch_shape=shape)

    k7_forward(fan(tscene, 64), 8, 50, "K7 fan 64w 8spp d50")
    k7_fwd = k7_forward(torus_teapot(tscene, 320), 8, 50, "K7 torus_teapot 320w 8spp d50")
    # The 1920x1080 launches of K7, K7 moving and K7 moving with the camera
    # on 32 pixel blocks (so that the script stays under half its time
    # limit).
    n_blocks = (1920 // 32) * math.ceil(1080 / 16)
    blocks = torch.randperm(n_blocks, generator=torch.Generator().manual_seed(9))[:32]
    lanes = (blocks.sort().values[:, None] * mk.TILE + torch.arange(mk.TILE)).reshape(-1).to(dev)
    k7_main = k7_forward(torus_teapot(tscene, 1920), 32, 50,
                         "K7 torus_teapot 1920x1080 32spp d50", lanes=lanes, reps=1)
    kernels["megakernel_tri"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1681",
        **k7_fwd, main_ms=k7_main["ms"], main_bound_ms=k7_main["bound_ms"],
        main_plain_ms_checked_lanes=k7_main["plain_ms"],
        main_launch_shape=k7_main["launch_shape"],
    )
    k7_rec = k7_record(torus_teapot(tscene, 320), 4, 8, "K7 torus_teapot 320w 4spp d8")
    r = 1920 * 1080 * 4
    sub = torch.randperm(r, generator=torch.Generator().manual_seed(10))[:N_SUB].sort().values
    k7_rec_main = k7_record(torus_teapot(tscene, 1920), 4, 8, "K7 torus_teapot 1920x1080 4spp d8",
                            sub=sub.to(dev))
    kernels["megakernel_tri_record"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1828",
        **k7_rec, main_ms=k7_rec_main["ms"], main_bound_ms=k7_rec_main["bound_ms"],
        main_ms_unfused=k7_rec_main["ms_unfused"], main_launch_shape=k7_rec_main["launch_shape"],
    )

    # K7's walk (Woop) against the brute Möller–Trumbore over all 6,320 rows,
    # on 2^16 random rays toward torus_teapot's mesh (the JAX package's
    # tests/test_integrator.py holds its Pallas stage to its walk so).
    t_sd = torus_teapot(tscene, 320).build(device=dev)
    nodes, tris, _, meta = integrator.make_tri_tables(t_sd)
    verts = torch.cat([t_sd.tri_v0, t_sd.tri_v1, t_sd.tri_v2])
    lo, hi = verts.amin(0), verts.amax(0)
    gen = torch.Generator(device=dev).manual_seed(12)
    n_rays = 1 << 16
    o = (0.5 * (lo + hi) + (hi - lo) * (3 * torch.rand((n_rays, 3), device=dev, generator=gen)
                                        - 1.5)).contiguous()
    d = (0.5 * (lo + hi) + (hi - lo) * (torch.rand((n_rays, 3), device=dev, generator=gen)
                                        - 0.5) - o).contiguous()
    wt, wi = mk.tri_closest_reference(o, d, torch.full((n_rays,), mk.BIG, device=dev), nodes,
                                      meta, tris)
    bt, bi, bh = [], [], []
    for lo_r in range(0, n_rays, 4096):
        x = intersect.hit_triangles(o[lo_r:lo_r + 4096], d[lo_r:lo_r + 4096], t_sd.tri_v0,
                                    t_sd.tri_v1, t_sd.tri_v2, t_sd.tri_active, mk.T_MIN)
        bt.append(x[0])
        bi.append(x[1].long())
        bh.append(x[2])
    bt, bi, bh = torch.cat(bt), torch.cat(bi), torch.cat(bh)
    wh = wt < mk.BIG
    differ = (wh != bh) | (wh & (wi != bi))
    walk_missed = bh & (~wh | (wt > bt * (1 + 1e-4)))
    print(f"K7 walk vs brute Möller–Trumbore, {n_rays} random rays at torus_teapot: "
          f"{int(bh.sum())} hit; winners differ on {int(differ.sum())} "
          f"({float(differ.float().mean()):.2e}); the walk missed a nearer brute hit on "
          f"{int(walk_missed.sum())}, hit where the brute test did not on "
          f"{int((wh & ~bh).sum())}")
    if not float(differ.float().mean()) < 1e-3:
        raise AssertionError("K7's walk and the brute triangle test disagree")
    del o, d, wt, wi, bt, bi, bh, verts

    # The leaf-size sweep: K7 forward at torus_teapot 320w 8 spp d50 for
    # each leaf size; the fastest is scene.BVH_LEAF_CUDA, the card's default.
    # Beside it, the main path's launch (1920x1080 32 spp d50) at each leaf.
    sweep, sweep_main = {}, {}
    sweep_sc, sweep_main_sc = torus_teapot(tscene, 320), torus_teapot(tscene, 1920)
    for leaf in (4, 8, 16, 32, 64):
        sd, inputs, _ = mesh_inputs(sweep_sc, 8, 50, leaf_size=leaf)
        mk.run_megakernel(**inputs, animated=False)
        sweep[leaf] = cuda_ms(lambda: mk.run_megakernel(**inputs, animated=False), 3)
        _, inputs, _ = mesh_inputs(sweep_main_sc, 32, 50, leaf_size=leaf)
        sweep_main[leaf] = cuda_ms(lambda: mk.run_megakernel(**inputs, animated=False), 1)
        print(f"  K7 leaf-size sweep, torus_teapot, leaf {leaf}: {sd.bvh_min.shape[0]} nodes; "
              f"320w 8spp d50 {sweep[leaf]:.3f} ms; 1920x1080 32spp d50 "
              f"{sweep_main[leaf]:.3f} ms")
    fastest = min(sweep, key=sweep.get)
    print(f"K7 leaf-size sweep: fastest leaf at 320w {fastest}, at 1080p "
          f"{min(sweep_main, key=sweep_main.get)}; scene.BVH_LEAF_CUDA = {tscene.BVH_LEAF_CUDA}")
    kernels["megakernel_tri"].update(
        leaf_sweep_ms={str(k): v for k, v in sweep.items()},
        leaf_sweep_main_ms={str(k): v for k, v in sweep_main.items()})
    del inputs, sweep_sc, sweep_main_sc, t_sd

    # --- K7 moving (and K7 with K8's camera) vs the plain version -------------
    mark("K7 moving (and K7 with K8's camera) vs the plain version")
    t0 = time.perf_counter()
    mt_sc = moving_torus_teapot(tscene, 320)  # the animation of 6,320 aliases
    print(f"moving torus_teapot: the scene's 12,640 keyframes added in "
          f"{time.perf_counter() - t0:.2f} s")
    k7_forward(moving_fan(tscene, 64), 8, 50, "K7 moving fan 64w 8spp d50")
    k7m_fwd = k7_forward(mt_sc, 8, 50, "K7 moving torus_teapot 320w 8spp d50")
    mt_sc.scene_cam.image_width = 1920
    k7m_main = k7_forward(mt_sc, 32, 50, "K7 moving torus_teapot 1920x1080 32spp d50",
                          lanes=lanes, reps=1)
    mt_sc.scene_cam.image_width = 320
    k7m_rec = k7_record(mt_sc, 4, 8, "K7 moving torus_teapot 320w 4spp d8")
    mt_sc.scene_cam.image_width = 1920
    k7m_rec_main = k7_record(mt_sc, 4, 8, "K7 moving torus_teapot 1920x1080 4spp d8",
                             sub=sub.to(dev))
    # One frame of main path 13's movie, in full at its own shape.
    mt_sc.scene_cam.image_width, mt_sc.scene_cam.frame = 400, 5
    k7m_movie = k7_forward(mt_sc, mt_sc.scene_cam.samples, mt_sc.scene_cam.max_depth,
                           "K7 moving torus_teapot movie frame 5 400x225 50spp d5")
    mt_sc.scene_cam.frame = 30
    # With K8's camera: moving torus_teapot, and K7 (Woop rows) on the
    # static torus_teapot, each seen by a rising camera at frame 30. The
    # forward comparisons run at 160w: their plain walks took 19-33 s at
    # 320w, and the script stays under half its time limit. Main path 15's
    # launch (1920x1080 32 spp d50) is held on the same 32 pixel blocks as
    # main path 12's.
    cam_sc = rising_camera(moving_torus_teapot(tscene, 160))
    k7m_cam = k7_forward(cam_sc, 8, 50, "K7 moving + camera torus_teapot 160w 8spp d50")
    cam_sc.scene_cam.image_width = 1920
    k7m_cam_main = k7_forward(cam_sc, 32, 50,
                              "K7 moving + camera torus_teapot 1920x1080 32spp d50",
                              lanes=lanes, reps=1)
    cam_sc.scene_cam.image_width = 320
    k7m_cam_rec = k7_record(cam_sc, 4, 8, "K7 moving + camera torus_teapot 320w 4spp d8")
    st_cam = rising_camera(torus_teapot(tscene, 160))
    st_cam.scene_cam.frame = 30
    k7_cam = k7_forward(st_cam, 8, 50, "K7 + camera torus_teapot 160w 8spp d50")
    st_cam.scene_cam.image_width = 320
    k7_cam_rec = k7_record(st_cam, 4, 8, "K7 + camera torus_teapot 320w 4spp d8")
    kernels["megakernel_tri"].update(ms_cam=k7_cam["ms"], plain_ms_cam=k7_cam["plain_ms"],
                                     bound_ms_cam=k7_cam["bound_ms"], shape_cam="160w 8spp d50")
    kernels["megakernel_tri_record"].update(
        ms_cam=k7_cam_rec["ms"], plain_ms_cam=k7_cam_rec["plain_ms"],
        bound_ms_cam=k7_cam_rec["bound_ms"], shape_cam="320w 4spp d8")
    kernels["megakernel_tri_moving"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1681",
        **k7m_fwd, main_ms=k7m_main["ms"], main_bound_ms=k7m_main["bound_ms"],
        main_plain_ms_checked_lanes=k7m_main["plain_ms"],
        main_launch_shape=k7m_main["launch_shape"],
        ms_cam=k7m_cam["ms"], plain_ms_cam=k7m_cam["plain_ms"],
        bound_ms_cam=k7m_cam["bound_ms"], shape_cam="160w 8spp d50",
        main_ms_cam=k7m_cam_main["ms"], main_plain_ms_cam=k7m_cam_main["plain_ms"],
        main_bound_ms_cam=k7m_cam_main["bound_ms"], movie_ms=k7m_movie["ms"],
        movie_plain_ms=k7m_movie["plain_ms"], movie_bound_ms=k7m_movie["bound_ms"],
        shape_movie="400x225 50spp d5",
    )
    kernels["megakernel_tri_moving_record"] = dict(
        source="crucible_tpu_torch/csrc/megakernel.cu",
        replaces="crucible_tpu/ops/pallas/megakernel.py:1828",
        **k7m_rec, main_ms=k7m_rec_main["ms"], main_bound_ms=k7m_rec_main["bound_ms"],
        main_ms_unfused=k7m_rec_main["ms_unfused"],
        main_launch_shape=k7m_rec_main["launch_shape"], ms_cam=k7m_cam_rec["ms"],
        plain_ms_cam=k7m_cam_rec["plain_ms"], bound_ms_cam=k7m_cam_rec["bound_ms"],
        shape_cam="320w 4spp d8",
    )
    del cam_sc, st_cam

    # K7 moving against K7 on one geometry: torus_teapot given a zero
    # keyframe on every triangle (all deltas zero, the same tree) takes K7
    # moving's (M, 32) rows and the moving search; the static scene takes
    # K7's Woop rows. Timed in turns (K7, K7 moving, K7 moving, K7) at 320w
    # 8 spp d50 and on the full 1920x1080 32 spp d50 launch.
    zero_sc, still_sc = torus_teapot(tscene, 320), torus_teapot(tscene, 320)
    for k in range(6320):
        zero_sc.translate_point((0.0, 0.0, 0.0), 5.0, "lerp", "local", f"tri{k}")
    same_geometry = {}
    for width, spp, reps in ((320, 8, 3), (1920, 32, 1)):
        runs = {}
        for sc in (zero_sc, still_sc):
            sc.scene_cam.image_width = width
            _, inputs, flags = mesh_inputs(sc, spp, 50)
            runs[flags["animated"]] = (inputs, flags)
            mk.run_megakernel(**inputs, **flags)
        times = {False: [], True: []}
        for moving in (False, True, True, False):
            inputs, flags = runs[moving]
            times[moving].append(cuda_ms(lambda: mk.run_megakernel(**inputs, **flags), reps))
        same_geometry[f"{width}w"] = dict(k7_ms=times[False], k7_moving_ms=times[True])
        print(f"K7 vs K7 moving on torus_teapot's still geometry, {width}w {spp}spp d50: "
              f"K7 {times[False]} ms, K7 moving (zero deltas) {times[True]} ms")
    kernels["megakernel_tri_moving"]["same_geometry_ms"] = same_geometry
    del zero_sc, still_sc, runs, inputs

    # K7 moving's walk against the brute Möller–Trumbore with motion over all
    # 6,320 rows, on 2^16 random rays with random shutter fractions toward
    # moving torus_teapot at frame 30. The walk lerps the edges and the
    # brute test the vertices, so grazing rays may pick another winner.
    m_sd = mt_sc.build(device=dev)
    nodes, tris, _, meta = integrator.make_tri_tables(m_sd)
    verts = torch.cat([m_sd.tri_v0, m_sd.tri_v1, m_sd.tri_v2])
    lo, hi = verts.amin(0), verts.amax(0)
    gen = torch.Generator(device=dev).manual_seed(13)
    o = (0.5 * (lo + hi) + (hi - lo) * (3 * torch.rand((n_rays, 3), device=dev, generator=gen)
                                        - 1.5)).contiguous()
    d = (0.5 * (lo + hi) + (hi - lo) * (torch.rand((n_rays, 3), device=dev, generator=gen)
                                        - 0.5) - o).contiguous()
    wr = torch.rand((n_rays,), device=dev, generator=gen)
    wt, wi = mk.tri_closest_reference(o, d, torch.full((n_rays,), mk.BIG, device=dev), nodes,
                                      meta, tris, w=wr)
    bt, bi, bh = [], [], []
    motion = (m_sd.tri_v0_d, m_sd.tri_v1_d, m_sd.tri_v2_d)
    for lo_r in range(0, n_rays, 4096):
        sl = slice(lo_r, lo_r + 4096)
        x = intersect.hit_triangles(o[sl], d[sl], m_sd.tri_v0, m_sd.tri_v1, m_sd.tri_v2,
                                    m_sd.tri_active, mk.T_MIN, v0d=motion[0], v1d=motion[1],
                                    v2d=motion[2], w=wr[sl])
        bt.append(x[0])
        bi.append(x[1].long())
        bh.append(x[2])
    bt, bi, bh = torch.cat(bt), torch.cat(bi), torch.cat(bh)
    wh = wt < mk.BIG
    differ = (wh != bh) | (wh & (wi != bi))
    walk_missed = bh & (~wh | (wt > bt * (1 + 1e-4)))
    mt_differ = int(differ.sum())
    print(f"K7 moving walk vs brute Möller–Trumbore with motion, {n_rays} random rays at "
          f"moving torus_teapot: {int(bh.sum())} hit; winners differ on {mt_differ} "
          f"({float(differ.float().mean()):.2e}); the walk missed a nearer brute hit on "
          f"{int(walk_missed.sum())}, hit where the brute test did not on "
          f"{int((wh & ~bh).sum())}")
    if not float(differ.float().mean()) < 1e-3:
        raise AssertionError("K7 moving's walk and the brute triangle test disagree")
    kernels["megakernel_tri_moving"]["walk_vs_brute_differ"] = mt_differ
    del o, d, wr, wt, wi, bt, bi, bh, verts, m_sd

    # --- the moving-scene gradient step on the card vs on the CPU, small -----
    mark('the moving-scene gradient step on the card vs on the CPU, small')
    # An animated camera rebuilds its basis per ray, so the card's and the
    # CPU's primary rays differ in the last ulps of their square roots and
    # divisions (torch on the card rounds them unlike torch on the CPU),
    # which flips the odd grazing lane's record between the CPU's plain K8
    # and the card's kernel. So the card's records are held to the CPU's
    # lane by lane (> 0.999 equal), the step on the same records (the
    # frozen-decision call, rec=, on both devices) at loss rel 1e-4 and
    # gradients normalized 1e-3, and the step with each device's own
    # records at the cross-path bounds (loss rel 2e-3, normalized 5e-3).
    # Then the replay alone: the CPU's rays and records replayed on both
    # devices. On book1 the replay's own sin / cos (the scatter's sampled
    # directions) round unlike the CPU's too, and a few lanes amplify it:
    # the checker's parity, floor(p / scale), is a choice the record does
    # not hold, and a lane that lands on the other square reflects another
    # albedo on. So bouncing book1 holds its radiometric leaves on every
    # lane (fault C4); over the lanes whose parity agrees at every row, its
    # loss and radiometric leaves at rel 1e-4 / normalized 1e-3 and its
    # fuzz and camera leaves at normalized 1e-2 (lanes whose directions
    # drift apart over later bounces stay in). Smoke in motion holds every
    # leaf at 1e-3 in each comparison.
    def moving_smoke(width):
        sc = demo.smoke_scene(width=width)
        sc.translate_y(0.3, 1.0 / 48.0, "lerp", "local", "ball")
        sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
        return sc

    def held_to(what, results, bounds, rel_max):
        """Hold the card's (loss, gradients) to the CPU's: the loss at
        ``rel_max``, each leaf of ``bounds`` at its normalized bound."""
        (lc, gc), (lp, gp) = [r[:2] for r in results]
        rel = abs(lc.item() - lp.item()) / lp.item()
        print(f"  {what}: loss {lc.item():.6f} vs {lp.item():.6f} (rel {rel:.2g})")
        if not rel <= rel_max:
            raise AssertionError(f"{what}: the card's and the CPU's losses disagree")
        for key in grad.TENSOR_KEYS:
            a, b = gc[key].cpu(), gp[key]
            nd = ((a - b).abs().max() / max(b.abs().max().item(), 1e-6)).item()
            bound_key = bounds.get(key)
            print(f"    {key}: max normalized diff {nd:.3g}"
                  + (f" (held at {bound_key:g})" if bound_key else " (not held)"))
            if bound_key and not nd <= bound_key:
                raise AssertionError(f"{what} {key}: card and CPU gradients disagree")

    cpu = torch.device("cpu")

    def same_rays_step(sc, where, rec, keep=None, leaf_size=None):
        """(loss, gradients, each row's checker parity (D, R)) of the step
        whose replay runs on ``where`` from the CPU's primary rays and
        ``rec``; the loss reads the lanes of ``keep`` (R,) bool, or all.
        The camera leaves reach the loss through the CPU's ray generation
        on both devices, so the two differ only in the replay's own
        arithmetic."""
        sd_c, cp_c = sc.build(leaf_size=leaf_size, device=cpu), sc.scene_cam.params(device=cpu)
        params = grad.extract_params(sd_c, cp_c)
        leaves = {k: params[k].detach().clone().requires_grad_(True)
                  for k in grad.leaf_keys(params)}
        _, cp_l = grad.apply_params(sd_c, cp_c, {**params, **leaves})
        pl, sl = grad._lanes(torch.arange(64 * 36), 2, 0)
        o, d, _ = generate_rays(cp_l, 64, 36, pl, sl, 0)
        sd_w, _ = grad.apply_params(sc.build(leaf_size=leaf_size, device=where),
                                    sc.scene_cam.params(device=where),
                                    {**params, **{k: v.to(where) for k, v in leaves.items()}})
        args = (sd_w, o.to(where), d.to(where), pl.to(where), sl.to(where), 0, 8,
                rec.to(where))
        parity, is_even = [], textures.checker_is_even

        def spy(inv_scale, p):
            out = is_even(inv_scale, p)
            parity.append(out.cpu())
            return out

        textures.checker_is_even = spy
        try:
            with torch.no_grad():
                replay.trace_replay(*args)
        finally:
            textures.checker_is_even = is_even
        rad = replay.trace_replay(*args)
        if keep is not None:
            rad = torch.where(keep.to(where)[:, None], rad, 0.0)
        loss = torch.mean(rad.reshape(2, -1, 3).mean(dim=0) ** 2)
        g = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach().cpu(), {k: torch.zeros_like(v) if gk is None else gk
                                     for (k, v), gk in zip(leaves.items(), g)}, \
            torch.stack(parity)

    kw = dict(width=64, height=36, spp=2, max_depth=8)
    radiometric = ("tex_color", "mat_emission")
    every = dict.fromkeys(grad.TENSOR_KEYS, 1e-3)
    for what, sc, bounds, kept_bounds in (
        ("bouncing book1", bouncing(64), dict.fromkeys(radiometric, 1e-3),
         {**dict.fromkeys(grad.TENSOR_KEYS, 1e-2), **dict.fromkeys(radiometric, 1e-3)}),
        ("moving smoke", moving_smoke(64), every, every),
    ):
        inputs = []
        for where in (dev, cpu):
            sd, cp = sc.build(device=where), sc.scene_cam.params(device=where)
            pix = torch.arange(64 * 36, device=where)
            inputs.append((sd, cp, pix, grad.record_decisions(sd, cp, pix, 0, **kw)))
        rec_card, rec_cpu = inputs[0][3], inputs[1][3]
        same = (rec_card.cpu() == rec_cpu).all(dim=0).float().mean().item()
        print(f"loss_and_grad {what} 64w 2spp d8, card vs CPU: records equal on {same:.5f} "
              f"of the lanes")
        if not same > 0.999:
            raise AssertionError(f"{what}: the card's and the CPU's records disagree")
        frozen, own = [], []
        for sd, cp, pix, rec in inputs:
            args = (grad.extract_params(sd, cp), sd, cp,
                    torch.zeros((64 * 36, 3), device=pix.device), pix, 0)
            frozen.append(grad.loss_and_grad(*args, rec=rec_card.to(pix.device), **kw))
            own.append(grad.loss_and_grad(*args, **kw))
        held_to("on the card's records", frozen, bounds, 1e-4)
        held_to("each on its own records", own, {k: 5e-3 for k in bounds}, 2e-3)
        steps = [same_rays_step(sc, where, rec_cpu) for where in (dev, cpu)]
        held_to("the CPU's rays and records replayed on both", steps, bounds, 1e-4)
        flips = (steps[0][2] != steps[1][2]).any(dim=0)
        held_to(f"the same without the {int(flips.sum())} of {flips.numel()} lanes whose "
                f"checker parity differs at some row",
                [same_rays_step(sc, where, rec_cpu, keep=~flips) for where in (dev, cpu)],
                kept_bounds, 1e-4)
    del inputs, frozen, own, steps

    # The mesh's gradient step on the card against the CPU: the fan, 64 wide,
    # 2 spp, depth 8, both sides built with leaf 32 (a card builds its own
    # default tree, whose leaf-order triangle ids differ), replayed from the
    # CPU's rays and records: the loss within rel 1e-4, the radiometric
    # leaves within normalized 1e-3.
    sc = fan(tscene, 64)
    recs = []
    for where in (dev, cpu):
        sd, cp = sc.build(leaf_size=32, device=where), sc.scene_cam.params(device=where)
        recs.append(grad.record_decisions(sd, cp, torch.arange(64 * 36, device=where), 0, **kw))
    same = (recs[0].cpu() == recs[1]).all(dim=0).float().mean().item()
    print(f"loss_and_grad fan 64w 2spp d8, card vs CPU: records equal on {same:.5f} of the lanes")
    if not same > 0.999:
        raise AssertionError("fan: the card's and the CPU's records disagree")
    held_to("fan: the CPU's rays and records replayed on both",
            [same_rays_step(sc, where, recs[1], leaf_size=32) for where in (dev, cpu)],
            dict.fromkeys(radiometric, 1e-3), 1e-4)
    del recs
    # The moving fan likewise (K7 moving's record, the eager replay's
    # moving-triangle branch).
    sc = moving_fan(tscene, 64)
    recs = []
    for where in (dev, cpu):
        sd, cp = sc.build(leaf_size=32, device=where), sc.scene_cam.params(device=where)
        recs.append(grad.record_decisions(sd, cp, torch.arange(64 * 36, device=where), 0, **kw))
    same = (recs[0].cpu() == recs[1]).all(dim=0).float().mean().item()
    print(f"loss_and_grad moving fan 64w 2spp d8, card vs CPU: records equal on {same:.5f} "
          f"of the lanes")
    if not same > 0.999:
        raise AssertionError("moving fan: the card's and the CPU's records disagree")
    held_to("moving fan: the CPU's rays and records replayed on both",
            [same_rays_step(sc, where, recs[1], leaf_size=32) for where in (dev, cpu)],
            dict.fromkeys(radiometric, 1e-3), 1e-4)
    del recs

    # --- main path 1: the forward render ---------------------------------------
    mark('main path 1: the forward render')
    scene = demo.book1_end_scene(width=1920)
    mk.zero_counts()
    img, ms = host_ms(lambda: render.render_image(scene, samples=32, max_depth=50))
    launches_k1 = mk.FORWARD_LAUNCHES["brute"]
    if tuple(img.shape) != (1080, 1920, 3):
        raise AssertionError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise AssertionError("image has non-finite values")
    if launches_k1 < 1:
        raise AssertionError("the render did not launch the megakernel")
    print(f"render_image book1 1920x1080 32spp d50: {ms / 1e3:.3f} s, "
          f"{1920 * 1080 * 32 / ms / 1e3:.2f} Mrays/s, mean {img.mean().item():.5f}, "
          f"megakernel launches {launches_k1}")
    png = REPO / "build" / "chip_smoke_book1.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")
    del img
    kernels["megakernel_forward"]["launches"] = launches_k1

    # --- main path 2: the gradient step, 1920x1080, 4 spp, depth 8 --------------
    mark('main path 2: the gradient step, 1920x1080, 4 spp, depth 8')
    w, h, spp = 1920, 1080, 4
    pix = torch.arange(w * h, device=dev)
    target = torch.zeros((w * h, 3), device=dev)
    kw = dict(width=w, height=h, spp=spp, max_depth=8)
    mrays = w * h * spp / 1e6
    counters = {
        "megakernel_record": lambda: mk.RECORD_LAUNCHES["brute"],
        "megakernel_walk_record": lambda: mk.RECORD_LAUNCHES["walk"],
        "replay_forward": lambda: rk.LAUNCHES_FORWARD,
        "replay_backward": lambda: rk.LAUNCHES_BACKWARD,
    }
    counts = dict.fromkeys(counters, 0)

    def zero_counts():
        mk.zero_counts()
        rk.zero_counts()

    def read_counts(what, need, never=()):
        got = {name: count() for name, count in counters.items()}
        print(f"  {what} launches: {got}")
        for name in need:
            if got[name] < 1:
                raise AssertionError(f"{what} did not launch {name}")
        for name in never:
            if got[name]:
                raise AssertionError(f"{what} launched {name}")
        for name, n in got.items():
            counts[name] += n

    def check_grads(loss, grads, sd, cp):
        if not math.isfinite(loss.item()):
            raise AssertionError("non-finite loss")
        for key in grad.TENSOR_KEYS:
            g = grads[key]
            if g.shape != grad.extract_params(sd, cp)[key].shape or not bool(g.isfinite().all()):
                raise AssertionError(f"gradient {key}: bad shape or non-finite")

    def replay_steps(sd, cp, what, record, other):
        """A warm and 3 timed ``loss_and_grad`` steps, ``record_decisions``
        and 3 frozen-decision steps at 1920x1080, 4 spp, d8; ``record`` is
        the record kernel that must launch, ``other`` the one that must not.
        -> (params, the warm step's loss and gradients, the timed steps' ms)."""
        params = grad.extract_params(sd, cp)
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        (loss0, grads), ms = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw))
        check_grads(loss0, grads, sd, cp)
        print(f"loss_and_grad {what} 1920x1080 4spp d8, warm step: {ms / 1e3:.3f} s, "
              f"loss {loss0.item():.6f}")
        step_ms = []
        for i in range(3):
            (loss, timed), ms = host_ms(
                lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw))
            check_grads(loss, timed, sd, cp)
            step_ms.append(ms)
            print(f"  step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s")
        print(f"  nvidia-smi: {smi()}; peak memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        read_counts("loss_and_grad", (record, "replay_backward"), (other,))

        zero_counts()
        rec, ms = host_ms(lambda: grad.record_decisions(sd, cp, pix, 0, **kw))
        print(f"record_decisions {what} 1920x1080 4spp d8: {ms / 1e3:.4f} s, records "
              f"{tuple(rec.shape)} ({nbytes(rec) / 1e6:.0f} MB)")
        for i in range(3):
            (loss, frozen), ms = host_ms(
                lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec, **kw))
            check_grads(loss, frozen, sd, cp)
            print(f"  frozen step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s, "
                  f"loss {loss.item():.6f}")
        rel = abs(loss.item() - loss0.item()) / loss0.item()
        if not rel <= 2e-3:
            raise AssertionError(f"frozen and fused losses differ by rel {rel:.3g}")
        read_counts("frozen-decision steps", (record, "replay_forward", "replay_backward"),
                    (other,))
        return params, loss0, grads, step_ms

    def ad_vs_replay(ad_loss, ad_grads, loss0, replay_grads):
        """Hold a direct-AD step against the replay step of the same scene."""
        rel = abs(ad_loss.item() - loss0.item()) / loss0.item()
        print(f"  ad vs replay: loss {ad_loss.item():.6f} vs {loss0.item():.6f} (rel {rel:.3g})")
        if not rel <= 2e-3:
            raise AssertionError("the direct-AD and replay losses disagree")
        for key in ("tex_color", "mat_emission"):
            a, b = ad_grads[key], replay_grads[key]
            nd = ((a - b).abs().max() / max(b.abs().max().item(), 1e-6)).item()
            print(f"  {key}: max normalized diff ad vs replay {nd:.3g}")
            if not nd <= 5e-3:
                raise AssertionError(f"{key}: direct-AD and replay gradients disagree")

    sd, cp = scene.build(), scene.scene_cam.params()
    # replay_grads is held against the direct-AD step (main path 4).
    params, loss0, replay_grads, step_ms = replay_steps(
        sd, cp, "book1", "megakernel_record", "megakernel_walk_record")

    opt_keys = ("tex_color", "mat_emission")
    tparams = dict(params, **{k: params[k].clone().requires_grad_(True) for k in opt_keys})
    step = grad.make_train_step(
        torch.optim.Adam([tparams[k] for k in opt_keys], lr=0.05), **kw)
    zero_counts()
    losses = []
    for i in range(3):
        loss, ms = host_ms(lambda: step(tparams, sd, cp, target, pix, 0))
        losses.append(loss.item())
        print(f"  train step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s, "
              f"loss {losses[-1]:.6f}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"Adam steps did not lower the loss: {losses}")
    read_counts("train steps", ("megakernel_record", "replay_backward"))

    # One step under the profiler: device time by kernel, against the
    # median timed step's wall time.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def profile_step(what, fn, wall, kernel_key=None):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        rows = sorted(
            (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
            key=lambda e: -e.self_device_time_total,
        )
        total = sum(e.self_device_time_total for e in rows) / 1e3
        print(f"profile of one {what}: {total:.2f} ms in {sum(e.count for e in rows)} "
              f"kernel launches = {100 * total / wall:.1f}% of the median step's {wall:.1f} ms")
        for e in rows[:10]:
            print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:4d}x  {e.key[:70]}")
        if kernel_key is not None:
            keys = (kernel_key,) if isinstance(kernel_key, str) else kernel_key
            mine = sum(e.self_device_time_total for e in rows
                       if any(k in e.key for k in keys)) / 1e3
            print(f"  {'/'.join(keys)}: {mine:.2f} ms = {100 * mine / total:.1f}% of the step's "
                  f"device time, {100 * mine / wall:.1f}% of its wall time")

    profile_step("loss_and_grad step",
                 lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw),
                 sorted(step_ms)[1])
    del tparams, step

    # --- main path 3: the staged forward render (garden, pixel schedule) ------
    mark('main path 3: the staged forward render (garden, pixel schedule)')
    scene = demo.garden_skybox(width=1920)
    gsd, gcp = scene.build(), scene.scene_cam.params()
    if integrator.megakernel_supported(gsd, gcp) or not integrator.fused_supported(gsd):
        raise AssertionError("auto would not take the pixel schedule for garden")
    mk.zero_counts()
    ss.LAUNCHES = 0
    img, ms = host_ms(lambda: render.render_image(scene, samples=32, max_depth=50))
    launches_k9, launches_k1 = ss.LAUNCHES, mk.FORWARD_LAUNCHES["brute"]
    if tuple(img.shape) != (1080, 1920, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"garden image: shape {tuple(img.shape)} or non-finite values")
    if launches_k9 < 1 or launches_k1 != 0:
        raise AssertionError(f"garden: K9 launched {launches_k9}, K1 {launches_k1} times")
    print(f"render_image garden 1920x1080 32spp d50 (auto -> pixel): {ms / 1e3:.3f} s, "
          f"{1920 * 1080 * 32 / ms / 1e3:.2f} Mrays/s, mean {img.mean().item():.5f}, "
          f"K9 launches {launches_k9}, K1 launches {launches_k1}; nvidia-smi: {smi()}")
    png = REPO / "build" / "chip_smoke_garden.png"
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")
    kernels["sphere_shade"]["launches"] = launches_k9
    del img

    # --- main path 4: the direct-AD gradient step, 1920x1080, 4 spp, depth 8 ----
    mark('main path 4: the direct-AD gradient step, 1920x1080, 4 spp, depth 8')
    akw = dict(kw, method="ad")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sh.LAUNCHES = 0
    (ad_loss, ad_grads), ms = host_ms(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **akw))
    check_grads(ad_loss, ad_grads, sd, cp)
    print(f"loss_and_grad(method='ad') 1920x1080 4spp d8, warm step: {ms / 1e3:.3f} s, "
          f"loss {ad_loss.item():.6f}")
    ad_ms = []
    for i in range(3):
        (ad_loss, ad_grads), ms = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **akw))
        check_grads(ad_loss, ad_grads, sd, cp)
        ad_ms.append(ms)
        print(f"  ad step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s")
    launches_k10 = sh.LAUNCHES
    print(f"  nvidia-smi: {smi()}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K10 launches {launches_k10}")
    if launches_k10 < 1:
        raise AssertionError("the direct-AD steps did not launch K10")
    kernels["sphere_hit"]["launches"] = launches_k10
    ad_vs_replay(ad_loss, ad_grads, loss0, replay_grads)
    del ad_grads, replay_grads
    profile_step("direct-AD step",
                 lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **akw),
                 sorted(ad_ms)[1], kernel_key="sphere_hit")
    del params

    # --- main path 5: the big-scene forward render (n7744, the walk) ------------
    mark('main path 5: the big-scene forward render (n7744, the walk)')
    scene = demo.sphere_stress(width=1920, copies=16)
    _, ms = host_ms(lambda: scene.build())  # the host-side SAH build, cached
    mk.zero_counts()
    img, ms_render = host_ms(lambda: render.render_image(scene, samples=32, max_depth=50))
    launches_k5, launches_k1 = mk.FORWARD_LAUNCHES["walk"], mk.FORWARD_LAUNCHES["brute"]
    if tuple(img.shape) != (1080, 1920, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"stress image: shape {tuple(img.shape)} or non-finite values")
    if launches_k5 != 1 or launches_k1 != 0:
        raise AssertionError(f"stress: K5 launched {launches_k5}, K1 {launches_k1} times")
    print(f"render_image sphere_stress n7744 1920x1080 32spp d50 (auto -> mega, walk): "
          f"{ms_render / 1e3:.3f} s, {1920 * 1080 * 32 / ms_render / 1e3:.2f} Mrays/s, "
          f"mean {img.mean().item():.5f}, K5 launches {launches_k5}, K1 launches "
          f"{launches_k1}; scene build {ms / 1e3:.3f} s; nvidia-smi: {smi()}")
    png = REPO / "build" / "chip_smoke_stress.png"
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")
    kernels["megakernel_walk"]["launches"] = launches_k5
    del img

    # --- main path 6: the big-scene gradient step (n1936), 1080p 4 spp d8 -------
    mark('main path 6: the big-scene gradient step (n1936), 1080p 4 spp d8')
    scene = demo.sphere_stress(width=1920, copies=4)
    sd, cp = scene.build(), scene.scene_cam.params()
    if sd.sph_perm is None or not replay._use_replay_kernel(sd):
        raise AssertionError("sphere_stress n1936 should take the walk and the replay kernels")
    params, loss0, replay_grads, step_ms = replay_steps(
        sd, cp, "sphere_stress n1936", "megakernel_walk_record", "megakernel_record")
    profile_step("sphere_stress n1936 loss_and_grad step",
                 lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw),
                 sorted(step_ms)[1])
    torch.cuda.empty_cache()
    (ad_loss, ad_grads), ms = host_ms(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **akw))
    check_grads(ad_loss, ad_grads, sd, cp)
    print(f"loss_and_grad(method='ad') sphere_stress n1936 1920x1080 4spp d8: "
          f"{ms / 1e3:.3f} s")
    ad_vs_replay(ad_loss, ad_grads, loss0, replay_grads)
    del params, ad_grads, replay_grads
    for name, n in counts.items():
        kernels[name]["launches"] = n

    # --- main path 7: the forward render in motion (K8) -------------------------
    mark('main path 7: the forward render in motion (K8)')
    def motion_launches():
        f = mk.FORWARD_LAUNCHES
        return dict(k1=f["brute"], k5=f["walk"], k8=f["motion"], k8_walk=f["motion_walk"],
                    k6=f["cull"], k7=f["tri"], k7m=f["tri_motion"], k9=ss.LAUNCHES)

    def zero_motion_launches():
        mk.zero_counts()
        ss.LAUNCHES = 0

    scene = bouncing_book1(demo, 1920)
    sd, cp = scene.build(), scene.scene_cam.params()
    if not integrator.megakernel_supported(sd, cp):
        raise AssertionError("auto would not take the megakernel for bouncing book1")
    zero_motion_launches()
    img, ms = host_ms(lambda: render.render_image(scene, samples=32, max_depth=50))
    got = motion_launches()
    if tuple(img.shape) != (1080, 1920, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"bouncing image: shape {tuple(img.shape)} or non-finite values")
    if got["k8"] != 1 or got["k1"] != 0:
        raise AssertionError(f"bouncing book1: launches {got}")
    print(f"render_image bouncing book1 1920x1080 32spp d50 (auto -> mega, K8): "
          f"{ms / 1e3:.3f} s, {1920 * 1080 * 32 / ms / 1e3:.2f} Mrays/s, mean "
          f"{img.mean().item():.5f}; K8 {main_ms:.1f} ms by CUDA events, bound "
          f"{main_b:.3f} ms ({main_by}); launches {got}; nvidia-smi: {smi()}")
    png = REPO / "build" / "chip_smoke_bounce.png"
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")
    del img
    launches_k8 = got["k8"]

    sc = demo.sphere_stress(width=320, copies=4)
    sc.cam_translate_y(0.5, 1.0 / 48.0, "lerp", "local", "from")
    zero_motion_launches()
    img, ms = host_ms(lambda: render.render_image(sc, samples=8, max_depth=50))
    got = motion_launches()
    if not bool(torch.isfinite(img).all()) or got["k8_walk"] != 1 or got["k5"] != 0:
        raise AssertionError(f"sphere_stress with a moving camera: launches {got}")
    print(f"render_image sphere_stress n1936 320w 8spp d50, moving camera (mega, the "
          f"walk in K8): {ms:.1f} ms; launches {got}")
    launches_k8 += got["k8_walk"]

    # --- main path 8: movies through render_movie --------------------------------
    mark('main path 8: movies through render_movie')
    with tempfile.TemporaryDirectory() as tmp:
        movie = demo.first_movie(duration=0.25)  # 15 s cut to 6 frames
        frames = {}
        zero_motion_launches()
        out, ms = host_ms(lambda: render.render_movie(
            movie, str(Path(tmp) / "first_movie"), verbose=False,
            on_frame=lambda fi, dt: frames.__setitem__(fi, dt)))
        got = motion_launches()
        written = sorted(p.name for p in (Path(tmp) / "first_movie" / "artifacts").iterdir())
        if sorted(frames) != list(range(6)) or len(written) != 6:
            raise AssertionError(f"first_movie: frames {sorted(frames)}, files {written}")
        if got["k9"] < 1 or got["k1"] or got["k8"]:
            raise AssertionError(f"first_movie: launches {got}")
        print(f"render_movie first_movie(duration=0.25) 400x225 50spp d5, 6 frames "
              f"(pixel schedule): {ms / 1e3:.3f} s, {ms / 6e3:.3f} s per frame "
              f"(dispatch to written: {', '.join(f'{frames[i]:.3f}' for i in range(6))} s); "
              f"launches {got}; -> {Path(out).name}")
        kernels["sphere_shade"]["launches"] += got["k9"]

        movie = bouncing_book1(demo, 1920)
        movie.duration = 2 / 24
        movie.scene_cam.set_samples(32)
        frames = {}
        zero_motion_launches()
        out, ms = host_ms(lambda: render.render_movie(
            movie, str(Path(tmp) / "bouncing"), verbose=False,
            on_frame=lambda fi, dt: frames.__setitem__(fi, dt)))
        got = motion_launches()
        if sorted(frames) != [0, 1] or got["k8"] != 2 or got["k1"]:
            raise AssertionError(f"bouncing movie: frames {sorted(frames)}, launches {got}")
        print(f"render_movie bouncing book1 1920x1080 32spp d50, 2 frames (frame 1 past "
              f"the keyframe): {ms / 1e3:.3f} s, {ms / 2e3:.3f} s per frame (dispatch to "
              f"written: {', '.join(f'{frames[i]:.3f}' for i in range(2))} s); launches {got}")
        launches_k8 += got["k8"]
        movie.scene_cam.frame = 0
        zero_motion_launches()
        movie_cells = dict(bouncing_frame=frame_phases(movie, dev, "bouncing book1 movie",
                                                       old_writer=True))
        if motion_launches()["k8"] != 1:
            raise AssertionError(f"bouncing movie frame: launches {motion_launches()}")
        launches_k8 += 1
    kernels["megakernel_motion"]["launches"] = launches_k8
    print("movie cells: " + json.dumps(movie_cells))

    # --- main path 9: gradients of moving scenes, big tables and the HDR sky --
    mark('main path 9: gradients of moving scenes, big tables and the HDR sky')
    # Each through grad.loss_and_grad(method="auto") at 1920x1080, 4 spp, d8:
    # bouncing book1 (K8 record, the eager replay), sphere_stress n7744 (the
    # record walk K5, the eager replay above the kernels' 2048 rows) and
    # garden (K2 record, the eager replay under the spherical sky).
    def grad_launches():
        r = mk.RECORD_LAUNCHES
        return dict(k2=r["brute"], k5=r["walk"], k8=r["motion"], k8_walk=r["motion_walk"],
                    k6=r["cull"], k7=r["tri"], k7m=r["tri_motion"], k4=rk.LAUNCHES_FORWARD,
                    k3=rk.LAUNCHES_BACKWARD)

    def check_leaves(loss, grads, params, what):
        if not math.isfinite(loss.item()):
            raise AssertionError(f"{what}: non-finite loss")
        for key in grad.leaf_keys(params):
            g = grads[key]
            if g.shape != params[key].shape or not bool(g.isfinite().all()):
                raise AssertionError(f"{what}: gradient {key} has a bad shape or is non-finite")

    def eager_steps(sd, cp, what, record, timed=2):
        """A warm and ``timed`` timed loss_and_grad steps; ``record`` the
        record kernel that must launch, and K3 / K4 must not (the eager
        replay). -> (params, warm loss, warm gradients, step ms, peak GiB)."""
        params = grad.extract_params(sd, cp)
        torch.cuda.empty_cache()
        zero_counts()
        torch.cuda.reset_peak_memory_stats()
        (loss0, grads), ms = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw))
        check_leaves(loss0, grads, params, what)
        print(f"loss_and_grad {what} 1920x1080 4spp d8 (auto -> replay, eager), warm step: "
              f"{ms / 1e3:.3f} s, loss {loss0.item():.6f}")
        step_ms = []
        for i in range(timed):
            (loss, g), ms = host_ms(
                lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw))
            check_leaves(loss, g, params, what)
            step_ms.append(ms)
            print(f"  step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s")
        peak = torch.cuda.max_memory_allocated() / 2**30
        got = grad_launches()
        print(f"  nvidia-smi: {smi()}; peak memory {peak:.2f} GiB; launches {got}")
        if got[record] < 1 or got["k3"] or got["k4"]:
            raise AssertionError(f"{what}: launches {got}")
        return params, loss0, grads, step_ms, peak

    def split_step(sd, cp, params, what):
        """One step cut into its phases, each synchronized: ray generation,
        the record kernel, the eager replay's forward (with the loss) and
        its backward."""
        leaves = {k: params[k].detach().requires_grad_(True) for k in grad.leaf_keys(params)}
        sd2, cp2 = grad.apply_params(sd, cp, {**params, **leaves})
        pl, sl = grad._lanes(pix, spp, 0)
        (o, d, _), t_rays = host_ms(lambda: generate_rays(cp2, w, h, pl, sl, 0))
        rec, t_rec = host_ms(lambda: replay.trace_record_mega(sd2, cp2, w, h, pl, sl, 0, 8))

        def forward():
            rad = replay.trace_replay(sd2, o, d, pl, sl, 0, 8, rec)
            return torch.mean((rad.reshape(spp, -1, 3).mean(dim=0) - target) ** 2)

        loss, t_fwd = host_ms(forward)
        _, t_bwd = host_ms(lambda: torch.autograd.grad(loss, list(leaves.values()),
                                                       allow_unused=True))
        total = t_rays + t_rec + t_fwd + t_bwd
        print(f"  {what} step by phase: ray generation {t_rays:.1f} ms, record {t_rec:.1f} ms, "
              f"replay forward {t_fwd:.1f} ms, replay backward {t_bwd:.1f} ms "
              f"(sum {total:.1f} ms)")
        return dict(rays=t_rays, record=t_rec, forward=t_fwd, backward=t_bwd)

    w, h, spp = 1920, 1080, 4
    grad_cells = {}
    scene = bouncing(1920)
    sd, cp = scene.build(), scene.scene_cam.params()
    if replay._use_replay_kernel(sd) or not (sd.animated and cp.animated):
        raise AssertionError("bouncing book1 should move and take the eager replay")
    params, loss0, _, step_ms, peak = eager_steps(sd, cp, "bouncing book1", "k8")
    launches_k8r = mk.RECORD_LAUNCHES["motion"]
    zero_counts()
    rec, ms = host_ms(lambda: grad.record_decisions(sd, cp, pix, 0, **kw))
    print(f"record_decisions bouncing book1 1920x1080 4spp d8: {ms / 1e3:.4f} s")
    frozen_ms = []
    for i in range(2):
        (loss, g), ms = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec, **kw))
        check_leaves(loss, g, params, "bouncing book1 frozen")
        frozen_ms.append(ms)
        print(f"  frozen step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s, "
              f"loss {loss.item():.6f}")
    if not torch.equal(loss, loss0):
        raise AssertionError("the frozen step's loss is not the fused step's")
    got = grad_launches()
    if got["k8"] != 1 or got["k3"] or got["k4"]:
        raise AssertionError(f"bouncing book1 frozen steps: launches {got}")
    launches_k8r += got["k8"]
    del rec, g
    phases = split_step(sd, cp, params, "bouncing book1")
    profile_step("bouncing book1 loss_and_grad step",
                 lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw),
                 sorted(step_ms)[0], kernel_key=("indexFunc", "index_add"))
    grad_cells["bouncing"] = dict(step_ms=step_ms, frozen_ms=frozen_ms, peak_gib=peak,
                                  phases=phases)
    kernels["megakernel_motion_record"]["launches"] = launches_k8r
    del params

    scene = demo.sphere_stress(width=1920, copies=16)
    sd, cp = scene.build(), scene.scene_cam.params()
    if replay._use_replay_kernel(sd) or sd.sph_perm is None:
        raise AssertionError("sphere_stress n7744 should walk and take the eager replay")
    params, _, _, step_ms, peak = eager_steps(sd, cp, "sphere_stress n7744", "k5")
    kernels["megakernel_walk_record"]["launches"] += mk.RECORD_LAUNCHES["walk"]
    phases = split_step(sd, cp, params, "sphere_stress n7744")
    grad_cells["n7744"] = dict(step_ms=step_ms, peak_gib=peak, phases=phases)
    del params

    scene = demo.garden_skybox(width=1920)
    sd, cp = scene.build(), scene.scene_cam.params()
    if replay._use_replay_kernel(sd) or sd.sky_image is None:
        raise AssertionError("garden should take the eager replay with the sky image a leaf")
    params, _, grads, step_ms, peak = eager_steps(sd, cp, "garden", "k2")
    if not grads["sky_image"].abs().sum().item() > 0:
        raise AssertionError("garden: the sky image's gradient is zero")
    kernels["megakernel_record"]["launches"] += mk.RECORD_LAUNCHES["brute"]
    phases = split_step(sd, cp, params, "garden")
    grad_cells["garden"] = dict(step_ms=step_ms, peak_gib=peak, phases=phases)
    del params, grads

    # The eager replay against direct AD on the card, 320x180, 2 spp, d8.
    def pool8(g):
        return torch.nn.functional.avg_pool2d(g.permute(2, 0, 1)[None], 8)[0]

    def sky_texel_flips(params, sd, cp, kw_small):
        """The texels read, bounce by bounce, by a lane whose nearest sky
        texel differs between the replay and direct AD, and the count of
        such lookups: each forward's sky lookups are read through the lookup
        itself on an image of texel indices."""
        image = sd.sky_image
        hh, ww = image.shape[:2]
        ids = torch.arange(hh * ww, dtype=torch.float32, device=image.device)
        ids = ids.reshape(hh, ww, 1).expand(hh, ww, 3)
        lookup = skybox.radiance
        texels = {}
        for method in ("replay", "ad"):
            calls = texels[method] = []

            def spy(kind, img, d, calls=calls):
                if kind == skybox.SPHERICAL:
                    calls.append(lookup(kind, ids, d)[:, 0].long())
                return lookup(kind, img, d)

            skybox.radiance = spy
            try:
                with torch.no_grad():
                    grad.render_pixels_mean(params, sd, cp, pix_small, seed=0, method=method,
                                            **kw_small)
            finally:
                skybox.radiance = lookup
        flips, lanes = [], 0
        for tr, ta in zip(texels["replay"], texels["ad"]):
            moved = tr != ta
            lanes += int(moved.sum())
            flips += [tr[moved], ta[moved]]
        return torch.cat(flips).unique(), lanes

    kw_small = dict(width=320, height=180, spp=2, max_depth=8)
    pix_small = torch.arange(320 * 180, device=dev)
    target_small = torch.zeros((320 * 180, 3), device=dev)
    for what, sc in (("bouncing book1", bouncing(320)), ("garden", demo.garden_skybox(width=320))):
        sd, cp = sc.build(), sc.scene_cam.params()
        params = grad.extract_params(sd, cp)
        (lr, gr), ms_r = host_ms(lambda: grad.loss_and_grad(
            params, sd, cp, target_small, pix_small, 0, **kw_small))
        (la, ga), ms_a = host_ms(lambda: grad.loss_and_grad(
            params, sd, cp, target_small, pix_small, 0, method="ad", **kw_small))
        rel = abs(la.item() - lr.item()) / lr.item()
        print(f"replay vs direct AD, {what} 320x180 2spp d8: loss {lr.item():.6f} vs "
              f"{la.item():.6f} (rel {rel:.3g}); {ms_r:.1f} vs {ms_a:.1f} ms")
        if not rel <= 2e-3:
            raise AssertionError(f"{what}: the replay and direct-AD losses disagree")
        for key in ("tex_color", "mat_emission") + (("sky_image",) if what == "garden" else ()):
            a, b = ga[key], gr[key]
            scale = max(b.abs().max().item(), 1e-6)
            nd = ((a - b).abs().max() / scale).item()
            print(f"  {key}: max normalized diff ad vs replay {nd:.3g}")
            if key == "sky_image":
                # The nearest texel, floor(u W), is a choice the record does
                # not hold: where the two estimators' directions differ in
                # their last ulps a lane on a texel border lands on the
                # neighbour. The texels such lanes read are left out, every
                # other texel is held on its own.
                flipped, lanes = sky_texel_flips(params, sd, cp, kw_small)
                per_texel = (a - b).abs().amax(dim=-1).reshape(-1) / scale
                kept = torch.ones_like(per_texel, dtype=torch.bool)
                kept[flipped] = False
                nd = per_texel[kept].max().item()
                pooled = ((pool8(a) - pool8(b)).abs().max() / scale).item()
                print(f"  {key}: {lanes} sky lookups chose another texel, {flipped.numel()} "
                      f"texels left out of {per_texel.numel()} ({int((b != 0).any(-1).sum())} "
                      f"nonzero); max normalized diff per kept texel {nd:.3g}, over "
                      f"8x8-texel blocks {pooled:.3g}")
            if not nd <= 5e-3:
                raise AssertionError(f"{what} {key}: direct-AD and replay gradients disagree")
    del params, ga, gr

    # --- main path 10: the mesh forward render (K7), torus_teapot 1080p ---------
    mark('main path 10: the mesh forward render (K7), torus_teapot 1080p')
    scene = torus_teapot(tscene, 1920)
    _, build_ms = host_ms(lambda: scene.build())  # the host-side lowering and SAH, cached
    sd, cp = scene.build(), scene.scene_cam.params()
    if not (sd.use_bvh and sd.num_tris == 6320 and integrator.megakernel_supported(sd, cp)):
        raise AssertionError("torus_teapot should be a BVH mesh that auto sends to mega")
    launches_k7 = 0
    for i in range(2):
        zero_motion_launches()
        img, ms = host_ms(lambda: render.render_image(scene, samples=32, max_depth=50))
        got = motion_launches()
        if tuple(img.shape) != (1080, 1920, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"torus image: shape {tuple(img.shape)} or non-finite values")
        if got["k7"] != 1 or any(got[k] for k in ("k1", "k5", "k8", "k8_walk", "k7m", "k9")):
            raise AssertionError(f"torus_teapot: launches {got}")
        launches_k7 += got["k7"]
        print(f"render_image torus_teapot 1920x1080 32spp d50 (auto -> mega, K7), run {i}: "
              f"{ms / 1e3:.3f} s, {1920 * 1080 * 32 / ms / 1e3:.2f} Mrays/s, mean "
              f"{img.mean().item():.5f}; launches {got}; nvidia-smi: {smi()}")
    print(f"  torus_teapot scene build (6,320 triangles, leaf {sd.bvh_leaf_size}, "
          f"{sd.bvh_min.shape[0]} nodes): {build_ms / 1e3:.3f} s")
    png = REPO / "build" / "chip_smoke_torus.png"
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")
    kernels["megakernel_tri"]["launches"] = launches_k7
    del img

    # --- main path 11: the mesh's gradient, 1920x1080, 4 spp, depth 8 -----------
    mark("main path 11: the mesh's gradient, 1920x1080, 4 spp, depth 8")
    # loss_and_grad(method="auto") -> the replay: K7 record, then the eager
    # replay's triangle branch (the replay kernels take no triangles).
    if replay._use_replay_kernel(sd) or not integrator.megakernel_record_supported(sd, cp):
        raise AssertionError("torus_teapot should record through K7 and replay eagerly")
    params, loss0, _, step_ms, peak = eager_steps(sd, cp, "torus_teapot", "k7")
    launches_k7r = mk.RECORD_LAUNCHES["tri"]
    zero_counts()
    rec, ms = host_ms(lambda: grad.record_decisions(sd, cp, pix, 0, **kw))
    print(f"record_decisions torus_teapot 1920x1080 4spp d8: {ms / 1e3:.4f} s")
    (loss, g), ms = host_ms(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec, **kw))
    check_leaves(loss, g, params, "torus_teapot frozen")
    print(f"  frozen step: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s, "
          f"loss {loss.item():.6f}")
    if not torch.equal(loss, loss0):
        raise AssertionError("torus_teapot: the frozen step's loss is not the recorded step's")
    got = grad_launches()
    if got["k7"] != 1 or got["k3"] or got["k4"]:
        raise AssertionError(f"torus_teapot frozen step: launches {got}")
    launches_k7r += got["k7"]
    del rec, g
    phases = split_step(sd, cp, params, "torus_teapot")
    grad_cells["torus_teapot"] = dict(step_ms=step_ms, frozen_ms=[ms], peak_gib=peak,
                                      phases=phases)
    kernels["megakernel_tri_record"]["launches"] = launches_k7r
    del params
    # --- main path 12: the moving mesh forward (K7 moving), frame 30, 1080p ----
    mark('main path 12: the moving mesh forward (K7 moving), frame 30, 1080p')
    def forward_runs(scene, sd, what):
        """Two timed render_image runs of a moving mesh at 1920x1080 32 spp
        d50, each one K7 moving launch ("tri_motion" on the scene's moving
        (M, 32) rows, ``sd`` the scene's build) and no other -> (last image,
        ms, launches counted)."""
        runs, launched = [], 0
        for i in range(2):
            zero_motion_launches()
            img, ms = host_ms(lambda: render.render_image(scene, samples=32, max_depth=50))
            got = motion_launches()
            if tuple(img.shape) != (1080, 1920, 3) or not bool(torch.isfinite(img).all()):
                raise AssertionError(f"{what}: shape {tuple(img.shape)} or non-finite values")
            if (got["k7m"] != 1 or any(n for k, n in got.items() if k != "k7m")
                    or not integrator.mesh_moves(sd)):
                raise AssertionError(f"{what}: launches {got}, the mesh moves: "
                                     f"{integrator.mesh_moves(sd)}")
            launched += got["k7m"]
            runs.append(ms)
            print(f"render_image {what} 1920x1080 32spp d50 (auto -> mega), run {i}: "
                  f"{ms / 1e3:.3f} s, {1920 * 1080 * 32 / ms / 1e3:.2f} Mrays/s, mean "
                  f"{img.mean().item():.5f}; launches {got}; nvidia-smi: {smi()}")
        return img, runs, launched

    scene = mt_sc
    scene.scene_cam.image_width = 1920
    scene.scene_cam.frame = 30
    _, build_ms = host_ms(lambda: scene.build())
    sd, cp = scene.build(), scene.scene_cam.params()
    if not (integrator.mesh_moves(sd) and sd.use_bvh and not cp.animated
            and integrator.megakernel_supported(sd, cp)):
        raise AssertionError("moving torus_teapot should be a moving BVH mesh sent to mega")
    img, fwd_runs, launches_k7m = forward_runs(scene, sd, "moving torus_teapot frame 30")
    print(f"  moving torus_teapot scene build at frame 30 (18,960 vertex timelines, leaf "
          f"{sd.bvh_leaf_size}, {sd.bvh_min.shape[0]} nodes): {build_ms / 1e3:.3f} s")
    png = REPO / "build" / "chip_smoke_moving_torus.png"
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")
    del img
    mesh_cells = dict(forward_ms=fwd_runs, build_ms=build_ms)

    # --- main path 13: the moving mesh movie, 400x225 50 spp d5, 6 frames ------
    mark('main path 13: the moving mesh movie, 400x225 50 spp d5, 6 frames')
    movie = moving_torus_teapot(tscene, 400)
    movie.duration = 0.25  # 5 s cut to 6 frames
    frame_build = []
    for fi in range(6):
        movie.scene_cam.frame = fi
        frame_build.append(host_ms(lambda: movie.build())[1])
    print(f"moving torus_teapot scene build per movie frame: "
          f"{', '.join(f'{b / 1e3:.3f}' for b in frame_build)} s")
    movie.scene_cam.frame = 3
    mesh_cells["movie_builders"] = builder_ab(movie, dev, "moving torus_teapot")
    zero_motion_launches()
    mesh_cells["movie_frame"] = frame_phases(movie, dev, "moving torus_teapot movie")
    if motion_launches()["k7m"] != 1:
        raise AssertionError(f"moving torus frame: launches {motion_launches()}")
    launches_k7m += 1
    movie_runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for run in range(2):
            frames = {}
            zero_motion_launches()
            _, ms = host_ms(lambda: render.render_movie(
                movie, str(Path(tmp) / f"moving_torus{run}"), verbose=False,
                on_frame=lambda fi, dt: frames.__setitem__(fi, dt)))
            got = motion_launches()
            written = sorted(p.name for p in
                             (Path(tmp) / f"moving_torus{run}" / "artifacts").iterdir())
            if sorted(frames) != list(range(6)) or len(written) != 6:
                raise AssertionError(f"moving torus movie: frames {sorted(frames)}, {written}")
            if got["k7m"] != 6 or any(n for k, n in got.items() if k != "k7m"):
                raise AssertionError(f"moving torus movie: launches {got}")
            launches_k7m += got["k7m"]
            movie_runs.append(ms)
            print(f"render_movie moving torus_teapot(duration=0.25) 400x225 50spp d5, 6 "
                  f"frames, run {run}: {ms / 1e3:.3f} s, {ms / 6e3:.3f} s per frame (dispatch "
                  f"to written: {', '.join(f'{frames[i]:.3f}' for i in range(6))} s); "
                  f"launches {got}")
    mesh_cells.update(movie_ms=movie_runs, movie_build_ms=frame_build)
    del movie

    # --- main path 14: the moving mesh's gradient, 1080p 4 spp d8, frame 30 -----
    mark("main path 14: the moving mesh's gradient, 1080p 4 spp d8, frame 30")
    # loss_and_grad(method="auto") -> the replay: K7 moving record, then the
    # eager replay's moving-triangle branch (the replay kernels take no
    # triangles).
    if (replay._use_replay_kernel(sd) or not integrator.megakernel_record_supported(sd, cp)
            or not integrator.mesh_moves(sd)):
        raise AssertionError("moving torus_teapot should record through K7 moving, replay eagerly")
    params, loss0, _, step_ms, peak = eager_steps(sd, cp, "moving torus_teapot", "k7m")
    launches_k7mr = mk.RECORD_LAUNCHES["tri_motion"]
    zero_counts()
    rec, ms = host_ms(lambda: grad.record_decisions(sd, cp, pix, 0, **kw))
    print(f"record_decisions moving torus_teapot 1920x1080 4spp d8: {ms / 1e3:.4f} s")
    (loss, g), ms = host_ms(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec, **kw))
    check_leaves(loss, g, params, "moving torus_teapot frozen")
    print(f"  frozen step: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s, "
          f"loss {loss.item():.6f}")
    if not torch.equal(loss, loss0):
        raise AssertionError("moving torus_teapot: the frozen step's loss is not the step's")
    got = grad_launches()
    if got["k7m"] != 1 or any(n for k, n in got.items() if k != "k7m"):
        raise AssertionError(f"moving torus_teapot frozen step: launches {got}")
    launches_k7mr += got["k7m"]
    del rec, g
    phases = split_step(sd, cp, params, "moving torus_teapot")
    grad_cells["moving_torus_teapot"] = dict(step_ms=step_ms, frozen_ms=[ms], peak_gib=peak,
                                             phases=phases)
    del params

    # --- main path 15: the moving mesh seen by a rising camera (K7 moving +
    # K8's camera), frame 30, 1080p 32 spp d50 -----------------------------------
    mark("main path 15: the moving mesh seen by a rising camera")
    rising_camera(scene)
    sd, cp = scene.build(), scene.scene_cam.params()
    if not (cp.animated and integrator.megakernel_supported(sd, cp)):
        raise AssertionError("moving torus_teapot with a rising camera should go to mega")
    img, cam_runs, launched = forward_runs(
        scene, sd, "moving torus_teapot + rising camera frame 30")
    launches_k7m += launched
    mesh_cells.update(camera_forward_ms=cam_runs)
    del img
    kernels["megakernel_tri_moving"]["launches"] = launches_k7m
    kernels["megakernel_tri_moving_record"]["launches"] = launches_k7mr
    print("moving mesh cells: " + json.dumps(mesh_cells))

    # --- main path 16: the animated big scene (K6), bouncing stress n7744 --------
    mark('main path 16: the animated big scene (K6), bouncing stress n7744')
    scene = bouncing_stress(demo, 1920, 16)
    # Timelines, the JAX lowering's clusters and K6's swept tree; cached.
    _, build_ms = host_ms(lambda: scene.build())
    sd, cp = scene.build(), scene.scene_cam.params()
    if not (sd.animated and cp.animated and sd.sph_swept_nodes is not None
            and sd.sph_center.shape[0] == 7744 and integrator.megakernel_supported(sd, cp)):
        raise AssertionError("bouncing stress n7744 should move, with its swept tree, "
                             "and go to mega")
    cull_cells = dict(build_ms=build_ms, forward_ms=[])
    launches_k6 = 0
    for i in range(2):
        zero_motion_launches()
        img, ms = host_ms(lambda: render.render_image(scene, samples=32, max_depth=50))
        got = motion_launches()
        if tuple(img.shape) != (1080, 1920, 3) or not bool(torch.isfinite(img).all()):
            raise AssertionError(f"bouncing stress: shape {tuple(img.shape)} or non-finite")
        if got["k6"] != 1 or any(n for k, n in got.items() if k != "k6"):
            raise AssertionError(f"bouncing stress: launches {got}")
        launches_k6 += got["k6"]
        cull_cells["forward_ms"].append(ms)
        print(f"render_image bouncing stress n7744 1920x1080 32spp d50 (auto -> mega, K6), "
              f"run {i}: {ms / 1e3:.3f} s, {1920 * 1080 * 32 / ms / 1e3:.2f} Mrays/s, mean "
              f"{img.mean().item():.5f}; launches {got}; nvidia-smi: {smi()}")
    print(f"  bouncing stress n7744 scene build (7,744 rows, {sd.sph_cbounds.shape[0]} "
          f"clusters, a swept tree of {sd.sph_swept_nodes.shape[0]} nodes): "
          f"{build_ms / 1e3:.3f} s")
    png = REPO / "build" / "chip_smoke_bounce_stress.png"
    write_png(png, render.to_u8(img))
    print(f"wrote {png.relative_to(REPO)}")
    del img

    # --- main path 17: its movie, 400x225 50 spp d5, 2 frames ----------------------
    mark('main path 17: its movie, 400x225 50 spp d5, 2 frames')
    movie = bouncing_stress(demo, 400, 16)
    movie.duration = 2 / 24
    movie.scene_cam.set_samples(50)
    movie.scene_cam.set_max_depth(5)
    # Each frame's scene build, and the parts of it that the swept tree
    # (K6's) and the JAX lowering's clusters (kept for parity) take.
    frame_build, tree_ms, clusters_ms = [], [], []
    real_swept, real_clusters = mk.swept_tables, mk.cluster_spheres

    def timed(fn, into):
        def call(*args, **kwargs):
            out, ms = host_ms(lambda: fn(*args, **kwargs))
            into.append(ms)
            return out
        return call

    mk.swept_tables = timed(real_swept, tree_ms)
    mk.cluster_spheres = timed(real_clusters, clusters_ms)
    try:
        for fi in range(2):
            movie.scene_cam.frame = fi
            frame_build.append(host_ms(lambda: movie.build())[1])
    finally:
        mk.swept_tables, mk.cluster_spheres = real_swept, real_clusters
    if len(tree_ms) != 2 or len(clusters_ms) != 2:
        raise AssertionError(f"bouncing stress movie: {len(tree_ms)} swept trees and "
                             f"{len(clusters_ms)} clusterings for 2 frames")
    # The swept tree of frame 0 by each builder, on the same arrays.
    movie.scene_cam.frame = 0
    fsd = movie.build()
    tree_args = [fsd.sph_center.cpu().numpy(), fsd.sph_radius.cpu().numpy(),
                 fsd.sph_active.cpu().numpy(), fsd.sph_center_d.cpu().numpy(),
                 fsd.sph_radius_d.cpu().numpy()]
    native_tree, native_tree_ms = host_ms(lambda: mk.swept_tables(*tree_args))
    with python_builder("bouncing stress swept tree") as built:
        plain_tree, python_tree_ms = host_ms(lambda: mk.swept_tables(*tree_args))
    if not all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(native_tree, plain_tree)):
        raise AssertionError("bouncing stress: the native and Python swept trees differ")
    print(f"bouncing stress n7744 swept tree, frame 0: native builder {native_tree_ms:.1f} ms, "
          f"Python builder {python_tree_ms:.1f} ms ({built[0]} Python trees), the same "
          f"tables bit for bit")
    cull_cells["movie_tree_builders"] = dict(native_ms=native_tree_ms,
                                             python_ms=python_tree_ms)
    cull_cells["movie_builders"] = builder_ab(movie, dev, "bouncing stress n7744")
    del fsd
    per_frame = []
    real_render = render.render_image_data

    def counted(*args, **kwargs):
        """render_image_data, its launches read per frame."""
        before = motion_launches()
        out = real_render(*args, **kwargs)
        per_frame.append({k: n - before[k] for k, n in motion_launches().items() if n - before[k]})
        return out

    with tempfile.TemporaryDirectory() as tmp:
        frames = {}
        zero_motion_launches()
        render.render_image_data = counted
        try:
            _, ms = host_ms(lambda: render.render_movie(
                movie, str(Path(tmp) / "bounce_stress"), verbose=False,
                on_frame=lambda fi, dt: frames.__setitem__(fi, dt)))
        finally:
            render.render_image_data = real_render
    if sorted(frames) != [0, 1] or len(per_frame) != 2 or per_frame[0] != {"k6": 1} or not all(
            f in ({"k6": 1}, {"k5": 1}) for f in per_frame):
        raise AssertionError(f"bouncing stress movie: frames {sorted(frames)}, launches "
                             f"by frame {per_frame}")
    launches_k6 += sum(f.get("k6", 0) for f in per_frame)
    cull_cells.update(movie_ms=ms, movie_build_ms=frame_build, movie_tree_ms=tree_ms,
                      movie_clusters_ms=clusters_ms, movie_launches=per_frame)
    print(f"render_movie bouncing stress n7744 400x225 50spp d5, 2 frames: {ms / 1e3:.3f} s, "
          f"{ms / 2e3:.3f} s per frame (dispatch to written: "
          f"{', '.join(f'{frames[i]:.3f}' for i in range(2))} s); scene build per frame "
          f"{', '.join(f'{b / 1e3:.3f}' for b in frame_build)} s, of which the swept tree "
          f"{', '.join(f'{b / 1e3:.3f}' for b in tree_ms)} s and the clusters "
          f"{', '.join(f'{b / 1e3:.3f}' for b in clusters_ms)} s; launches by frame "
          f"{per_frame}")
    movie.scene_cam.frame = 0
    zero_motion_launches()
    cull_cells["movie_frame"] = frame_phases(movie, dev, "bouncing stress movie")
    if motion_launches()["k6"] != 1:
        raise AssertionError(f"bouncing stress frame: launches {motion_launches()}")
    launches_k6 += 1
    kernels["megakernel_cull"]["launches"] = launches_k6
    del movie

    # --- main path 18: its gradient, 1920x1080, 4 spp, depth 8, every pixel -------
    mark('main path 18: its gradient, 1920x1080, 4 spp, depth 8, every pixel')
    # loss_and_grad(method="auto") -> the replay: K6 record, then the eager
    # replay (records hold original ids; the replay kernels take no motion).
    if replay._use_replay_kernel(sd) or not integrator.megakernel_record_supported(sd, cp):
        raise AssertionError("bouncing stress n7744 should record through K6, replay eagerly")
    params, loss0, _, step_ms, peak = eager_steps(sd, cp, "bouncing stress n7744", "k6")
    launches_k6r = mk.RECORD_LAUNCHES["cull"]
    if any(n for k, n in grad_launches().items() if k != "k6"):
        raise AssertionError(f"bouncing stress step: launches {grad_launches()}")
    zero_counts()
    rec, ms = host_ms(lambda: grad.record_decisions(sd, cp, pix, 0, **kw))
    print(f"record_decisions bouncing stress n7744 1920x1080 4spp d8: {ms / 1e3:.4f} s")
    (loss, g), ms = host_ms(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec, **kw))
    check_leaves(loss, g, params, "bouncing stress frozen")
    print(f"  frozen step: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s, "
          f"loss {loss.item():.6f}")
    if not torch.equal(loss, loss0):
        raise AssertionError("bouncing stress: the frozen step's loss is not the step's")
    got = grad_launches()
    if got["k6"] != 1 or any(n for k, n in got.items() if k != "k6"):
        raise AssertionError(f"bouncing stress frozen step: launches {got}")
    launches_k6r += got["k6"]
    del rec, g
    phases = split_step(sd, cp, params, "bouncing stress n7744")
    grad_cells["bouncing_stress"] = dict(step_ms=step_ms, frozen_ms=[ms], peak_gib=peak,
                                         phases=phases)
    kernels["megakernel_cull_record"]["launches"] = launches_k6r
    del params

    # --- main path 19: cross-checks on n1936 -------------------------------------
    mark('main path 19: cross-checks on n1936')
    # The replay against direct AD on the card, 320x180, 2 spp, d8.
    sc = bouncing_stress(demo, 320, 4)
    sd, cp = sc.build(), sc.scene_cam.params()
    params = grad.extract_params(sd, cp)
    (lr, gr), ms_r = host_ms(lambda: grad.loss_and_grad(
        params, sd, cp, target_small, pix_small, 0, **kw_small))
    (la, ga), ms_a = host_ms(lambda: grad.loss_and_grad(
        params, sd, cp, target_small, pix_small, 0, method="ad", **kw_small))
    rel = abs(la.item() - lr.item()) / lr.item()
    print(f"replay vs direct AD, bouncing stress n1936 320x180 2spp d8: loss {lr.item():.6f} "
          f"vs {la.item():.6f} (rel {rel:.3g}); {ms_r:.1f} vs {ms_a:.1f} ms")
    if not rel <= 2e-3:
        raise AssertionError("bouncing stress: the replay and direct-AD losses disagree")
    for key in radiometric:
        nd = ((ga[key] - gr[key]).abs().max() / max(gr[key].abs().max().item(), 1e-6)).item()
        print(f"  {key}: max normalized diff ad vs replay {nd:.3g}")
        if not nd <= 5e-3:
            raise AssertionError(f"bouncing stress {key}: direct-AD and replay gradients disagree")
    del params, ga, gr
    # The card against the CPU at 64 wide, 2 spp, d8: the records lane by
    # lane, and from the card's records the step on both devices. The card's
    # sinf / cosf round unlike the CPU's (PERF.md section 6), which
    # flips the odd grazing lane of this dense field (5 of 4608 lanes on an
    # H100, 0.99891 against bouncing book1's 0.99935). So the records are held
    # exactly, on every lane, with the CPU's plain version taking the card's
    # sin and cos, the one arithmetic the two devices round differently; with
    # each device's own they must agree on > 0.998 of the lanes, below both
    # readings, so that a drop in agreement still fails.
    def card_trig(fn):
        """fn() with torch.sin and torch.cos of CPU tensors computed on the
        card."""
        real = {name: getattr(torch, name) for name in ("sin", "cos")}

        def on_card(f):
            return lambda x, *a, **k: (f(x.to(dev), *a, **k).cpu()
                                       if isinstance(x, torch.Tensor) and x.device == cpu
                                       else f(x, *a, **k))

        for name, f in real.items():
            setattr(torch, name, on_card(f))
        try:
            return fn()
        finally:
            for name, f in real.items():
                setattr(torch, name, f)

    sc = bouncing_stress(demo, 64, 4)
    kw64 = dict(width=64, height=36, spp=2, max_depth=8)
    inputs = []
    for where in (dev, cpu):
        sd, cp = sc.build(device=where), sc.scene_cam.params(device=where)
        pix64 = torch.arange(64 * 36, device=where)
        inputs.append((sd, cp, pix64, grad.record_decisions(sd, cp, pix64, 0, **kw64)))
    rec_card, rec_cpu = inputs[0][3], inputs[1][3]
    same = (rec_card.cpu() == rec_cpu).all(dim=0).float().mean().item()
    sd, cp, pix64, _ = inputs[1]
    rec_trig = card_trig(lambda: grad.record_decisions(sd, cp, pix64, 0, **kw64))
    exact = (rec_card.cpu() == rec_trig).all(dim=0).float().mean().item()
    print(f"loss_and_grad bouncing stress n1936 64w 2spp d8, card vs CPU: records equal on "
          f"{same:.5f} of the lanes; with the CPU taking the card's sin and cos, on {exact:.5f}")
    if exact != 1.0 or not same > 0.998:
        raise AssertionError("bouncing stress: the card's and the CPU's records disagree")
    frozen = []
    for sd, cp, pix64, _ in inputs:
        frozen.append(grad.loss_and_grad(
            grad.extract_params(sd, cp), sd, cp, torch.zeros((64 * 36, 3), device=pix64.device),
            pix64, 0, rec=rec_card.to(pix64.device), **kw64))
    held_to("bouncing stress on the card's records", frozen,
            dict.fromkeys(radiometric, 1e-3), 1e-4)
    cull_cells.update(records_equal=same, records_equal_card_trig=exact)
    del inputs, frozen
    print("bouncing stress cells: " + json.dumps(cull_cells))

    # --- main path 20: the depth-50 gradient (paths A-F) -------------------------
    def deep_launches():
        r = mk.RECORD_LAUNCHES
        return dict(k2=r["brute"], k8=r["motion"], k4=rk.LAUNCHES_FORWARD,
                    k3=rk.LAUNCHES_BACKWARD, k4_legacy=rk.LAUNCHES_LEGACY_FORWARD,
                    k3_legacy=rk.LAUNCHES_LEGACY_BACKWARD)

    def expect_launches(what, need, never):
        got = deep_launches()
        print(f"  {what} launches: {got}")
        for name in need:
            if got[name] < 1:
                raise AssertionError(f"{what} did not launch {name}")
        for name in never:
            if got[name]:
                raise AssertionError(f"{what} launched {name}")
        deep_counts.update({k: deep_counts.get(k, 0) + v for k, v in got.items()})
        return got

    def norm_diff(a, b):
        return ((a - b).abs().max() / max(b.abs().max().item(), 1e-6)).item()

    def hold_grads(what, got, want, bound_nd):
        for key in radiometric:
            nd = norm_diff(got[key], want[key])
            print(f"    {key}: max normalized diff {nd:.3g} (held at {bound_nd:g})")
            if not nd <= bound_nd:
                raise AssertionError(f"{what} {key}: gradients disagree")

    def hold_loss(what, got, want, rel_max):
        rel = abs(got.item() - want.item()) / want.item()
        print(f"  {what}: loss {got.item():.8f} vs {want.item():.8f} (rel {rel:.3g}, held at "
              f"{rel_max:g})")
        if not rel <= rel_max:
            raise AssertionError(f"{what}: losses disagree")

    def phased(fn, full):
        """fn() with each ray generation, record pass and replay backward
        synchronized and timed: -> (result, wall ms, {phase: ms}); the rest
        is the compaction, the gathers, the index_adds and the loss."""
        ms = dict.fromkeys(("rays", "head record", "narrow re-record", "bucket rays",
                            "replay backward", "compaction, gathers, index_add, loss"), 0.0)
        real = (replay.generate_rays, replay.trace_record_mega, rk.replay_backward,
                rk.replay_legacy_backward)

        def timed(fn, key):
            def wrapper(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                ms[key(a)] += 1e3 * (time.perf_counter() - t0)
                return out
            return wrapper

        replay.generate_rays = timed(
            real[0], lambda a: "rays" if a[3].shape[0] == full else "bucket rays")
        replay.trace_record_mega = timed(
            real[1], lambda a: "head record" if a[4].shape[0] == full else "narrow re-record")
        rk.replay_backward = timed(real[2], lambda a: "replay backward")
        rk.replay_legacy_backward = timed(real[3], lambda a: "replay backward")
        try:
            out, total = host_ms(fn)
        finally:
            (replay.generate_rays, replay.trace_record_mega, rk.replay_backward,
             rk.replay_legacy_backward) = real
        ms["compaction, gathers, index_add, loss"] = total - sum(ms.values())
        return out, total, ms

    deep_counts = {}
    deep_cells = {}
    w, h, spp = 1920, 1080, 4
    pix = torch.arange(w * h, device=dev)
    target = torch.zeros((w * h, 3), device=dev)
    kw50 = dict(width=w, height=h, spp=spp, max_depth=50)
    mrays = w * h * spp / 1e6
    scene = demo.book1_end_scene(width=1920)
    sd, cp = scene.build(), scene.scene_cam.params()
    params = grad.extract_params(sd, cp)

    mark('main path 20A: the deep chunk, book1 1920x1080, 4 spp, d50, default split')
    torch.cuda.empty_cache()
    mk.zero_counts()
    rk.zero_counts()
    torch.cuda.reset_peak_memory_stats()
    (loss_a, grads_a), ms = host_ms(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw50))
    check_leaves(loss_a, grads_a, params, "deep chunk")
    print(f"loss_and_grad book1 1920x1080 4spp d50 (two-level record, buckets), warm: "
          f"{ms / 1e3:.3f} s, loss {loss_a.item():.8f}")
    step_ms = []
    for i in range(2):
        (loss, g), ms = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw50))
        if not torch.equal(loss, loss_a):
            raise AssertionError("deep chunk: the loss changed between calls")
        step_ms.append(ms)
        print(f"  step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s")
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    print(f"  nvidia-smi: {smi()}; peak memory {peak_a:.2f} GiB")
    expect_launches("deep chunks (3)", ("k2", "k3"), ("k4", "k4_legacy", "k3_legacy", "k8"))
    _, ms_ph, phases = phased(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw50), w * h * spp)
    print(f"  deep chunk by phase ({ms_ph:.1f} ms, synchronized): "
          + ", ".join(f"{k} {v:.1f} ms" for k, v in phases.items()))
    pl, sl = grad._lanes(pix, spp, 0)
    lims, divs = replay._bucket_spec(50)
    rec_h, rec_n, idx_n, valid_n, n_deep = replay.record_two_level(
        sd, cp, w, h, pl, sl, 0, 50, head=lims[0])
    depth_n = ((rec_n & 1) > 0).sum(0)
    fills = []
    for j in range(1, len(lims)):
        in_b = valid_n & (depth_n > lims[j - 1]) & (depth_n <= lims[j])
        fills.append(dict(rows=lims[j], lanes=int(in_b.sum()),
                          capacity=replay._capacity(pl.shape[0], divs[j], rec_n.shape[1])))
    print(f"  capacities: n_deep {int(n_deep)} of r_n {rec_n.shape[1]} narrow slots "
          f"({int(n_deep) / pl.shape[0]:.4%} of {pl.shape[0]} lanes); buckets "
          + ", ".join(f"rows {f['rows']}: {f['lanes']} / {f['capacity']}" for f in fills))
    r_n = rec_n.shape[1]
    del rec_h, rec_n, idx_n, valid_n, depth_n, in_b
    torch.cuda.reset_peak_memory_stats()
    rk.zero_counts()
    (loss_u, grads_u), ms_u = host_ms(
        lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, grad_split=False, **kw50))
    peak_u = torch.cuda.max_memory_allocated() / 2**30
    print(f"  split=False on the same lanes: {ms_u / 1e3:.4f} s, "
          f"{mrays / (ms_u / 1e3):.2f} Mrays/s, peak {peak_u:.2f} GiB")
    hold_loss("split vs unsplit", loss_a, loss_u, 1e-5)
    hold_grads("split vs unsplit", grads_a, grads_u, 1e-4)
    deep_cells["A"] = dict(step_ms=step_ms, peak_gib=peak_a, phases=phases,
                           n_deep=int(n_deep), r_n=r_n, buckets=fills, unsplit_ms=ms_u,
                           unsplit_peak_gib=peak_u)
    del grads_u

    mark('main path 20B: loss_and_grad_accum 1920x1080, 500 spp, d50, 125 chunks of 4')
    ladder = []
    real_recovering = grad.loss_and_grad_recovering

    def counting(*a, **k):
        ladder.append(k.get("sample0"))
        return real_recovering(*a, **k)

    grad.loss_and_grad_recovering = counting
    torch.cuda.empty_cache()
    mk.zero_counts()
    rk.zero_counts()
    torch.cuda.reset_peak_memory_stats()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss_b, grads_b = grad.loss_and_grad_accum(
            params, sd, cp, target, pix, 0, width=w, height=h, spp=500, max_depth=50,
            chunk_spp=4, recover=True)
        loss_b_host = loss_b.item()
        s_b = time.perf_counter() - t0
    finally:
        grad.loss_and_grad_recovering = real_recovering
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    finite = {k: bool(grads_b[k].isfinite().all()) for k in grad.TENSOR_KEYS}
    print(f"loss_and_grad_accum book1 1920x1080 500spp d50 (chunk_spp 4, recover): "
          f"{s_b:.3f} s to the loss on the host, {w * h * 500 / s_b / 1e6:.2f} Mrays/s, "
          f"{s_b / 125 * 1e3:.1f} ms a chunk, peak {peak_b:.2f} GiB, loss {loss_b_host:.8f}; "
          f"chunks up the ladder: {len(ladder)} {ladder}; gradients finite: {finite}")
    print(f"  nvidia-smi: {smi()}")
    if not math.isfinite(loss_b_host) or not all(finite.values()):
        raise AssertionError("the 500 spp budget gave a non-finite loss or gradient")
    expect_launches("500 spp budget", ("k2", "k3"), ("k4", "k4_legacy", "k3_legacy", "k8"))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            grad.loss_and_grad(params, sd, cp, target, pix, 0, sample0=4, **kw50)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{Path(c.filename).name}:{c.lineno}" for c in caught
             if "synchroniz" in str(c.message)]
    sites = {site: syncs.count(site) for site in dict.fromkeys(syncs)}
    print(f"  host syncs of one chunk (torch.cuda.set_sync_debug_mode): {len(syncs)} {sites}")
    deep_cells["B"] = dict(s=s_b, mrays_s=w * h * 500 / s_b / 1e6, peak_gib=peak_b,
                           ladder=len(ladder), syncs_per_chunk=len(syncs), sync_sites=sites)
    del grads_b

    mark('main path 20D: frozen deep decisions, record_decisions d50 + replay_bucketed')
    mk.zero_counts()
    rk.zero_counts()
    rec50, ms_rec = host_ms(lambda: grad.record_decisions(sd, cp, pix, 0, **kw50))
    print(f"record_decisions book1 1920x1080 4spp d50: {ms_rec / 1e3:.4f} s, records "
          f"{tuple(rec50.shape)} ({nbytes(rec50) / 1e6:.0f} MB)")
    frozen_ms = []
    for i in range(2):
        (loss_d, grads_d), ms = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec50, **kw50))
        check_leaves(loss_d, grads_d, params, "frozen deep chunk")
        frozen_ms.append(ms)
        print(f"  frozen deep step {i}: {ms / 1e3:.4f} s, {mrays / (ms / 1e3):.2f} Mrays/s, "
              f"loss {loss_d.item():.8f}")
    expect_launches("frozen deep steps", ("k2", "k4", "k3"), ("k4_legacy", "k3_legacy", "k8"))
    (loss_du, grads_du), ms_du = host_ms(lambda: grad.loss_and_grad(
        params, sd, cp, target, pix, 0, rec=rec50, grad_split=False, **kw50))
    print(f"  frozen unsplit on the same records: {ms_du / 1e3:.4f} s")
    # Like for like (the replay's primal on both sides): the issue's bound.
    hold_loss("frozen bucketed vs frozen unsplit", loss_d, loss_du, 1e-5)
    hold_grads("frozen bucketed vs frozen unsplit", grads_d, grads_du, 1e-4)
    # Against the inline chunk, whose primal is the record kernel's fused
    # radiance: on the card K2 and K4 round alike (on the CPU their plain
    # versions differ by rel 2.3e-4 at 64w, glass chains amplifying).
    hold_loss("frozen vs inline chunk", loss_d, loss_a, 1e-5)
    deep_cells["D"] = dict(record_ms=ms_rec, frozen_ms=frozen_ms, unsplit_ms=ms_du,
                           rel_inline=abs(loss_d.item() - loss_a.item()) / loss_a.item())
    del grads_du

    mark('main path 20C: the legacy layout on the deep path, CRUCIBLE_REPLAY_BLOCKED=0')
    os.environ["CRUCIBLE_REPLAY_BLOCKED"] = "0"
    try:
        mk.zero_counts()
        rk.zero_counts()
        (loss_c, grads_c), ms_c = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, **kw50))
        print(f"loss_and_grad deep chunk, legacy layout: {ms_c / 1e3:.4f} s, "
              f"{mrays / (ms_c / 1e3):.2f} Mrays/s")
        expect_launches("legacy deep chunk", ("k2", "k3_legacy"), ("k3", "k4", "k4_legacy"))
        mk.zero_counts()
        rk.zero_counts()
        (loss_cf, grads_cf), ms_cf = host_ms(
            lambda: grad.loss_and_grad(params, sd, cp, target, pix, 0, rec=rec50, **kw50))
        print(f"  frozen deep step, legacy layout: {ms_cf / 1e3:.4f} s")
        expect_launches("legacy frozen deep step", ("k4_legacy", "k3_legacy"), ("k3", "k4"))
    finally:
        del os.environ["CRUCIBLE_REPLAY_BLOCKED"]
    if not (torch.equal(loss_c, loss_a) and torch.equal(loss_cf, loss_d)):
        raise AssertionError("the legacy layout changed the deep chunk's loss")
    for what, got_c, want_c in (("chunk", grads_c, grads_a), ("frozen", grads_cf, grads_d)):
        same = {k: torch.equal(got_c[k], want_c[k]) for k in grad.TENSOR_KEYS}
        print(f"  legacy vs blocked {what}: loss equal; gradients bit for bit: {same}")
        # The legacy pair's lane cotangents are K3's bit for bit, handed on
        # (R, 3) and contiguous: every leaf, the camera's too, is the same.
        if not all(same.values()):
            raise AssertionError(f"legacy {what}: gradients differ from the blocked pair's")
    deep_cells["C"] = dict(chunk_ms=ms_c, frozen_ms=ms_cf)
    del rec50, grads_a, grads_c, grads_d, grads_cf

    mark('main path 20E: recovery and resume, the mirror shell (32x32, 2 spp, d16)')

    def mirror_shell(light=False):
        sc = tscene.Scene.new_image(1.0, 32)
        sc.scene_cam.look_from((0, 0, 0))
        sc.scene_cam.look_at((0, 0, -1))
        sc.scene_cam.set_vfov(60.0)
        sc.add_element(tscene.Sphere((0, 0, 0), 10.0, tscene.Metal((0.9, 0.9, 0.9), 0.0)),
                       "shell")
        if light:
            sc.add_element(tscene.Sphere((0, 0, -3), 0.6, tscene.Emissive((2.0, 1.5, 1.0))),
                           "light")
        return sc

    msc = mirror_shell()
    msd, mcp = msc.build(), msc.scene_cam.params()
    mkw = dict(width=32, height=32, spp=2, max_depth=16)
    mpix, mtarget = torch.arange(32 * 32, device=dev), torch.zeros((32 * 32, 3), device=dev)
    mparams = grad.extract_params(msd, mcp)
    l0, _ = grad.loss_and_grad(mparams, msd, mcp, mtarget, mpix, 0, **mkw)
    if math.isfinite(l0.item()):
        raise AssertionError("the mirror shell's default chunk did not poison")
    l1, g1 = grad.loss_and_grad_recovering(mparams, msd, mcp, mtarget, mpix, 0, **mkw)
    l2, g2 = grad.loss_and_grad(mparams, msd, mcp, mtarget, mpix, 0, grad_split=False, **mkw)
    same = torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k]) for k in grad.TENSOR_KEYS)
    print(f"mirror shell: default chunk loss {l0.item()}; recovered {l1.item():.8f}, "
          f"split=False {l2.item():.8f}, bit for bit: {same}")
    if not same:
        raise AssertionError("the ladder's value is not split=False's")
    la, ga = grad.loss_and_grad_accum(mparams, msd, mcp, mtarget, mpix, 0, width=32,
                                      height=32, spp=2, max_depth=16, chunk_spp=1)
    if not (math.isfinite(la.item()) and all(bool(ga[k].isfinite().all())
                                             for k in grad.TENSOR_KEYS)):
        raise AssertionError("loss_and_grad_accum(chunk_spp=1) did not recover")
    print(f"  loss_and_grad_accum chunk_spp=1 recovered: loss {la.item():.8f}")
    lsc = mirror_shell(light=True)
    lsd, lcp = lsc.build(), lsc.scene_cam.params()
    opt_keys = ("tex_color", "mat_emission")

    def adam_run(p0, steps, first, state=None):
        p = dict(p0, **{k: p0[k].detach().clone().requires_grad_(True) for k in opt_keys})
        opt = torch.optim.Adam([p[k] for k in opt_keys], lr=2e-2)
        if state is not None:
            opt.load_state_dict(state)
        step = grad.make_train_step(opt, 32, 32, 2, 16, recover=True)
        losses = [step(p, lsd, lcp, mtarget, mpix, first + i).item() for i in range(steps)]
        return p, opt, losses

    p_full, _, l_full = adam_run(grad.extract_params(lsd, lcp), 3, 0)
    p_part, opt, l_part = adam_run(grad.extract_params(lsd, lcp), 1, 0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ckpt.npz"
        grad.save_checkpoint(ckpt, p_part, opt, step=1)
        loaded, state, step0 = grad.load_checkpoint(ckpt, device=dev)
    p_res, _, l_res = adam_run(loaded, 2, step0, state)
    resumed = l_part + l_res == l_full and all(
        torch.equal(p_res[k].detach(), p_full[k].detach()) for k in grad.TENSOR_KEYS)
    print(f"  3 recovering Adam steps {l_full}; 1 + checkpoint + 2 {l_part + l_res}; "
          f"bit for bit: {resumed}")
    if not resumed or not l_full[-1] < l_full[0]:
        raise AssertionError("the resumed run differs from the uninterrupted one, or the "
                             "loss did not go down")
    deep_cells["E"] = dict(losses=l_full)

    mark('main path 20F: the eager deep replay, bouncing book1 320w, 4 spp, d50')
    scene = bouncing_book1(demo, 320)
    bsd, bcp = scene.build(), scene.scene_cam.params()
    if replay._use_replay_kernel(bsd):
        raise AssertionError("bouncing book1 should take the eager replay")
    bparams = grad.extract_params(bsd, bcp)
    bkw = dict(width=320, height=180, spp=4, max_depth=50)
    bpix, btarget = torch.arange(320 * 180, device=dev), torch.zeros((320 * 180, 3), device=dev)
    mk.zero_counts()
    rk.zero_counts()
    (lf, gf), ms_f = host_ms(lambda: grad.loss_and_grad(bparams, bsd, bcp, btarget, bpix, 0, **bkw))
    expect_launches("eager deep chunk", ("k8",), ("k2", "k3", "k4", "k3_legacy", "k4_legacy"))
    (lfu, gfu), ms_fu = host_ms(lambda: grad.loss_and_grad(
        bparams, bsd, bcp, btarget, bpix, 0, grad_split=False, **bkw))
    print(f"loss_and_grad bouncing book1 320w 4spp d50 (K8 two-level record, eager buckets): "
          f"{ms_f / 1e3:.4f} s; split=False {ms_fu / 1e3:.4f} s")
    hold_loss("eager split vs unsplit", lf, lfu, 1e-5)
    hold_grads("eager split vs unsplit", gf, gfu, 1e-4)
    deep_cells["F"] = dict(split_ms=ms_f, unsplit_ms=ms_fu)
    kernels["megakernel_record"]["launches"] += deep_counts["k2"]
    kernels["megakernel_motion_record"]["launches"] += deep_counts["k8"]
    kernels["replay_forward"]["launches"] += deep_counts["k4"]
    kernels["replay_backward"]["launches"] += deep_counts["k3"]
    kernels["replay_legacy_forward"]["launches"] = deep_counts["k4_legacy"]
    kernels["replay_legacy_backward"]["launches"] = deep_counts["k3_legacy"]
    print("deep cells: " + json.dumps(deep_cells))
    print("deep path launches: " + json.dumps(deep_counts))

    # --- main path 21: image textures and nested checkers, the record schedule -
    textured = textured_path(dev, kernels, mark)
    print("textured cells: " + json.dumps(textured))

    # --- main path 22: the command line ------------------------------------------
    print("cli cells: " + json.dumps(cli_path(dev, kernels, mark)))

    # --- main path 23: a mesh beside a big sphere table ----------------------------
    print("mesh walk cells: " + json.dumps(mesh_walk_path(dev, kernels, mark)))

    # --- main path 24: the staged record -------------------------------------------
    print("staged record cells: " + json.dumps(staged_record_path(dev, kernels, mark)))

    # --- main path 25: sharded renders and gradients ---------------------------------
    print("sharded cells: " + json.dumps(sharded_path(dev, kernels, mark)))

    # --- main path 26: exact-time motion ----------------------------------------------
    print("exact cells: " + json.dumps(exact_path(dev, kernels, mark)))

    # --- main path 27: the golden check ---------------------------------------------
    print("golden cells: " + json.dumps(golden_path(dev, kernels, mark)))

    # --- main path 28: the pixel schedule by stage -------------------------------------
    print("pixel profile cells: " + json.dumps(pixel_profile_path(dev, kernels, mark)))

    print("gradient cells: " + json.dumps(grad_cells))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s after the card check")

    print(card)
    standard = ("source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
                "bound_ms", "bound_by")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", **{key: k[key] for key in standard},
         # No one PyTorch call computes any of these functions.
         "library_ms": None,
         **{key: v for key, v in k.items() if key not in standard}}
        for name, k in kernels.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
