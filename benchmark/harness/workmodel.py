"""The yardstick of the roofline shares: published peaks, and the work and
bytes each kernel's inputs need.

A frozen copy of the work model of ``chip_smoke.py`` (PEAK_FP32,
PEAK_BYTES, SEARCH_OPS, MOTION_SEARCH_OPS, CAM_OPS, ROW_OPS, SCATTER_OPS,
ADJOINT_ROW_OPS, ADJOINT_SCATTER_OPS and the byte counts behind the
bounds of K1, K3 and K4), as it stood in the commit that made the port's
first benchmark. The program may change; this copy changes only with the
benchmark, so that a share read before and after a change is read against
the same work.

A share is the least time the card could take, the larger of the
operations at the FP32 peak and the bytes moved once at the memory peak,
over the time the kernel took. The operations are what these inputs need
of a brute closest-hit search (every path segment against every table
row), whatever route the program takes; a route that does less than
brute work (a tree walk) can read above 100% and needs its own count.
"""

from __future__ import annotations

# Published peaks of one NVIDIA H100 SXM (data sheet, dense, no sparsity):
# FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12

# FP32 operations counted from the kernel sources (multiplies, adds,
# divides, square roots; compares and selects not counted).
SEARCH_OPS = 22  # one ray against one static table row in the closest-hit loop
MOTION_SEARCH_OPS = SEARCH_OPS + 18  # a row moving on the linear shutter
CAM_OPS = 81  # a moving camera's basis at a sample (no cell moves its camera yet)
ROW_OPS = 52  # a replayed row: quadratic, hit point, normal, unit d, radiance
SCATTER_OPS = 45  # a continuing row: albedo, the sampled direction, scatter
ADJOINT_ROW_OPS = 60  # the adjoint of a row's radiance and pass-through
ADJOINT_SCATTER_OPS = 150  # the adjoint of a continuing row's scatter

F32 = I32 = 4
TABLE_COLS = 32  # floats a sphere row of the program's table


def bound_s(ops: float, nbytes: float) -> float:
    """Least seconds: the larger of ``ops`` at PEAK_FP32 and ``nbytes`` at
    PEAK_BYTES."""
    return max(ops / PEAK_FP32, nbytes / PEAK_BYTES)


def forward_render(pixels: int, searches: float, static_rows: int,
                   moving_rows: int) -> tuple[float, float]:
    """(operations, bytes) of a whole-image render seen by a static camera:
    ``searches`` path segments, each against ``static_rows`` rows that stay
    put and ``moving_rows`` rows that move over the shutter; the table, a
    pixel and a first sample id a lane read, and the (3,) radiance sum a
    pixel written."""
    ops = searches * (static_rows * SEARCH_OPS + moving_rows * MOTION_SEARCH_OPS)
    nbytes = (static_rows + moving_rows) * TABLE_COLS * F32 + pixels * (2 * I32 + 3 * F32)
    return ops, nbytes


def replay_forward(rays: int, depth: int, rows: int, alive: float, cont: float):
    """(operations, bytes) of the replay forward (K4) over ``rays`` paths of
    ``depth`` record rows: ``alive`` replayed rows, ``cont`` of them
    continuing; reads the table, each ray's origin and direction, its pixel
    and sample ids and its records, writes its (3,) radiance."""
    ops = alive * ROW_OPS + cont * SCATTER_OPS
    nbytes = rows * TABLE_COLS * F32 + rays * (6 * F32 + 2 * I32 + depth * I32 + 3 * F32)
    return ops, nbytes


def replay_backward(rays: int, depth: int, rows: int, alive: float, cont: float):
    """(operations, bytes) of the replay's vector-Jacobian product (K3): the
    forward once, then the adjoint of every row; reads K4's inputs and the
    radiance cotangent, writes the table's and each ray's cotangents."""
    ops = (alive * (ROW_OPS + ADJOINT_ROW_OPS) + cont * (SCATTER_OPS + ADJOINT_SCATTER_OPS))
    nbytes = (2 * rows * TABLE_COLS * F32
              + rays * (6 * F32 + 2 * I32 + depth * I32 + 3 * F32 + 6 * F32))
    return ops, nbytes
