"""The frozen work model's counts on given shapes."""

import pytest

from harness import workmodel as wm


def test_peaks():
    assert wm.PEAK_FP32 == 67e12 and wm.PEAK_BYTES == 3.35e12
    assert (wm.SEARCH_OPS, wm.MOTION_SEARCH_OPS, wm.CAM_OPS) == (22, 40, 81)
    assert (wm.ROW_OPS, wm.SCATTER_OPS, wm.ADJOINT_ROW_OPS, wm.ADJOINT_SCATTER_OPS) == (
        52, 45, 60, 150)


def test_bound_takes_the_larger():
    assert wm.bound_s(67e12, 0) == pytest.approx(1.0)
    assert wm.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert wm.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_forward_render():
    # book 1 at 1200x675: 3 segments a path of 500 spp against 484 static rows
    pixels, paths = 1200 * 675, 1200 * 675 * 500
    ops, nbytes = wm.forward_render(pixels, 3.0 * paths, 484, 0)
    assert ops == 3.0 * paths * 484 * 22
    assert nbytes == 484 * 32 * 4 + pixels * 20
    assert wm.bound_s(ops, nbytes) == pytest.approx(ops / 67e12)


def test_forward_render_moving_rows():
    # the bouncing spheres: 384 rows rise, the other 100 stay put
    pixels, searches = 400 * 225, 2.5 * 400 * 225 * 100
    ops, nbytes = wm.forward_render(pixels, searches, 100, 384)
    assert ops == searches * (100 * 22 + 384 * 40)
    assert nbytes == 484 * 32 * 4 + pixels * 20
    # below every row moving, above every row still
    assert wm.forward_render(pixels, searches, 484, 0)[0] < ops
    assert ops < wm.forward_render(pixels, searches, 0, 484)[0]


def test_replay_pair():
    rays, depth, rows = 1920 * 1080 * 4, 8, 484
    ops, nbytes = wm.replay_forward(rays, depth, rows, alive=2.5 * rays, cont=1.5 * rays)
    assert ops == 2.5 * rays * 52 + 1.5 * rays * 45
    assert nbytes == rows * 128 + rays * (24 + 8 + 32 + 12)
    ops_b, nbytes_b = wm.replay_backward(rays, depth, rows, alive=2.5 * rays, cont=1.5 * rays)
    assert ops_b == 2.5 * rays * 112 + 1.5 * rays * 195
    assert nbytes_b == nbytes + rows * 128 + rays * 24
    # both bound by the bytes at this shape
    assert wm.bound_s(ops, nbytes) == pytest.approx(nbytes / 3.35e12)
