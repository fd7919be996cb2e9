"""Two processes over ``torch.distributed`` with the ``gloo`` backend on the
CPU (ROADMAP A9): each worker (``tests/torch_dist_worker.py``) joins the
group through ``parallel.mesh.initialize_distributed``, renders its band
and its pixel shard, and the shares meet with ``all_gather``; the
gradients of its pixel shard meet with ``all_reduce``. Every rank then
holds the image one process renders, bit for bit, and the loss and
gradients of one call within the sharded bounds of
``tests/test_torch_parallel.py``.

The workers run outside the repository's directory and get it on
``PYTHONPATH`` (ROADMAP C2: the JAX package's two-process test fails for
want of it), and each has a time limit, so that a hang fails the test
instead of stalling the suite."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from crucible_tpu_torch import grad as G
from crucible_tpu_torch.models import demo as tdemo
from crucible_tpu_torch.models import integrator as tint
from crucible_tpu_torch.models import render as trender
from tests.torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
TIMEOUT_S = 240


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Each rank's results, from two worker processes."""
    out = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]),
        OMP_NUM_THREADS="1")
    coordinator = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.torch_dist_worker", coordinator, str(WORLD), str(rank),
         str(out)], cwd=out, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for rank in range(WORLD)]
    logs = []
    try:
        for proc in procs:
            logs.append(proc.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    for rank, (proc, log) in enumerate(zip(procs, logs)):
        assert proc.returncode == 0, f"rank {rank} exited {proc.returncode}:\n{log[-4000:]}"
    return [torch.load(out / f"rank{rank}.pt") for rank in range(WORLD)]


def test_each_rank_renders_its_band(results):
    for rank, r in enumerate(results):
        assert (r["world"], r["rank"], r["positions"]) == (WORLD, rank, [rank])


def test_gathered_bands_equal_one_process(results):
    sc = tdemo.book1_end_scene(width=42)
    w, h = sc.scene_cam.image_width, sc.scene_cam.image_height
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    want = trender.render_image_persistent(sd, cp, w, h, 2, 4, sc.seed, device="cpu")
    for r in results:
        assert torch.equal(r["bands"], want)
    p = w * h
    rays = tint.render_rays(sd, cp, w, h, torch.arange(p), torch.zeros(p, dtype=torch.int64),
                            sc.seed, 3)
    for r in results:
        assert torch.equal(r["shards"], rays.reshape(h, w, 3))


def test_all_reduced_gradients_equal_one_call(results):
    sc = tdemo.smoke_scene(width=32)
    sd, cp = sc.build(device="cpu"), sc.scene_cam.params(device="cpu")
    p = 32 * 18
    want_l, want_g = G.loss_and_grad(G.extract_params(sd, cp), sd, cp, torch.zeros((p, 3)),
                                     torch.arange(p), 0, width=32, height=18, spp=2,
                                     max_depth=3)
    for r in results:
        assert abs(float(r["loss"]) - float(want_l)) <= 1e-6 * abs(float(want_l))
        for key, leaf in G.leaves(want_g).items():
            torch.testing.assert_close(r["grads"][key], leaf, rtol=1e-5, atol=1e-8, msg=key)
