"""One process of ``tests/test_torch_distributed.py``'s process group:

    python -m tests.torch_dist_worker HOST:PORT WORLD RANK OUT_DIR

joins a ``gloo`` group through ``parallel.mesh.initialize_distributed``,
makes the default mesh (one position a process, on the CPU), renders book1
42 x 23 in bands (``render_image_sharded_mega``) and in pixel shards
(``render_image_sharded``), takes ``loss_and_grad_sharded`` on the smoke
scene 32 x 18, and writes what it got to ``OUT_DIR/rank<RANK>.pt``.
Imports no JAX."""

import sys

import torch
import torch.distributed as dist


def main(coordinator: str, world: int, rank: int, out_dir: str) -> None:
    from crucible_tpu_torch import grad as G
    from crucible_tpu_torch.models import demo
    from crucible_tpu_torch.parallel import mesh as pmesh
    from crucible_tpu_torch.parallel import render as prender

    torch.set_num_threads(1)
    pmesh.initialize_distributed(coordinator, world, rank)
    mesh = pmesh.make_mesh()
    book1 = demo.book1_end_scene(width=42)
    bands = prender.render_image_sharded_mega(book1, mesh, samples=2, max_depth=4)
    shards = prender.render_image_sharded(book1, mesh, samples=1, max_depth=3)
    smoke = demo.smoke_scene(width=32)
    sd, cp = smoke.build(device="cpu"), smoke.scene_cam.params(device="cpu")
    p = 32 * 18
    loss, grads = prender.loss_and_grad_sharded(
        G.extract_params(sd, cp), sd, cp, torch.zeros((p, 3)), torch.arange(p), 0, mesh=mesh,
        width=32, height=18, spp=2, max_depth=3)
    torch.save(dict(world=mesh.world, rank=mesh.rank, positions=list(mesh.local_positions()),
                    bands=bands, shards=shards, loss=loss, grads=G.leaves(grads)),
               f"{out_dir}/rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
