"""replay_kernels_roofline: the replay pair's share of its roofline in the
fit steps (``csrc/replay_kernel.cu``: the replay forward, K4, and its
vector-Jacobian product, K3, with its reduction), in percent: the least
time of one forward and one backward a step at the published peaks
(``harness/workmodel.py``; the rows replayed and continued counted by the
reference on the first step) over the device time of their launches."""

from harness import workmodel


def read(run):
    tr, steps = run.trace, run.facts.get("steps")
    alive, cont = run.facts.get("alive_per_ray"), run.facts.get("continued_per_ray")
    if tr is None or not steps or not alive:
        return None
    t = tr.kernel_s(r"\b(replay_forward|replay_backward|reduce_partials)\b")
    if t <= 0.0:
        return None
    rays = run.width * run.height * run.spp
    rows = len(run.desc["names"])
    b = (workmodel.bound_s(*workmodel.replay_forward(rays, run.depth, rows, alive * rays,
                                                     cont * rays))
         + workmodel.bound_s(*workmodel.replay_backward(rays, run.depth, rows, alive * rays,
                                                        cont * rays)))
    return 100.0 * steps * b / t
