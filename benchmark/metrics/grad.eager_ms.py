"""grad.eager_ms: device milliseconds a fit step in kernels other than the
port's hand-written ones (``csrc/``: the flat loop, the replay pair and
its reduction, the closest-hit and hit-and-fetch kernels): the eager
replay, gathers, ``index_add``, the loss and Adam of ``grad.py`` and
``models/replay.py``."""

PORT_KERNELS = (r"\b(flat_kernel|replay_forward|replay_backward|reduce_partials"
                r"|sphere_hit|sphere_shade)\b")


def read(run):
    tr, steps = run.trace, run.facts.get("steps")
    if tr is None or not steps:
        return None
    return 1e3 * (tr.kernel_s() - tr.kernel_s(PORT_KERNELS)) / steps
