"""grad.launches: kernel launches a fit step on the device (every kernel
of the traced window over its steps)."""


def read(run):
    tr, steps = run.trace, run.facts.get("steps")
    if tr is None or not steps:
        return None
    return len(tr.kernels()) / steps
