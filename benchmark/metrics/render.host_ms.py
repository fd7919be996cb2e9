"""render.host_ms: milliseconds a render in which the device ran nothing:
the traced window's wall time less its device-busy time, over the renders
(the forward entry, ``models/render.py``, on the host)."""


def read(run):
    tr, n = run.trace, run.facts.get("renders")
    if tr is None or not n:
        return None
    return 1e3 * (tr.window_s - tr.busy_s()) / n
