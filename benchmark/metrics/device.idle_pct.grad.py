"""device.idle_pct.grad: the share of the traced fit window in which
no kernel, copy or fill ran on the device, in percent."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0.0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
