"""flat_kernel_roofline: the search kernel's share of its roofline in the
renders (``csrc/megakernel.cu`` ``flat_kernel``, forward), in percent: the
least time the brute search of these renders needs at the published peaks
(``harness/workmodel.py``) over the device time of its launches. The path
segments searched are an estimate: the reference's count on its checked
pixels, scaled to the renders. A row that moves over the shutter costs
``MOTION_SEARCH_OPS``, one that stays put ``SEARCH_OPS``."""

from harness import workmodel


def read(run):
    tr, n, per_path = run.trace, run.facts.get("renders"), run.facts.get("searches_per_path")
    if tr is None or not n or not per_path:
        return None
    t = tr.kernel_s(r"\bflat_kernel\b")
    if t <= 0.0:
        return None
    paths = run.facts["paths_per_render"]
    moving = int((run.desc["center_d"] != 0).any(axis=1).sum())
    ops, nbytes = workmodel.forward_render(run.width * run.height, per_path * paths,
                                           len(run.desc["names"]) - moving, moving)
    return 100.0 * n * workmodel.bound_s(ops, nbytes) / t
