"""record.ms: device milliseconds of one decision record of the fit (the
record mode of ``csrc/megakernel.cu`` ``flat_kernel``, K2 for a static
scene), over the records of the traced window."""


def read(run):
    tr, records = run.trace, run.facts.get("records")
    if tr is None or not records:
        return None
    t = tr.kernel_s(r"\bflat_kernel\b")
    return 1e3 * t / records if t > 0.0 else None
