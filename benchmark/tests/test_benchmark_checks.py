"""The check that decides ``correct``: a whole run of each cell, driven
here on the CPU at a tiny size (the look for a card skipped), comes out
correct as the program is, and not correct with the timed path broken
underneath or with the bfloat16 control in the program's place. The card
test reads the control at the cells' own sizes on three seeds."""

import json
import time

import pytest

from harness import core, manifest

SMALL = dict(width=32, height=18, samples_per_pixel=2, max_depth=4, check_pixels=128,
             rerecord=3)
RENDER = ("rtiow_book1.render", "rttnw_bouncing.render")
FIT = ("rtiow_book1.fit", "rttnw_bouncing.fit")


def _run(cell, fault=None, control=False, seed=2**31 + 17):
    run = core.Run(cell=manifest.cell(cell), seed=seed, seconds=0.3, traced=False,
                   device="cpu", fault=fault, control=control, overrides=SMALL)
    return core.execute(run, time.perf_counter())


@pytest.mark.parametrize("cell", RENDER + FIT)
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    names = {m["name"] for m in manifest.cell(cell).end_to_end}
    assert set(res["metrics"]) == names
    assert list(res)[-1] == "checks"
    json.dumps(res)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in RENDER for f in ("stale", "half", "scaled")]
                         + [(c, f) for c in FIT
                            for f in ("unchanged", "half", "scaled", "stale_record", "window0")])
def test_fault_is_caught(cell, fault):
    res = _run(cell, fault=fault)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", FIT)
def test_fit_checks_window_steps(cell):
    """The fit's check follows a record step past the first epoch and the
    last step of an epoch, both drawn from the window."""
    run = core.Run(cell=manifest.cell(cell), seed=99, seconds=0.01, traced=False,
                   device="cpu", overrides=SMALL)
    res = core.execute(run, time.perf_counter())
    record, last = run.facts["checked_steps"]
    assert record >= 3 and record % 3 == 0 and last % 3 == 2
    assert res["attempted"] >= 2
    assert {"step_loss_gap", "step_change_gap"} <= set(res["checks"])


@pytest.mark.parametrize("cell", RENDER)
def test_render_window_keeps_only_the_checked(cell):
    """The window keeps ``check_renders`` images however many it renders,
    and judges every one for finite values."""
    run = core.Run(cell=manifest.cell(cell), seed=7, seconds=0.5, traced=False,
                   device="cpu", overrides=SMALL)
    res = core.execute(run, time.perf_counter())
    k = run.traffic["check_renders"]
    assert res["attempted"] > k and run.done == res["attempted"]
    assert len(run.checked) == k and res["failed"] == 0 and res["correct"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FIT for f in ("stale_record", "window0")])
def test_record_faults_fail_window_steps(cell, fault):
    """A skipped re-record, or every epoch on the first sample window,
    fails the window steps' numbers while the first steps read sound."""
    res = _run(cell, fault=fault)
    c = res["checks"]
    assert c["loss_gap"]["value"] <= c["loss_gap"]["limit"], c
    assert any(c[k]["value"] > c[k]["limit"] for k in ("step_loss_gap", "step_change_gap")), c


@pytest.mark.parametrize("cell", RENDER + FIT)
def test_control_is_caught(cell):
    res = _run(cell, control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", RENDER + FIT)
def test_control_fails_on_the_card(cell):
    """The control at the cell's own size on three seeds: every one
    incorrect. Decides inside the test whether there is a card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import controls

    lines = list(controls.readings(cell, [101, 102, 103], "control", 1.0))
    assert len(lines) == 3 and not any(line["correct"] for line in lines), lines
