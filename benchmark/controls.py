"""The readings the limits of ``benchmark/limits/<cell>.json`` are set from:
a cell's checks on several seeds in one process, of the program as it is
(``sound``), of the reference computed in bfloat16 in its place
(``control``), or of the program with a fault planted in its timed path
(``stale``, ``half``, ``scaled``: the renders; ``half``, ``scaled``,
``unchanged``, ``stale_record``, ``window0``: the fits; see the drivers).

    python3 benchmark/controls.py --workload rtiow_book1.render --mode control \
        --seeds 11,12,13 --seconds 2

One JSON line a seed: {"seed", "mode", "correct", "checks"}. The windows
are short (``--seconds``) and at the cell's own sizes; the benchmark's own
runs never take these modes.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import run  # noqa: E402,F401  (the caches and import paths of a run)
from harness import core, manifest  # noqa: E402

MODES = ("sound", "control", "stale", "half", "scaled", "unchanged", "stale_record", "window0")


def readings(workload: str, seeds, mode: str, seconds: float):
    """Yield {"seed", "mode", "correct", "checks", "attempted"} for each
    seed, on the card."""
    import torch

    cell = manifest.cell(workload)
    if not torch.cuda.is_available():
        raise SystemExit("controls: no CUDA device")
    for seed in seeds:
        run = core.Run(cell=cell, seed=seed, seconds=seconds, traced=False, device="cuda:0",
                       fault=None if mode in ("sound", "control") else mode,
                       control=mode == "control")
        result = core.execute(run, time.perf_counter())
        yield {"seed": seed, "mode": mode, "correct": result["correct"],
               "checks": result["checks"], "attempted": result["attempted"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", choices=MODES, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    for line in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.mode,
                         args.seconds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
