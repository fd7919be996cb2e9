"""``BENCHMARK.json`` and the files it names: a cell's configuration,
traffic mix, metrics and limits, each found by name.

- configuration ``<c>``: ``benchmark/configs/<c>.json``, whose ``scene``
  names ``benchmark/scenes/<scene>.py``: the generator of the scene's
  arrays, the program's scene built from them, and the name of its
  reference, ``benchmark/reference/<REFERENCE>.py``;
- traffic ``<t>``: ``benchmark/traffic/<t>.json``, whose ``driver`` names
  the loop ``benchmark/harness/drivers/<driver>.py``;
- per-layer metric ``<m>``: the reader ``benchmark/metrics/<m>.py``;
- the limits of a cell's comparison: ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = ROOT / "BENCHMARK.json"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load_manifest(path: Path = MANIFEST) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    name: str
    entry: dict
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list
    limits: dict

    @property
    def chips(self) -> int:
        return int(self.entry["chips"])


def _for_cell(metrics: list, cell: str, reported: set | None = None) -> list:
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m.get("moves") in reported:
            out.append(m)
    return out


def config_path(name: str) -> Path:
    return BENCH / "configs" / f"{name}.json"


def traffic_path(name: str) -> Path:
    return BENCH / "traffic" / f"{name}.json"


def metric_path(name: str) -> Path:
    return BENCH / "metrics" / f"{name}.py"


def scene_path(name: str) -> Path:
    return BENCH / "scenes" / f"{name}.py"


def reference_path(name: str) -> Path:
    return BENCH / "reference" / f"{name}.py"


def driver_path(name: str) -> Path:
    return BENCH / "harness" / "drivers" / f"{name}.py"


def limits_path(cell: str) -> Path:
    return BENCH / "limits" / f"{cell}.json"


def cell(name: str, manifest: dict | None = None) -> Cell:
    """The cell ``name`` of the manifest, with its files read. Raises
    ``KeyError`` for a cell the manifest lacks."""
    man = manifest or load_manifest()
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = _for_cell(man["end_to_end"], name)
    layer = _for_cell(man["per_layer"], name, {m["name"] for m in e2e})
    lim = limits_path(name)
    return Cell(name=name, entry=entry,
                config=json.loads(config_path(entry["config"]).read_text()),
                traffic=json.loads(traffic_path(entry["traffic"]).read_text()),
                end_to_end=e2e, per_layer=layer,
                limits=json.loads(lim.read_text()) if lim.exists() else {})
