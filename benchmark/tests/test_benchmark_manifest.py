"""BENCHMARK.json against the contract's shapes, and every name it holds
resolved to a file."""

import json

import pytest

from harness import manifest

MAN = manifest.load_manifest()
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


def _names():
    out = [("command", w) for w in MAN["command"]]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        out += [(section, e["name"]) for e in MAN[section]]
    out += [("config", w["config"]) for w in MAN["workloads"]]
    out += [("traffic", w["traffic"]) for w in MAN["workloads"]]
    out += [("reduced", k) for c in MAN["configs"] for k in c["reduced"]]
    return out


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)


@pytest.mark.parametrize("where,name", [n for n in _names() if n[0] != "command"])
def test_name_characters(where, name):
    assert manifest.NAME.match(name), (where, name)


@pytest.mark.parametrize("metric", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    keys = {"name", "unit", "better", "source"}
    if metric in MAN["end_to_end"]:
        keys |= {"bound"}
        assert metric["source"] in E2E_SOURCES
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        keys |= {"layer", "moves"}
        assert metric["source"] in SOURCES
        assert metric["moves"] in {m["name"] for m in MAN["end_to_end"]}
        assert 1 <= len(metric["layer"]) <= 200 and "\n" not in metric["layer"]
    assert set(metric) - {"workloads"} == keys
    assert manifest.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", [])) <= {w["name"] for w in MAN["workloads"]}


def test_unique_names():
    for section in ("configs", "workloads"):
        names = [e["name"] for e in MAN[section]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_cell_resolves(cell):
    """Configuration, traffic, scene generator, driver, limits and every
    metric reader are found by name; the cell reports setup_s, another
    end-to-end metric and a per-layer metric, each per-layer metric's
    ``moves`` among its own."""
    c = manifest.cell(cell)
    assert c.chips == 1
    assert 1 <= len(c.entry["why"]) <= 200
    assert manifest.scene_path(c.config["scene"]).is_file()
    assert manifest.driver_path(c.traffic["driver"]).is_file()
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert manifest.metric_path(m["name"]).is_file()
        assert m["moves"] in e2e
    assert c.limits and all(v["limit"] is not None for v in c.limits.values())


@pytest.mark.parametrize("config", MAN["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    assert config["file"] == f"benchmark/configs/{config['name']}.json"
    data = json.loads((manifest.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"]
    used = {w["config"] for w in MAN["workloads"]}
    assert config["name"] in used
