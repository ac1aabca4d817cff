"""``BENCHMARK.json`` against the benchmark's contract, and the harness
finding a cell, a configuration, a traffic mix and a metric that are
added as files and entries alone (no card, no program run)."""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import cell as cell_mod
from portbench.tests import tiny

ROOT = tiny.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _metrics():
    return BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_paths():
    assert set(BENCH) == KEYS
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("entry", _metrics() + BENCH["workloads"]
                         + BENCH["configs"], ids=lambda e: e["name"])
def test_names_and_units(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"])
        assert entry["better"] in ("lower", "higher")
    for k in ("config", "traffic"):
        if k in entry:
            assert NAME.match(entry[k])
    for k in ("why", "layer", "source"):
        if k in entry:
            assert 1 <= len(entry[k]) <= 200 and "\n" not in entry[k]


def test_names_are_unique():
    for group in (_metrics(), BENCH["workloads"], BENCH["configs"]):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))


def test_end_to_end_bounds():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_moves_names_a_metric_each_cell_reports(metric):
    """Every ``moves`` is an end-to-end metric that each of the metric's
    cells reports."""
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert metric["moves"] in e2e
    cells = {w["name"] for w in BENCH["workloads"]}
    moved = e2e[metric["moves"]]
    for w in metric["workloads"]:
        assert w in cells
        assert w in moved.get("workloads", [w])
    assert (ROOT / "portbench" / "metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files_and_a_layer_metric(w):
    c = cell_mod.load(w["name"])
    assert w["chips"] == 1
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert len(c.end_to_end) >= 2 and c.per_layer
    assert set(c.spec["limits"]) >= {"start_attrs", "cells", "chunk_x_q",
                                      "lost", "route"}


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_files(cfg):
    path = ROOT / cfg["file"]
    assert path.parts[len(ROOT.parts)] == "portbench"
    data = json.loads(path.read_text())
    assert data["reduced"] == cfg["reduced"] == []
    assert data["name"] == cfg["name"] and data["source"] == cfg["source"]
    assert {"N", "dt", "dim", "reference", "program", "particles", "cells",
            "cap", "assumed"} <= set(data)
    assert (ROOT / "portbench" / "reference"
            / f"{data['reference']}.py").exists()


def test_a_cell_config_traffic_and_metric_added_as_files(tmp_path):
    """A later change adds a cell by files and entries alone: the harness
    finds the new configuration, its reference, the traffic, the cell file
    and the metric reader by their names."""
    root = tiny.make(tmp_path)
    data = root / "portbench"
    cfg = json.loads((data / "configs" / "lid_cavity2d_re100.json").read_text())
    cfg.update(name="lid_cavity2d_re400", Re=400.0, reference="cavity_re400")
    (data / "configs" / "lid_cavity2d_re400.json").write_text(json.dumps(cfg))
    (data / "reference" / "cavity_re400.py").write_text(
        "from portbench.reference.cavity import model, spacing\n"
        "from portbench.reference import cavity\n\n\n"
        "def scene(config):\n"
        "    sc = cavity.scene(config)\n"
        "    sc.found = config['name']\n"
        "    return sc\n")
    (data / "traffic" / "plain_again.json").write_text(json.dumps(
        {"build": "model", "species": None}))
    spec = json.loads((data / "workloads" / "cavity2d-ssa-n1000.json")
                      .read_text())
    (data / "workloads" / "cavity2d-re400.json").write_text(json.dumps(spec))
    (data / "metrics" / "chunks_seen.py").write_text(
        "def read(rec):\n    return len(rec.get('chunk_ms', [])) or None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append(dict(bench["configs"][0], name="lid_cavity2d_re400",
                                 file="portbench/configs/lid_cavity2d_re400.json"))
    bench["workloads"].append({"name": "cavity2d-re400",
                               "config": "lid_cavity2d_re400",
                               "traffic": "plain_again", "chips": 1,
                               "why": "the cavity at Re 400"})
    bench["per_layer"].append({"name": "chunks_seen", "unit": "chunks",
                               "better": "higher", "source": "program_span",
                               "layer": "stepper",
                               "moves": "particle_steps_per_s",
                               "workloads": ["cavity2d-re400"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cell_mod.load("cavity2d-re400", root)
    assert c.config["Re"] == 400.0 and c.traffic["species"] is None
    sc = c.scene()
    assert sc.found == "lid_cavity2d_re400"
    assert sc.nu == pytest.approx(1.0 / 400.0)
    assert c.model("cpu").species is None and c.dim == 2
    assert [m["name"] for m in c.per_layer] == ["chunks_seen"]
    assert c.metric_reader("chunks_seen")({"chunk_ms": [1.0, 2.0]}) == 2
    assert cell_mod.load("cavity2d-ssa-n1000", root).per_layer


def test_frozen_script_is_the_example():
    """The SSA cell's script is a frozen copy: it starts as the example."""
    ours = (ROOT / "portbench" / "scripts" / "lid_cavity_ssa.lmp").read_text()
    assert "ssa_tsdpd/ssa_rxn_mass_action" in ours
    assert "variable           kss equal 2e-3" in ours
