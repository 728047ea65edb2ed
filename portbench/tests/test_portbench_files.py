"""The benchmark's files: `BENCHMARK.json` against the shape the benchmark requires,
every file it names, and a cell added by files alone."""

import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from portbench.lib import harness, traffic

BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = dict(top={"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                 "per_layer"},
            configs={"name", "source", "file", "reduced", "why"},
            workloads={"name", "config", "traffic", "chips", "why"},
            end_to_end={"name", "unit", "better", "bound", "source"},
            per_layer={"name", "unit", "better", "source", "layer", "moves"})


def test_keys_and_limits():
    assert set(BENCH) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert KEYS[section] <= set(entry) <= KEYS[section] | extra, entry["name"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    for entry in BENCH[section]:
        assert NAME.match(entry["name"]), entry["name"]
        if "unit" in entry:
            assert UNIT.match(entry["unit"]), entry["unit"]
            assert entry["better"] in ("lower", "higher")
        for key in ("config", "traffic", *entry.get("reduced", [])):
            if isinstance(entry.get(key, key), str):
                assert NAME.match(entry.get(key, key))
        texts = [entry[k] for k in ("why", "layer") if k in entry]
        if section == "configs":
            texts.append(entry["source"])
        for text in texts:
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads(cell):
    c = harness.load_cell(cell)
    assert hasattr(traffic.entry_module(c.mix["entry"]), "Loop")
    assert os.path.isfile(os.path.join(harness.REPO, c.config["scene"]))
    assert set(c.limits), cell
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_files_named_exist_and_are_used():
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert os.path.isfile(os.path.join(harness.REPO, c["file"]))
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert configs == {w["config"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        mix = json.load(open(os.path.join(harness.PB, "traffic", f"{w['traffic']}.json")))
        assert os.path.isfile(os.path.join(harness.PB, "entries", f"{mix['entry']}.py"))
    for path in BENCH["paths"]:
        assert os.path.isdir(os.path.join(harness.REPO, path))


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_matches_its_entry(metric):
    entry = next(m for m in BENCH["per_layer"] if m["name"] == metric)
    mod = harness.metric_module(metric)
    assert (mod.LAYER, mod.UNIT, mod.SOURCE, mod.MOVES) == (
        entry["layer"], entry["unit"], entry["source"], entry["moves"])
    # it lists only cells that report the end-to-end metric it moves
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == entry["moves"])
    for cell in entry["workloads"]:
        assert cell in moved.get("workloads", [cell])
    layers = {m["layer"] for m in BENCH["per_layer"] if m["layer"].split(" (")[0]
              == entry["layer"].split(" (")[0]}
    assert len(layers) == 1


def test_a_cell_is_added_by_files_alone(tmp_path):
    """A copy of the benchmark with a new configuration, entry, mix and
    cell, all new files (and new entries in BENCHMARK.json), loads the new
    cell and its entry."""
    shutil.copytree(harness.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    cfg = json.load(open(os.path.join(harness.PB, "configs", "bunny_teapot_grid.json")))
    cfg.update(name="bunny_teapot_kd", compile=dict(cfg["compile"], accel="kdtree"))
    (tmp_path / "portbench/configs/bunny_teapot_kd.json").write_text(json.dumps(cfg))
    entry = open(os.path.join(harness.PB, "entries", "progressive.py")).read()
    (tmp_path / "portbench/entries/progressive_copy.py").write_text(entry)
    mix = json.load(open(os.path.join(harness.PB, "traffic", "progressive16.json")))
    mix["params"]["spp"] = 4
    mix["entry"] = "progressive_copy"
    (tmp_path / "portbench/traffic/progressive4.json").write_text(json.dumps(mix))
    cell = dict(config="bunny_teapot_kd", traffic="progressive4", params={},
                limits=json.load(open(os.path.join(harness.PB, "workloads", "grid.pt.json")))
                ["limits"])
    (tmp_path / "portbench/workloads/kd.pt4.json").write_text(json.dumps(cell))
    bench["configs"].append(dict(name="bunny_teapot_kd", source="a source", reduced=[],
                                 file="portbench/configs/bunny_teapot_kd.json", why="kd"))
    bench["workloads"].append(dict(name="kd.pt4", config="bunny_teapot_kd",
                                   traffic="progressive4", chips=1, why="kd"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "grid.pt" in m.get("workloads", []):
            m["workloads"].append("kd.pt4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("from portbench.lib import harness, traffic; c = harness.load_cell('kd.pt4'); "
            "e = traffic.entry_module(c.mix['entry']); "
            "print(c.params['spp'], c.config['compile']['accel'], len(c.per_layer), "
            "e.__file__.split('/')[-1], e.FAULTS == traffic.entry_module('progressive').FAULTS)")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(tmp_path)), timeout=120)
    assert out.returncode == 0, out.stderr
    n_layer = len(harness.load_cell("grid.pt").per_layer)
    assert out.stdout.split() == ["4", "kdtree", str(n_layer), "progressive_copy.py", "True"]
