"""BENCHMARK.json against the benchmark's contract: its keys, names,
units, the cells' metrics and the files it names."""

import json
import os
import re

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_and_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))


def test_every_cell_reports_what_the_contract_asks():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    cells = {w["name"] for w in BENCH["workloads"]}
    for cell in cells:
        moved = {n for n, m in e2e.items() if cell in m.get("workloads", [cell])}
        assert len(moved) >= 2
        layers = [m for m in BENCH["per_layer"] if cell in m.get("workloads", [])]
        assert layers and all(m["moves"] in moved for m in layers)
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert "mfu" in m["name"] or not m["name"].startswith("mfu")
    train = [m for m in BENCH["per_layer"] if m["moves"] == "train_audio_s_per_s"]
    assert any("mfu" in m["name"] for m in train)


def test_files_named_by_the_manifest_exist():
    for c in BENCH["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("benchmark/") and os.path.exists(path)
        cfg = json.load(open(path))
        assert cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and "experiment" in cfg
    for w in BENCH["workloads"]:
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic", f"{w['traffic']}.json"))
        assert os.path.exists(os.path.join(ROOT, "benchmark", "limits", f"{w['name']}.json"))
    for m in BENCH["per_layer"]:
        stem = m["name"].split(".")[0]
        assert os.path.exists(os.path.join(ROOT, "benchmark", "metrics", f"{stem}.py"))


def test_the_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
