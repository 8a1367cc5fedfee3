"""The manifest (``BENCHMARK.json``) against the benchmark's contract, and
every file it names."""

from __future__ import annotations

import json
import re
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}
WIDTHS = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expan")


def bench() -> dict:
    return json.loads((REPO / "BENCHMARK.json").read_text())


def one_line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_and_paths():
    b = bench()
    assert set(b) == TOP_KEYS
    assert 1 <= len(b["paths"]) <= 16
    for p in b["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (REPO / p).is_dir()
    assert 1 <= len(b["command"]) <= 32 and all(one_line(w) for w in b["command"])
    for word in b["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in b["paths"]), word
            assert (REPO / word).exists()
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    b = bench()
    names = [e["name"] for sec in ("configs", "workloads", "end_to_end", "per_layer") for e in b[sec]]
    assert all(NAME.match(n) for n in names)
    for sec in ("configs", "workloads", "end_to_end", "per_layer"):
        sec_names = [e["name"] for e in b[sec]]
        assert len(sec_names) == len(set(sec_names)), sec
    metrics = b["end_to_end"] + b["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in SOURCES_E2E
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and one_line(m["layer"])
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    assert next(m for m in b["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    assert 1 <= len(b["end_to_end"]) <= 16 and 1 <= len(b["per_layer"]) <= 128


def test_configs_and_cells_files():
    b = bench()
    assert 1 <= len(b["configs"]) <= 24 and 1 <= len(b["workloads"]) <= 24
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and one_line(c["source"]) and one_line(c["why"])
        assert any(c["file"].startswith(p + "/") for p in b["paths"])
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(r) and not WIDTHS.search(r) for r in c["reduced"])
        assert cfg["source"] == c["source"]
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    base = REPO / "annbench"
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and one_line(w["why"]) and NAME.match(w["traffic"])
        assert (base / "configs" / f"{w['config']}.json").is_file()
        traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
        assert (base / "drivers" / f"{traffic['driver']}.py").is_file()
        spec = json.loads((base / "workloads" / f"{w['name']}.json").read_text())
        assert (base / "engines" / f"{spec['engine']}.py").is_file()
        assert set(spec["limits"]) == {"miss_at_10", "order_gap", "bad_ids"} and spec["limits"]["bad_ids"] == 0
    for m in b["per_layer"]:
        assert (base / "metrics" / f"{m['name']}.py").is_file()


def test_every_cell_reports_what_its_metrics_move():
    b = bench()
    cells = [w["name"] for w in b["workloads"]]

    def lists(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    e2e = {c: {m["name"] for m in b["end_to_end"] if lists(m, c)} for c in cells}
    names = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
    for c in cells:
        assert "setup_s" in e2e[c] and len(e2e[c]) >= 2
        assert any(lists(m, c) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert m["moves"] in names
        for c in m.get("workloads", [c for c in cells if m["moves"] in e2e[c]]):
            assert m["moves"] in e2e[c], (m["name"], c)
    layers = {m["layer"] for m in b["per_layer"]}
    assert layers == {"engine", "search", "kernels", "build", "device"}
