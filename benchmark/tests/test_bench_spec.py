"""BENCHMARK.json against the contract, and the discovery of every file it
names."""

import json
import re
from pathlib import Path

import pytest

from benchmark import harness

REPO = harness.REPO
SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert 1 <= len(SPEC["paths"]) <= 16
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/") and ".." not in p
        assert (REPO / p).is_dir()
    assert len(SPEC["command"]) <= 32
    assert all(TEXT.match(w) for w in SPEC["command"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in SPEC[group]}) == len(SPEC[group])
    metrics = [e["name"] for g in ("end_to_end", "per_layer") for e in SPEC[g]]
    assert len(set(metrics)) == len(metrics)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for m in SPEC["per_layer"]:
        assert TEXT.match(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for w in SPEC["workloads"]:
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for c in SPEC["configs"]:
        assert TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert set(c) == {"name", "source", "file", "reduced", "why"}


def test_end_to_end_metrics():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for c in cells:
        reported = [m for m in e2e.values() if c in m.get("workloads", [c])]
        assert "setup_s" in {m["name"] for m in reported}
        assert len(reported) >= 2, c


def test_every_file_is_found():
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    files = {c["file"] for c in SPEC["configs"]}
    assert len(files) == len(SPEC["configs"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for w in SPEC["workloads"]:
        c = harness.cell(w["name"], SPEC)
        assert c.per_layer, w["name"]
        harness.driver(c.traffic["driver"])
        for m in c.per_layer:
            assert callable(harness.reader(m["name"]))
        assert set(c.workload["limits"]) and all(v is not None for v in c.workload["limits"].values())
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)


def test_per_layer_metrics_report_what_they_move():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in e2e[m["moves"]].get("workloads", [w]), (m["name"], w)
    layers = {}
    for m in SPEC["per_layer"]:
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values()), layers


def test_shares_are_percent():
    for m in SPEC["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"] or m["name"].startswith("idle_share"):
            assert m["unit"] == "%"


@pytest.mark.parametrize("path", sorted((REPO / "benchmark").rglob("*")))
def test_file_names(path: Path):
    rel = path.relative_to(REPO).as_posix()
    if "__pycache__" in rel:
        return
    assert re.fullmatch(r"[A-Za-z0-9_.\-/]+", rel), rel
