"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from eigbench import manifest

BENCH = manifest.load()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == TOP_KEYS
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and p != "benchmark"
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for cell in BENCH["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    for cfg in BENCH["configs"]:
        assert len(cfg["reduced"]) <= 16
        assert all(NAME.match(k) for k in cfg["reduced"])
    metric_names = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for section in ("configs", "workloads"):
        got = [e["name"] for e in BENCH[section]]
        assert len(set(got)) == len(got)


def test_entries_have_just_their_keys():
    for cfg in BENCH["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert one_line(cfg["source"]) and one_line(cfg["why"])
    for cell in BENCH["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and one_line(cell["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")


def test_cells_configs_and_metrics():
    # lap2d_shiftinv_nearest0 is left out: its solver returns a wrong set
    # on some starts (PERF.md, Open questions).
    cells = {c["name"] for c in BENCH["workloads"]}
    assert [c["name"] for c in BENCH["workloads"]] == [
        "lap2d_cheb_largest10", "band5_davidson_largest10"]
    assert {c["name"] for c in BENCH["configs"]} == {"lap2d_g1000", "band5_dd_1m"}
    assert {c["config"] for c in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    # The time a solve takes is split by cell, so that each has a bound
    # of its own spread; so is each per-layer quantity both cells read.
    assert [m["name"] for m in BENCH["end_to_end"]] == [
        "solve_s.lap2d_cheb_largest10", "solve_s.band5_davidson_largest10", "setup_s"]
    assert {m["name"] for m in BENCH["per_layer"]} == {
        "restarts", "operator_applies", "jd_iterations"} | {
        f"{q}.{c}" for q in ("k1_roofline", "device_idle_pct") for c in cells}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:
        e2e = {m["name"] for m in manifest.metrics_of(BENCH, cell, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = manifest.metrics_of(BENCH, cell, "per_layer")
        assert per and all(m["moves"] in e2e for m in per)
    # A roofline share is named <kernel>_roofline, in %.
    for m in BENCH["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_every_file_of_a_cell_is_found_by_name(cell):
    entry = manifest.workload(BENCH, cell)
    cfg_json, cfg_code = manifest.config_paths(BENCH, entry["config"])
    assert cfg_json.exists() and cfg_code.exists()
    assert any(str(cfg_json.relative_to(manifest.ROOT)).startswith(p + "/")
               for p in BENCH["paths"])
    cfg, mod = manifest.config(BENCH, entry["config"])
    assert callable(mod.matrix) and callable(mod.reference)
    assert manifest.traffic_path(entry["traffic"]).exists()
    assert set(manifest.limits(cell)) >= {"value_err", "residual", "orthogonality",
                                         "missing_pairs", "not_successful"}
    for m in manifest.metrics_of(BENCH, cell, "per_layer"):
        assert callable(manifest.reader(m["name"]))


def test_config_files_state_their_source_and_cuts():
    for entry in BENCH["configs"]:
        cfg, _ = manifest.config(BENCH, entry["name"])
        assert cfg["name"] == entry["name"]
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        assert cfg["dtype"] == "float64"
