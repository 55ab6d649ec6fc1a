"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name; each check also on a copy with a non-symmetric
cell appended (``benches.py``), which must pass as it is."""

import json
import re

import pytest

import benches
from eigbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}
#: The contract's name for the set-up time, which every cell reports.
SETUP = "setup_s"
#: The quantity the harness measures for each cell apart, named
#: ``<quantity>.<cell>`` so that each cell has a bound of its own spread.
SOLVE = "solve_s"
#: The numbers that every comparison returns.
ALWAYS_COMPARED = {"missing_pairs", "not_successful"}

kinds = pytest.mark.parametrize("kind", benches.KINDS)


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


@kinds
def test_top_level_shape(kind, roots):
    bench = manifest.load(roots[kind])
    assert set(bench) == TOP_KEYS
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and p != "benchmark"
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for word in cmd:
        if "/" in word:
            assert any(word.startswith(p + "/") for p in bench["paths"])
    assert len(json.dumps(bench)) <= 64 * 1024


@kinds
def test_names_and_units_use_allowed_characters(kind, roots):
    bench = manifest.load(roots[kind])
    names = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[section]:
            assert NAME.match(entry["name"]), entry["name"]
            names.append((section, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
    for cell in bench["workloads"]:
        assert NAME.match(cell["config"]) and NAME.match(cell["traffic"])
    for cfg in bench["configs"]:
        assert len(cfg["reduced"]) <= 16
        assert all(NAME.match(k) for k in cfg["reduced"])
    metric_names = [n for s, n in names if s in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for section in ("configs", "workloads"):
        got = [e["name"] for e in bench[section]]
        assert len(set(got)) == len(got)


@kinds
def test_entries_have_just_their_keys(kind, roots):
    bench = manifest.load(roots[kind])
    for cfg in bench["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert one_line(cfg["source"]) and one_line(cfg["why"])
    for cell in bench["workloads"]:
        assert set(cell) == {"name", "config", "traffic", "chips", "why"}
        assert cell["chips"] in (1, 4) and one_line(cell["why"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert one_line(m["layer"])
        assert m["moves"] in {e["name"] for e in bench["end_to_end"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert m["better"] in ("lower", "higher")


@kinds
def test_cells_configs_and_metrics(kind, roots):
    bench = manifest.load(roots[kind])
    cells = [c["name"] for c in bench["workloads"]]
    assert 1 <= len(cells) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16 and 1 <= len(bench["per_layer"]) <= 128
    # At most a quarter of the cells, rounded down, ask for 4 chips; one always may.
    four = sum(c["chips"] == 4 for c in bench["workloads"])
    assert four <= max(1, len(cells) // 4)
    # Every configuration is used, and every cell's configuration exists.
    configs = {c["name"] for c in bench["configs"]}
    assert 1 <= len(configs) <= 24
    assert {c["config"] for c in bench["workloads"]} == configs
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= set(cells)
        # A quantity split by cell, <quantity>.<cell>, lists its cell alone.
        part = m["name"].partition(".")[2]
        if part in cells:
            assert m["workloads"] == [part]
    for cell in cells:
        e2e = {m["name"]: m for m in manifest.metrics_of(bench, cell, "end_to_end")}
        assert SETUP in e2e and len(e2e) >= 2
        # One solve_s.<cell> a cell, its own, with a bound of its own spread.
        solve = [m for m in e2e.values() if m["name"].partition(".")[0] == SOLVE]
        assert [m["name"] for m in solve] == [f"{SOLVE}.{cell}"]
        assert solve[0]["workloads"] == [cell] and 0.01 <= solve[0]["bound"] <= 0.25
        # What the harness measures: the set-up and the solve.
        assert set(e2e) == {SETUP, f"{SOLVE}.{cell}"}
        per = manifest.metrics_of(bench, cell, "per_layer")
        assert per and all(m["moves"] in e2e for m in per)
    # A roofline share is named <kernel>_roofline, in %.
    for m in bench["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].partition(".")[0].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("kind,cell", benches.cells())
def test_every_file_of_a_cell_is_found_by_name(kind, cell, roots):
    root = roots[kind]
    bench = manifest.load(root)
    entry = manifest.workload(bench, cell)
    cfg_json, cfg_code = manifest.config_paths(bench, entry["config"], root)
    assert cfg_json.exists() and cfg_code.exists()
    assert any(str(cfg_json.relative_to(root)).startswith(p + "/") for p in bench["paths"])
    cfg, mod = manifest.config(bench, entry["config"], root)
    assert callable(mod.matrix) and callable(mod.reference)
    assert callable(manifest.comparison(mod))
    assert manifest.traffic_path(entry["traffic"], root).exists()
    # The limits name exactly the numbers that the configuration's comparison returns.
    numbers = manifest.numbers(mod)
    assert ALWAYS_COMPARED <= set(numbers)
    assert set(manifest.limits(cell, root)) == set(numbers)
    config_overrides, traffic_overrides = manifest.tiny(cell, root)
    assert isinstance(config_overrides, dict) and isinstance(traffic_overrides, dict)
    for m in manifest.metrics_of(bench, cell, "per_layer"):
        assert callable(manifest.reader(m["name"], root))


@kinds
def test_config_files_state_their_source_and_cuts(kind, roots):
    bench = manifest.load(roots[kind])
    for entry in bench["configs"]:
        cfg, _ = manifest.config(bench, entry["name"], roots[kind])
        assert cfg["name"] == entry["name"]
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        assert cfg["dtype"] == "float64"


def test_the_copy_adds_a_cell_by_new_files_alone(roots):
    """The non-symmetric copy differs from ``BENCHMARK.json`` only by
    appended entries, and from the benchmark's folder only by new files."""
    repo, copy = manifest.load(roots["repo"]), manifest.load(roots["nonsym"])
    added = benches.appended()
    for section in benches.SECTIONS:
        assert copy[section] == repo[section] + added[section]
        assert added[section]
    for path in (roots["repo"] / manifest.FOLDER).rglob("*"):
        rel = path.relative_to(roots["repo"])
        if path.is_file() and "tests" not in rel.parts and "__pycache__" not in rel.parts:
            assert (roots["nonsym"] / rel).read_bytes() == path.read_bytes()
    for path in benches.NONSYM.rglob("*"):
        if path.is_file() and path.parent != benches.NONSYM:
            rel = path.relative_to(benches.NONSYM)
            assert not (roots["repo"] / manifest.FOLDER / rel).exists()
