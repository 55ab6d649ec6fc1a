"""The benchmarks that the CPU tests hold to the contract and run.

``"repo"`` is ``BENCHMARK.json`` as it is. ``"nonsym"`` is a copy of the
checkout's benchmark with the entries of ``nonsym/benchmark.json``
appended and the files of ``nonsym/`` added: a non-symmetric cell
(the general IRAM on a convection-diffusion operator, complex pairs,
a comparison of its own) that comes in by new files alone, as a later
cell does.
"""

import json
import shutil
from pathlib import Path

from eigbench import manifest

NONSYM = Path(__file__).resolve().parent / "nonsym"
KINDS = ("repo", "nonsym")
SECTIONS = ("configs", "workloads", "end_to_end", "per_layer")


def appended():
    """The entries that the ``"nonsym"`` copy appends, by section."""
    with open(NONSYM / "benchmark.json") as f:
        entries = json.load(f)
    return {s: entries.get(s, []) for s in SECTIONS}


def build_nonsym(root: Path) -> Path:
    """The ``"nonsym"`` copy at ``root``: ``BENCHMARK.json`` with the
    appended entries, the benchmark's folder without its tests, and the
    files of ``nonsym/`` in it."""
    folder = root / manifest.FOLDER
    shutil.copytree(manifest.ROOT / manifest.FOLDER, folder,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for part in ("configs", "traffic", "limits", "tiny"):
        shutil.copytree(NONSYM / part, folder / part, dirs_exist_ok=True)
    bench = manifest.load()
    for section, entries in appended().items():
        bench[section] = bench[section] + entries
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2) + "\n")
    return root


def cells():
    """(kind, cell) of each cell the tests run: every cell of
    ``BENCHMARK.json``, and the cells that the ``"nonsym"`` copy adds."""
    return ([("repo", c["name"]) for c in manifest.load()["workloads"]]
            + [("nonsym", c["name"]) for c in appended()["workloads"]])
