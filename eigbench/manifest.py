"""``BENCHMARK.json`` and the files it names, found by name.

* a configuration: the JSON ``file`` of its entry, and the module of
  the same name beside it (``configs/<name>.py``, numpy and scipy only:
  ``matrix(cfg)``, the matrix A or a dict of named operands such as
  ``{"A": A, "B": B}``; ``reference(cfg, nev, which, sigma, dtype,
  vectors)``, the wanted eigenpairs; and optionally ``compare``, where
  the problem needs another comparison than ``reference/compare.py``'s,
  with ``NUMBERS``, the names of the numbers it returns);
* a traffic mix: ``traffic/<name>.json``;
* a per-layer metric: its reader ``metrics/<name>.py``, a function
  ``read(run)`` that returns a number or None; a metric named
  ``<base>.<part>`` (one quantity split by cell) is read by
  ``metrics/<base>.py`` where it has no file of its own;
* a cell's limits: ``limits/<workload>.json``, one limit for each
  number that its configuration's comparison returns;
* a cell's tiny size for the CPU tests: ``tiny/<workload>.json``,
  ``{"config": {...}, "traffic": {...}}``, overrides merged into the
  configuration and the traffic mix.

Each function takes ``root``, the directory that holds
``BENCHMARK.json`` and the benchmark's folder (by default this
checkout). No file of one configuration, mix, metric or cell names
another's.
"""

import importlib.util
import json
from pathlib import Path

from eigbench.reference import compare as _compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: The benchmark's folder, relative to ``root``.
FOLDER = HERE.relative_to(ROOT)


def load(root=ROOT):
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _one(entries, name, what):
    found = [e for e in entries if e["name"] == name]
    if len(found) != 1:
        raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")
    return found[0]


def workload(bench, name):
    return _one(bench["workloads"], name, "workload")


def _module(path: Path, label: str):
    spec = importlib.util.spec_from_file_location(label, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: Path):
    with open(path) as f:
        return json.load(f)


def config_paths(bench, name, root=ROOT):
    """(JSON file, reference module) of configuration ``name``."""
    path = Path(root) / _one(bench["configs"], name, "config")["file"]
    return path, path.with_suffix(".py")


def config(bench, name, root=ROOT):
    """(parameters, module) of configuration ``name``."""
    path, code = config_paths(bench, name, root)
    return _json(path), _module(code, f"eigbench_config:{name}")


def operands(mod, cfg):
    """The named host operands of a configuration (``A``, maybe ``B``)."""
    m = mod.matrix(cfg)
    return dict(m) if isinstance(m, dict) else {"A": m}


def comparison(mod):
    """The comparison of a configuration: its module's ``compare``, or
    the symmetric one of ``reference/compare.py``."""
    return getattr(mod, "compare", _compare.compare)


def numbers(mod):
    """The names of the numbers that :func:`comparison` returns: the
    module's ``NUMBERS`` where it brings its own ``compare``."""
    return tuple(mod.NUMBERS) if hasattr(mod, "compare") else _compare.NUMBERS


def _data(root, kind, name, suffix=".json"):
    return Path(root) / FOLDER / kind / f"{name}{suffix}"


def traffic_path(name, root=ROOT):
    return _data(root, "traffic", name)


def traffic(name, root=ROOT):
    return _json(traffic_path(name, root))


def limits_path(name, root=ROOT):
    return _data(root, "limits", name)


def limits(name, root=ROOT):
    return _json(limits_path(name, root))


def tiny(name, root=ROOT):
    """(configuration overrides, traffic overrides) of cell ``name`` at
    its tiny CPU size."""
    t = _json(_data(root, "tiny", name))
    return t.get("config") or {}, t.get("traffic") or {}


def metric_path(name, root=ROOT):
    path = _data(root, "metrics", name, ".py")
    if not path.exists() and "." in name:
        path = _data(root, "metrics", name.split(".")[0], ".py")
    return path


def reader(name, root=ROOT):
    return _module(metric_path(name, root), f"eigbench_metric:{name}").read


def metrics_of(bench, cell, section):
    """The entries of ``section`` (``end_to_end`` or ``per_layer``) that
    cell ``cell`` reports: those without ``workloads`` and those that
    list it."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]
