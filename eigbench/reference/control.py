"""The control of a cell's comparison: the reference itself, computed
one precision lower (float32 for the configurations' float64), put in
the program's place. Its answer must fail at least one of the cell's
limits, or the comparison could not tell a float32 program from a
float64 one.

    python eigbench/reference/control.py --workload <name>

prints the control's numbers beside the cell's limits as one JSON line.
The control draws nothing from a seed: the reference's eigenpairs are
the same for every start vector.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from eigbench import manifest  # noqa: E402
from eigbench.reference.compare import fails  # noqa: E402


def control_numbers(name, dtype=np.float32, config_overrides=None, root=manifest.ROOT):
    """The numbers of cell ``name``'s control answer (a cell of the
    ``BENCHMARK.json`` in ``root``)."""
    bench = manifest.load(root)
    cell = manifest.workload(bench, name)
    cfg, mod = manifest.config(bench, cell["config"], root)
    cfg = {**cfg, **(config_overrides or {})}
    want = manifest.traffic(cell["traffic"], root)["wanted"]
    nev, sigma = int(want["nev"]), float(want.get("sigma", 0.0))
    operands = manifest.operands(mod, cfg)
    ref, _ = mod.reference(cfg, nev, want["which"], sigma, np.float64, vectors=False)
    vals, vecs = mod.reference(cfg, nev, want["which"], sigma, dtype, vectors=True)
    return manifest.comparison(mod)(operands, ref, vals, vecs, nev, True, sigma)


def main(argv=None):
    p = argparse.ArgumentParser(description="a cell's float32 control")
    p.add_argument("--workload", required=True)
    args = p.parse_args(argv)
    nums = control_numbers(args.workload)
    limits = manifest.limits(args.workload)
    print(json.dumps({"workload": args.workload, "numbers": nums, "limits": limits,
                      "fails": fails(nums, limits)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
