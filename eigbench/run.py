"""Run one cell of the benchmark once and print its result.

    python eigbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. The last
line of standard output is one JSON object (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, ``breakdown`` when traced, and
``checks`` last: each number compared with its limit); the last lines
of standard error repeat the checks. Without a CUDA card, with fewer
cards than the cell asks for, or when a module of ``jax``, ``jaxlib``,
``flax`` or ``spectra_tpu`` is loaded once the window has closed, it
exits with another code than 0 and prints no result.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
#: Top-level module names that must not be loaded: the JAX stack and
#: the JAX package (``spectra_tpu_torch`` begins with its name, so the
#: whole top-level name is compared).
FORBIDDEN = ("jax", "jaxlib", "flax", "spectra_tpu")
#: Fixed cache directories inside the checkout, so that only a
#: checkout's first run compiles.
CACHES = {
    "TRITON_CACHE_DIR": "build/eigbench_cache/triton",
    "TORCH_EXTENSIONS_DIR": "build/eigbench_cache/torch_extensions",
    "TORCHINDUCTOR_CACHE_DIR": "build/eigbench_cache/inductor",
    "CUDA_CACHE_PATH": "build/eigbench_cache/cuda",
}


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for key, rel in CACHES.items():
        os.environ[key] = str(ROOT / rel)
    sys.path.insert(0, str(ROOT))

    import torch

    from eigbench import harness, manifest

    cell = manifest.workload(manifest.load(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda:0",
                              t_process=T_PROCESS)
    found = forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
