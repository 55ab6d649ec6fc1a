"""What the harness and the reference load, by whole top-level module
name: never the JAX stack or the JAX package (whose name
``spectra_tpu_torch`` begins with), nor the JAX package's own
``benchmark/`` folder; and the reference nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "spectra_tpu", "benchmark"}


def loaded_after(code):
    """Top-level names in ``sys.modules`` of a fresh interpreter after
    ``code``."""
    probe = (f"import sys; sys.path.insert(0, {str(ROOT)!r}); {code}; import json; "
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, check=True, timeout=300, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax_and_no_jax_package():
    code = ("import eigbench.run as r; import eigbench.harness as h; "
            "from eigbench import manifest; b = manifest.load(); "
            "[manifest.reader(m['name']) for m in b['per_layer']]; "
            "[manifest.config(b, c['name']) for c in b['configs']]")
    top = loaded_after(code)
    assert "spectra_tpu_torch" in top
    assert not top & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    code = ("import eigbench.reference.compare, eigbench.reference.control; "
            "from eigbench import manifest; b = manifest.load(); "
            "[manifest.config(b, c['name']) for c in b['configs']]")
    top = loaded_after(code)
    assert not top & (FORBIDDEN | {"spectra_tpu_torch", "torch"})


def test_run_refuses_by_whole_top_level_name(monkeypatch):
    import types

    import spectra_tpu_torch  # noqa: F401  (its name begins with spectra_tpu)

    import eigbench.run as run

    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "spectra_tpu.ops", types.ModuleType("spectra_tpu.ops"))
    assert run.forbidden_modules() == ["jax", "spectra_tpu"]
