import sys
from pathlib import Path

import pytest

# The benchmark's modules import as ``eigbench.*`` from the checkout root.
ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import benches  # noqa: E402
from eigbench import manifest  # noqa: E402


@pytest.fixture(scope="session")
def roots(tmp_path_factory):
    """The root of each benchmark of ``benches.KINDS``."""
    return {"repo": manifest.ROOT,
            "nonsym": benches.build_nonsym(tmp_path_factory.mktemp("nonsym"))}
