import sys
from pathlib import Path

# The benchmark's modules import as ``eigbench.*`` from the checkout root.
ROOT = str(Path(__file__).resolve().parents[2])
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
