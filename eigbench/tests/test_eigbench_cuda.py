"""``eigbench/run.py`` as a benchmark run calls it: a short run on the card
(marked ``cuda``), and, without a card, a refusal with no result."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from eigbench import manifest

ROOT = Path(__file__).resolve().parents[2]


def run_py(*args):
    return subprocess.run([sys.executable, "eigbench/run.py", *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=1200)


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_short_run_on_the_card_is_correct(trace):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = "band5_davidson_largest10"
    out = run_py("--workload", cell, "--seed", "4000000001",
                 "--seconds", "1", "--trace", trace)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    assert list(result)[-1] == "checks"
    assert out.stderr.strip().splitlines()[-1].startswith("check ")
    if trace == "1":
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        section = "per_layer"
    else:
        section = "end_to_end"
    bench = manifest.load()
    assert set(result["metrics"]) == {m["name"] for m in manifest.metrics_of(bench, cell, section)}


def test_without_a_card_the_run_refuses_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = run_py("--workload", "lap2d_cheb_largest10", "--seed", "1",
                 "--seconds", "1", "--trace", "0")
    assert out.returncode != 0 and out.stdout.strip() == ""
