"""``spans.py``: the program's spans and the device work each issued.

The per-layer metrics of ``BENCHMARK.json`` read from the program's
spans (``source`` ``program_span``) on synthetic traces with known
spans, launches and copies, and None where a span, the issuing calls or
the run's program trace are missing; idle gaps named by the innermost
span, the same as ``tracing.name_gaps`` on the benchmark's spans alone,
and folding back to its totals with the program's spans added; a CPU
traced run of each tiny cell (no card: the span metrics report nothing
and say why, the counters read as before); on a card (marked ``cuda``),
a traced run of each cell reports its span metrics and names the idle
gaps by program span.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

import benches
from eigbench import harness, manifest, spans, tracing, yardstick
from eigbench.harness import Run
from eigbench.traffic import Answer

ROOT = Path(__file__).resolve().parents[2]
BENCH = manifest.load()
#: The per-layer metrics read from the program's spans.
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]
PROGRAM = ("cheb.filter", "irlm.restart", "jd.iteration", "jd.orthogonalize", "krylov.step")


def synthetic(kernels=None, reads=None, unlinked=(), extra=None):
    """Two requests' worth of spans; kernels as (issued, duration)."""
    sp = {"request": [(0.0, 10.0)], "solver.init": [(0.2, 0.8)],
          "solver.compute": [(1.0, 9.0)], "op.apply": [(2.1, 2.4), (4.2, 4.4)],
          "cheb.filter": [(2.0, 3.0), (4.0, 5.0)], "irlm.restart": [(3.5, 6.0)],
          "jd.iteration": [(6.0, 8.0)], "jd.orthogonalize": [(7.0, 7.5)],
          "krylov.step": [(1.5, 3.2), (3.8, 5.2)]}
    sp.update(extra or {})
    if kernels is None:
        kernels = [(2.1, 0.01), (2.2, 0.01), (2.5, 0.01), (4.1, 0.01), (4.9, 0.01),
                   (3.6, 0.01), (6.5, 0.3), (7.1, 0.5), (7.2, 0.2), (9.5, 0.1)]
    ks = [(f"k{i}", at, at + 0.001, at + 0.001 + d) for i, (at, d) in enumerate(kernels)]
    rd = [(at, at + 0.001, at + 0.002) for at in (reads if reads is not None
                                                  else (3.7, 4.5, 5.9, 6.1, 1.2))]
    return spans.ProgramTrace(spans=sp, kernels=ks, reads=rd, unlinked=list(unlinked),
                              program=PROGRAM)


def run_of(pt, kernels=()):
    answer = Answer(values=None, vectors=None, nconv=10, successful=True,
                    iterations=3, operations=7, k1_launches=0, calls=[], wall_s=1.0)
    trace = tracing.Trace(kernels=list(kernels), copies=[],
                          spans={k: v for k, v in pt.spans.items() if k in tracing.SPANS},
                          skipped={})
    return Run(answers=[answer], traced=[answer], trace=trace,
               rates=yardstick.card_rates("H100"), program=pt)


def test_each_metric_on_a_synthetic_trace():
    pt = synthetic()
    read = {m["name"]: manifest.reader(m["name"]) for m in SPAN_METRICS}
    run = run_of(pt)
    # 5 kernels issued inside the two filter spans.
    assert read["filter_launches_per_apply"](run) == pytest.approx(2.5)
    # 2 s of filter spans over those 5 launches.
    assert read["filter_host_us_per_launch"](run) == pytest.approx(4e5)
    # 3 reads issued inside the one restart (at 3.7, 4.5, 5.9).
    assert read["host_reads_per_restart"](run) == pytest.approx(3.0)
    # 0.5 + 0.2 s of the iteration's 0.3 + 0.5 + 0.2 s.
    assert read["jd_qr_pct"](run) == pytest.approx(70.0)
    # The same 5 kernels in the two steps that hold the filters.
    assert spans.launches_per_span(pt, "krylov.step") == pytest.approx(2.5)
    # Nothing issued inside their spans: a count reads 0, a ratio to
    # what they issued nothing.
    nothing = run_of(synthetic(kernels=[(9.5, 0.1)], reads=[9.6]))
    assert read["filter_launches_per_apply"](nothing) == 0.0
    assert read["host_reads_per_restart"](nothing) == 0.0
    assert read["filter_host_us_per_launch"](nothing) is None
    assert read["jd_qr_pct"](nothing) is None


@pytest.mark.parametrize("metric", [m["name"] for m in SPAN_METRICS])
def test_each_metric_reports_nothing_without_what_it_reads(metric, capsys):
    read = manifest.reader(metric)
    # Some program span that it reads: without it, nothing, and it says so.
    missing = []
    for span in PROGRAM:
        value = read(run_of(synthetic(extra={span: []})))
        if value is None and f"no {span} span" in capsys.readouterr().err:
            missing.append(span)
    assert missing
    # A device event in the requests whose launch call is not in the trace.
    assert read(run_of(synthetic(unlinked=[(5.0, 5.1)]))) is None
    assert "without their issuing call" in capsys.readouterr().err
    # No kernel (no card), no program span (a program that opens none),
    # no trace (an untraced run).
    assert read(run_of(synthetic(kernels=[]))) is None
    bare = synthetic()
    bare.program = ()
    assert read(run_of(bare)) is None
    run = run_of(synthetic())
    run.trace = None
    assert read(run) is None
    # A run that carries no program trace: the reader does not look for
    # one elsewhere, not even under a running profiler.
    run = run_of(synthetic())
    run.program = None
    with profile(activities=[ProfilerActivity.CPU]):
        assert read(run) is None
    assert "no program trace in the run" in capsys.readouterr().err


def random_nested(rng, names, depth=0, lo=0.0, hi=100.0):
    """Spans that nest as calls do: each level's spans inside one of the
    level above's, in order."""
    out = {n: [] for n in names}
    if depth == len(names):
        return out
    t = lo
    while True:
        s = t + rng.uniform(0.0, (hi - lo) / 4)
        e = s + rng.uniform(0.0, (hi - lo) / 3)
        if e >= hi:
            break
        out[names[depth]].append((s, e))
        inner = random_nested(rng, names, depth + 1, s, e)
        for n in names:
            out[n] += inner[n]
        t = e
    return out


def random_gaps(rng, count=400, hi=100.0):
    gs = np.sort(rng.uniform(-5.0, hi + 5.0, count))
    return gs, gs + rng.uniform(0.0, 0.2, count)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gaps_named_as_before_on_the_benchmarks_spans_alone(seed):
    rng = np.random.default_rng(seed)
    sp = random_nested(rng, list(tracing.SPANS))
    gs, ge = random_gaps(rng)
    got = dict(spans.name_gaps(gs, ge, sp))
    want = dict(tracing.name_gaps(gs, ge, sp))
    assert set(got) == set(want)
    assert got == pytest.approx(want, rel=1e-12)
    # The accepted test's case.
    sp = {"request": [(0.0, 10.0)], "solver.compute": [(2.0, 9.0)],
          "op.apply": [(3.0, 4.0), (6.0, 7.0)]}
    gs = np.array([1.0, 3.2, 4.5, 6.5, 9.5, 10.5])
    ge = np.array([1.5, 3.4, 5.5, 6.7, 9.7, 11.0])
    assert dict(spans.name_gaps(gs, ge, sp)) == pytest.approx(dict(tracing.name_gaps(gs, ge, sp)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_program_spans_fold_back_to_the_benchmarks_totals(seed):
    rng = np.random.default_rng(seed)
    # request > solver.compute > irlm.restart > krylov.step > cheb.filter > op.apply
    chain = ["request", "solver.compute", "irlm.restart", "krylov.step",
             "cheb.filter", "op.apply"]
    sp = random_nested(rng, chain)
    sp.update({"solver.init": [], "jd.iteration": []})
    gs, ge = random_gaps(rng)
    named = spans.name_gaps(gs, ge, sp)
    keys = {k for k, _ in named}
    assert any(k.startswith("solver.compute/") for k in keys)
    assert {k.split("/")[-1] for k in keys} <= set(chain) | {"outside"}
    bench = {k: v for k, v in sp.items() if k in tracing.SPANS}
    assert dict(spans.fold(named)) == pytest.approx(dict(tracing.name_gaps(gs, ge, bench)),
                                                    rel=1e-12)
    total = sum(ge - gs)
    assert sum(v for _, v in named) == pytest.approx(total)


def test_gaps_go_to_the_span_that_started_last():
    sp = {"request": [(0.0, 10.0)], "solver.init": [(0.5, 3.0)],
          "solver.compute": [(3.0, 9.0)], "op.apply": [(1.2, 1.4), (5.0, 5.5)],
          "cheb.bounds": [(1.0, 2.0)], "irlm.restart": [(4.0, 8.0)],
          "krylov.step": [(1.1, 1.6), (4.5, 6.0)], "cheb.filter": [(4.8, 5.8)]}
    gs = np.array([0.1, 0.6, 1.05, 1.15, 1.3, 1.5, 3.5, 4.2, 4.6, 4.9, 5.2, 5.9, 8.5])
    ge = gs + 0.02
    named = dict(spans.name_gaps(gs, ge, sp))
    assert named == pytest.approx({
        "request": 0.02, "solver.init": 0.02, "solver.init/cheb.bounds": 0.02,
        "solver.init/krylov.step": 0.04, "op.apply": 0.04,
        "solver.compute": 0.04, "solver.compute/irlm.restart": 0.02,
        "solver.compute/krylov.step": 0.04, "solver.compute/cheb.filter": 0.02})


def test_inside_takes_the_union_of_overlapping_spans():
    got = spans.inside([0.5, 1.5, 2.5, 3.0, 4.5, 9.0],
                       [(1.0, 2.0), (1.8, 3.0), (4.0, 5.0)])
    assert got.tolist() == [False, True, True, False, True, False]
    assert spans.inside([1.0], []).tolist() == [False]


def test_reduce_keeps_the_programs_and_the_benchmarks_spans():
    import spectra_tpu_torch as stt
    import scipy.sparse as sps

    g = 12
    t = sps.diags([-np.ones(g - 1), 2.0 * np.ones(g), -np.ones(g - 1)], [-1, 0, 1])
    op = stt.SparseSymMatProd.from_full(sps.kronsum(t, t).tocsr(), device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("request"):
            s = stt.ChebSymEigsSolver(op, nev=3, ncv=10, which="largest", degree=6,
                                      cut_fraction=0.1)
            s.init(torch.ones(g * g, dtype=torch.float64))
            s.compute(maxit=40)
    pt = spans.reduce(prof)
    assert pt.program == spans.program_span_names() and "cheb.filter" in pt.program
    assert len(pt.spans["cheb.filter"]) == s.num_operations()
    assert len(pt.spans["request"]) == 1 and pt.window() == pt.spans["request"][0]
    assert len(pt.spans["irlm.restart"]) == s.num_iterations() - 1
    # No card: no device work, and nothing unlinked.
    assert pt.kernels == [] and pt.reads == [] and pt.unlinked == []
    # The accepted reduction keeps the benchmark's spans alone.
    assert set(tracing.reduce(prof).spans) == set(tracing.SPANS)


@pytest.mark.parametrize("kind,cell", benches.cells())
def test_a_cpu_traced_run_reads_the_counters_and_says_why_spans_read_nothing(
        kind, cell, roots, capsys):
    root = roots[kind]
    bench = manifest.load(root)
    cfg, mix = manifest.tiny(cell, root)
    r = harness.run_cell(cell, 2 ** 31 + 99, 0.3, True, device="cpu",
                         config_overrides=cfg, traffic_overrides=mix, root=root)
    assert r["correct"]
    per = manifest.metrics_of(bench, cell, "per_layer")
    # No card: the counters read, the device trace and the program's
    # spans find no kernel, and the span metrics say so.
    assert set(r["metrics"]) == {m["name"] for m in per if m["source"] == "program_counter"}
    err = capsys.readouterr().err
    for m in per:
        if m["source"] == "program_span":
            assert f"{m['name']}: no device kernel in the trace: not reported" in err


def test_span_metrics_keep_the_manifests_contract():
    cells = {c["name"] for c in BENCH["workloads"]}
    assert SPAN_METRICS
    for m in SPAN_METRICS:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["workloads"] and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            e2e = {e["name"] for e in manifest.metrics_of(BENCH, cell, "end_to_end")}
            assert m["moves"] in e2e
        assert callable(manifest.reader(m["name"]))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_a_traced_run_on_the_card_reports_the_span_metrics(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run([sys.executable, "eigbench/run.py", "--workload", cell,
                          "--seed", "4100000001", "--seconds", "1", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"]
    got = {k: v["value"] for k, v in result["metrics"].items()}
    want = {m["name"] for m in SPAN_METRICS if cell in m["workloads"]}
    assert want <= set(got), out.stderr[-4000:]
    for name in want:
        assert got[name] > 0
        if next(m for m in SPAN_METRICS if m["name"] == name)["unit"] == "%":
            assert got[name] <= 100.0
    assert "spans: idle s by innermost span:" in out.stderr
    # The idle gaps are named by the program's spans.
    program = spans.program_span_names()
    assert any(k.rpartition("/")[2] in program for k, _ in result["breakdown"]["idle_gaps"])
