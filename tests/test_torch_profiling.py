"""The port's spans (``spectra_tpu_torch.util.profiling``) on the CPU.

Under a CPU ``torch.profiler`` a Chebyshev-filtered solve and a
Davidson solve (``LargestAlge`` and ``BothEnds``) record their spans at
the layer boundaries, as many as the solver's counters imply and nested
as the calls are (one host eigh a Rayleigh-Ritz, held to one BLAS thread);
with no profiler running a span opens no ``record_function``; the
results are bitwise the same with the profiler on and off; ``SPANS``
names every span the program opens.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sps
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import spectra_tpu_torch as stt
from spectra_tpu_torch.util import blas_threads, profiling

torch.set_num_threads(1)

PACKAGE = Path(stt.__file__).resolve().parent


def laplacian_2d(g):
    t = sps.diags([-np.ones(g - 1), 2.0 * np.ones(g), -np.ones(g - 1)], [-1, 0, 1])
    return sps.kronsum(t, t).tocsr()


def diag_dominant(n, seed=42):
    rng = np.random.RandomState(seed)
    A = rng.uniform(size=(n, n)) - 0.5
    A = (A + A.T) * 0.5
    np.fill_diagonal(A, np.arange(1.0, n + 1) + np.abs(A).sum(axis=1))
    return A


def cheb_solve():
    """Config #2's solver at g = 20: the stepped driver, four restarts."""
    op = stt.SparseSymMatProd.from_full(laplacian_2d(20), device="cpu")
    s = stt.ChebSymEigsSolver(op, nev=6, ncv=14, which="largest", degree=10,
                              cut_fraction=0.05)
    s.set_restart_chunk(2)
    s.init(torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, 400)))
    nconv = s.compute(maxit=60)
    return s, nconv


def thick_solve():
    """The thick restart of the IRLM on a small Laplacian."""
    op = stt.SparseSymMatProd.from_full(laplacian_2d(12), device="cpu")
    s = stt.SymEigsSolver(op, 4, 12)
    s.set_restart_method("thick")
    s.init(torch.from_numpy(np.random.default_rng(2).uniform(-0.5, 0.5, 144)))
    nconv = s.compute(stt.SortRule.LargestAlge, maxit=200)
    return s, nconv


def davidson_solve(rule):
    """Davidson with a small maximal space, so that it collapses."""
    op = stt.DenseSymMatProd.create(diag_dominant(120), device="cpu")
    s = stt.DavidsonSymEigsSolver(op, nev=3, nvec_max=12)
    nconv = s.compute(getattr(stt.SortRule, rule), maxit=100, tol=1e-10)
    return s, nconv


def profiled(fn, *args):
    """``fn(*args)`` under a CPU profiler; (its result, {span: [(start,
    end)]} sorted by start, in ns)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(*args)
    spans = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CPU and ev.name() in profiling.SPANS:
            spans.setdefault(ev.name(), []).append((ev.start_ns(), ev.end_ns()))
    return out, {k: sorted(v) for k, v in spans.items()}


def within(inner, outers):
    """Whether the interval ``inner`` lies in one of ``outers``."""
    return any(s <= inner[0] and inner[1] <= e for s, e in outers)


def test_chebyshev_solve_records_its_spans():
    (s, nconv), spans = profiled(cheb_solve)
    assert nconv == 6 and s.info() == stt.CompInfo.Successful
    restarts = s.num_iterations() - 1
    assert restarts >= 3
    assert len(spans["cheb.filter"]) == s.num_operations()
    assert len(spans["irlm.restart"]) == restarts
    assert len(spans["irlm.shifts"]) == len(spans["irlm.compress"]) == restarts
    assert len(spans["irlm.ritz"]) == restarts + 1
    for name in ("cheb.bounds", "irlm.start", "irlm.finalize", "cheb.rayleigh"):
        assert len(spans[name]) == 1, name
    # The bounds' Lanczos run comes first, in the constructor.
    assert spans["cheb.bounds"][0][1] <= spans["irlm.start"][0][0]
    assert spans["irlm.finalize"][0][1] <= spans["cheb.rayleigh"][0][0]
    # Every Lanczos step lies in the bounds' run, the start or a restart,
    # and every filtered product in a step of the solve.
    drivers = spans["cheb.bounds"] + spans["irlm.start"] + spans["irlm.restart"]
    assert all(within(st, drivers) for st in spans["krylov.step"])
    solve = spans["irlm.start"] + spans["irlm.restart"]
    assert sum(within(st, solve) for st in spans["krylov.step"]) > restarts
    steps = spans["krylov.step"]
    assert all(within(f, steps) or within(f, spans["irlm.start"])
               for f in spans["cheb.filter"])
    assert all(within(r, steps) for r in spans["krylov.reorth"])
    for name in ("irlm.shifts", "irlm.compress", "irlm.ritz"):
        assert all(within(x, solve) for x in spans[name]), name


def test_thick_restart_records_its_spans():
    (s, nconv), spans = profiled(thick_solve)
    assert nconv == 4
    restarts = s.num_iterations() - 1
    assert restarts >= 1
    assert len(spans["irlm.restart"]) == len(spans["irlm.shifts"]) == restarts
    assert "irlm.compress" not in spans
    assert all(within(x, spans["irlm.restart"]) for x in spans["irlm.shifts"])


@pytest.mark.parametrize("rule", ["LargestAlge", "BothEnds"])
def test_davidson_solve_records_one_iteration_span_an_iteration(rule):
    (s, nconv), spans = profiled(davidson_solve, rule)
    assert nconv == 3 and s.info() == stt.CompInfo.Successful
    iterations = spans["jd.iteration"]
    assert len(iterations) == s.num_iterations() > 10
    assert spans.get("jd.collapse")  # the space restarted
    for k, it in enumerate(iterations):
        def held(name):
            return sum(s >= it[0] and e <= it[1] for s, e in spans.get(name, []))

        assert held("jd.rayleigh_ritz") == held("jd.residual") == 1
        last = k == len(iterations) - 1
        assert held("jd.correction") == held("jd.orthogonalize") == (0 if last else 1)
    assert all(within(x, iterations) for x in spans["jd.collapse"])


@pytest.mark.parametrize("rule", ["LargestAlge", "BothEnds"])
def test_davidson_opens_one_eigh_span_a_rayleigh_ritz(rule):
    (s, nconv), spans = profiled(davidson_solve, rule)
    assert nconv == 3
    rr, eighs = spans["jd.rayleigh_ritz"], spans["jd.eigh"]
    # The initial Rayleigh-Ritz lies outside the iterations; every one
    # holds one eigh, and every eigh one limit.
    assert len(rr) == len(eighs) >= s.num_iterations()
    for outer in rr:
        assert sum(within(e, [outer]) for e in eighs) == 1
    one = spans.get("eigh.one_thread", [])
    held = blas_threads.pool() is not None  # numpy carries an OpenBLAS
    assert len(one) == held * len(eighs)
    for e in eighs:
        assert sum(within(x, [e]) for x in one) == held


def test_spans_open_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert profiling.span("krylov.step") is profiling.span("jd.iteration")
    s, nconv = cheb_solve()
    assert nconv == 6
    s, nconv = davidson_solve("LargestAlge")
    assert nconv == 3
    s, nconv = davidson_solve("BothEnds")
    assert nconv == 3
    # Under a profiler the same span is the profiler's range.
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="krylov.step"):
            profiling.span("krylov.step")


@pytest.mark.parametrize("case", ["cheb", "thick", "davidson_LargestAlge",
                                  "davidson_BothEnds"])
def test_results_are_bitwise_the_same_with_the_profiler_on(case):
    def solve():
        if case == "cheb":
            return cheb_solve()
        if case == "thick":
            return thick_solve()
        return davidson_solve(case.split("_")[1])

    def outcome(s, nconv):
        vecs = s.eigenvectors()
        return (nconv, s.info(), s.num_iterations(), s.num_operations(),
                np.asarray(s.eigenvalues()).tobytes(),
                np.asarray(torch.as_tensor(vecs)).tobytes())

    off = outcome(*solve())
    (s, nconv), spans = profiled(solve)
    assert spans
    assert outcome(s, nconv) == off


def test_trace_names_the_programs_spans(tmp_path):
    with profiling.trace(str(tmp_path / "tr")):
        s, nconv = cheb_solve()
    assert nconv == 6
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"cheb.bounds", "cheb.filter", "krylov.step", "irlm.start",
            "irlm.restart", "cheb.rayleigh"} <= names


def test_spans_names_every_span_the_program_opens():
    opened = set()
    for path in PACKAGE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "span" and node.args
                    and isinstance(node.args[0], ast.Constant)):
                opened.add(node.args[0].value)
    assert len(set(profiling.SPANS)) == len(profiling.SPANS)
    assert opened == set(profiling.SPANS)
