"""Each cell end to end on the CPU at its tiny size (``tiny/<cell>.json``,
the port's plain kernels), the comparison on perturbed answers, the
float32 control, runs whose timed path is broken underneath (each must
read ``correct`` false), and the generator's data form on solver calls
that no cell makes yet. The cells are those of ``BENCHMARK.json`` and
the non-symmetric cell of ``benches.py``'s copy."""

import dataclasses

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sps
import torch

import benches
from eigbench import harness, manifest, traffic
from eigbench.reference.compare import compare, fails
from eigbench.reference.control import control_numbers

CELLS = benches.cells()
SEED = 2 ** 31 + 12345


def run(root, cell, trace=0, seconds=0.3, seed=SEED):
    cfg, mix = manifest.tiny(cell, root)
    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            config_overrides=cfg, traffic_overrides=mix, root=root)


def counters(bench, cell):
    """The per-layer metrics that a traced CPU run of ``cell`` reports:
    the program's counters; the device trace and the program's spans
    have nothing to read without a card."""
    return {m["name"] for m in manifest.metrics_of(bench, cell, "per_layer")
            if m["source"] == "program_counter"}


@pytest.mark.parametrize("kind,cell", CELLS)
def test_cell_runs_and_is_correct(kind, cell, roots):
    r = run(roots[kind], cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    bench = manifest.load(roots[kind])
    assert set(r["metrics"]) == {m["name"] for m in manifest.metrics_of(bench, cell, "end_to_end")}
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert list(r)[-1] == "checks"
    limits = manifest.limits(cell, roots[kind])
    assert set(r["checks"]) == set(limits)
    for k, c in r["checks"].items():
        assert c["limit"] == limits[k] and c["value"] <= c["limit"]


@pytest.mark.parametrize("kind,cell", CELLS)
def test_traced_run_reports_its_counters(kind, cell, roots):
    r = run(roots[kind], cell, trace=1)
    assert r["correct"]
    want = counters(manifest.load(roots[kind]), cell)
    # No card: the device trace has nothing to read, and says nothing.
    assert want and set(r["metrics"]) == want
    assert all(r["metrics"][k]["value"] > 0 for k in want)
    assert "busy_s" not in r["device"] and "breakdown" not in r


def test_seeds_draw_different_starts_and_a_seed_repeats():
    a = traffic.start_vector((2 ** 33 + 7, 0), 50, torch.float64, "cpu")
    b = traffic.start_vector((2 ** 33 + 7, 0), 50, torch.float64, "cpu")
    c = traffic.start_vector((2 ** 33 + 8, 0), 50, torch.float64, "cpu")
    d = traffic.start_vector((2 ** 33 + 7, 1), 50, torch.float64, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)
    assert float(a.abs().max()) <= 0.5
    traffic.start_vector((-3, 0), 5, torch.float64, "cpu")  # any whole seed


def reference_answer(root, cell):
    """The cell's operands, reference pairs at its tiny size, shift and
    comparison."""
    bench = manifest.load(root)
    entry = manifest.workload(bench, cell)
    cfg, mod = manifest.config(bench, entry["config"], root)
    cfg = {**cfg, **manifest.tiny(cell, root)[0]}
    want = manifest.traffic(entry["traffic"], root)["wanted"]
    sigma = float(want.get("sigma", 0.0))
    vals, vecs = mod.reference(cfg, int(want["nev"]), want["which"], sigma)
    return manifest.operands(mod, cfg), vals, vecs, sigma, manifest.comparison(mod)


@pytest.mark.parametrize("kind,cell", CELLS)
def test_comparison_passes_the_reference_and_fails_perturbed_answers(kind, cell, roots):
    A, vals, vecs, sigma, cmp = reference_answer(roots[kind], cell)
    limits = manifest.limits(cell, roots[kind])
    n = len(vals)
    assert fails(cmp(A, vals, vals, vecs, n, True, sigma), limits) == []
    bad = vals.copy()
    bad[3] *= 1 + 1e-7
    assert "value_err" in fails(cmp(A, vals, bad, vecs, n, True, sigma), limits)
    U = vecs.copy()
    U[7, 2] += 1e-6
    assert "residual" in fails(cmp(A, vals, vals, U, n, True, sigma), limits)
    got = fails(cmp(A, vals, vals[:-1], vecs[:, :-1], n - 1, True, sigma), limits)
    assert "missing_pairs" in got
    assert fails(cmp(A, vals, vals, vecs, n, False, sigma), limits) == [
        "not_successful"]


@pytest.mark.parametrize("kind,cell", CELLS)
def test_float32_control_fails_the_cells_limits(kind, cell, roots):
    root = roots[kind]
    tiny = manifest.tiny(cell, root)[0]
    nums = control_numbers(cell, config_overrides=tiny, root=root)
    assert fails(nums, manifest.limits(cell, root))
    # The same reference in float64 passes.
    f64 = control_numbers(cell, dtype=np.float64, config_overrides=tiny, root=root)
    assert fails(f64, manifest.limits(cell, root)) == []


class BrokenOp:
    """The cell's operator with its product broken."""

    def __init__(self, op, fault):
        self._op, self._fault = op, fault

    def __getattr__(self, name):
        return getattr(self._op, name)

    def perform_op(self, x):
        if self._fault == "unchanged":  # a step that returns its state
            return x.clone()
        y = self._op.perform_op(x)  # half of the rows left out
        y[y.shape[0] // 2:] = 0
        return y


def altered(answer):
    """The answer with one value and one vector entry altered."""
    values = answer.values.copy()
    values[0] *= 1 + 1e-6
    vectors = answer.vectors.copy()
    vectors[3, 1] += 1e-6
    return dataclasses.replace(answer, values=values, vectors=vectors)


def dropped(answer):
    """The answer without its last pair."""
    return dataclasses.replace(answer, values=answer.values[:-1],
                               vectors=answer.vectors[:, :-1], nconv=answer.nconv - 1)


@pytest.mark.parametrize("fault", ["unchanged", "half_rows", "altered_answer",
                                   "dropped_pair"])
@pytest.mark.parametrize("kind,cell", CELLS)
def test_a_broken_timed_path_reads_not_correct(kind, cell, fault, roots, monkeypatch):
    build, request = traffic.build, traffic.request
    if fault in ("altered_answer", "dropped_pair"):
        change = altered if fault == "altered_answer" else dropped
        monkeypatch.setattr(traffic, "request",
                            lambda *a, **k: change(request(*a, **k)))
    else:
        def broken_build(mix, *a, **k):
            served = build(mix, *a, **k)
            names = dict(served.names)
            for op in mix["operators"]:  # every operator the traffic builds
                names[op] = BrokenOp(names[op], fault)
            return dataclasses.replace(served, names=names)

        monkeypatch.setattr(traffic, "build", broken_build)
    r = run(roots[kind], cell)
    assert r["correct"] is False and r["failed"] >= 1


def laplacian(g):
    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def serve(mix, operands, key=(SEED, 0)):
    served = traffic.build(mix, operands, "cpu", span=traffic.no_span)
    return traffic.request(mix, served, key, traffic.no_span)


def test_shift_invert_by_multigrid_is_data():
    """Config #3's call (the cell that waits on a program repair) made
    from data alone, and held by the comparison."""
    A = laplacian(48)
    mix = {
        "operators": {"op": {"call": "SparseSymShiftSolve.create", "args": ["$A"],
                             "kwargs": {"method": "mg", "device": "$device"},
                             "then": [["set_shift", [0.0]]]}},
        "solver": {"call": "SymEigsShiftSolver.from_factored",
                   "args": ["$op", 6, 20, 0.0], "then": [["set_restart_chunk", [20]]]},
        "compute": {"selection": "$stt.SortRule.LargestMagn", "maxit": 200,
                    "tol": 1e-10},
        "start": "seeded",
    }
    a = serve(mix, {"A": A})
    assert isinstance(a.vectors, np.ndarray) and a.successful
    ref = np.sort(np.linalg.eigvalsh(A.toarray()))[:6]
    nums = compare({"A": A}, ref, a.values, a.vectors, a.nconv, a.successful)
    assert fails(nums, {"value_err": 1e-9, "residual": 1e-6, "missing_pairs": 0}) == []


def test_generalized_pair_is_data_and_compared_with_b():
    """A generalized problem, ``A u = lambda B u`` (config #5a's form),
    from data alone: the comparison's residual and orthogonality take B."""
    rng = np.random.default_rng(5)
    A = laplacian(12)
    B = sps.diags(1.0 + rng.random(A.shape[0])).tocsr()
    mix = {
        "operators": {
            "op": {"call": "SparseSymMatProd.from_full", "args": ["$A"],
                   "kwargs": {"device": "$device"}},
            "bop": {"call": "SparseCholesky.create", "args": ["$B"],
                    "kwargs": {"device": "$device"}},
        },
        "solver": {"call": "SymGEigsSolver", "args": ["$op", "$bop"],
                   "kwargs": {"nev": 4, "ncv": 20}},
        "compute": {"selection": "$stt.SortRule.LargestAlge", "tol": 1e-10},
        "start": "seeded",
    }
    a = serve(mix, {"A": A, "B": B})
    ref = sla.eigh(A.toarray(), B.toarray(), eigvals_only=True)[-4:]
    limits = {"value_err": 1e-9, "residual": 1e-8, "orthogonality": 1e-9,
              "missing_pairs": 0, "not_successful": 0}
    pair = {"A": A, "B": B}
    assert fails(compare(pair, ref, a.values, a.vectors, a.nconv, a.successful),
                 limits) == []
    # Without B the same answer is not a solution of A u = lambda u.
    assert "residual" in fails(
        compare({"A": A}, ref, a.values, a.vectors, a.nconv, a.successful), limits)


def test_references_resolve_and_unknown_ones_raise():
    names = {"A": 1, "op": "x", "max_diagonal": 4.0}
    got = traffic.resolve({"a": ["$op", {"$mul": [1e-9, "$max_diagonal"]}],
                           "s": "$stt.SortRule.LargestAlge", "n": 3}, names)
    assert got == {"a": ["x", 4e-9], "s": traffic.stt.SortRule.LargestAlge, "n": 3}
    with pytest.raises(KeyError):
        traffic.resolve("$nope", names)
