"""The JD host loop's eigh metrics, ``jd_eigh_ms`` and
``jd_eigh_one_thread_pct``, on synthetic program traces: the right
number where the trace holds the JD loop's ``jd.eigh`` spans (and the
``eigh.one_thread`` spans inside some of them), nothing and a reason
where it lacks them, as the trace of a program older than these spans
does.
"""

import pytest

from eigbench import manifest, spans, tracing, yardstick
from eigbench.harness import Run
from eigbench.traffic import Answer

METRICS = ("jd_eigh_ms", "jd_eigh_one_thread_pct")
PROGRAM = ("jd.iteration", "jd.rayleigh_ritz", "jd.eigh", "eigh.one_thread")


def synthetic(eighs, one_thread, iterations=((1.0, 3.0), (3.0, 5.0), (5.0, 7.0))):
    sp = {"request": [(0.0, 10.0)], "solver.compute": [(0.5, 9.0)],
          "jd.iteration": list(iterations),
          "jd.rayleigh_ritz": [(s - 0.05, e + 0.05) for s, e in eighs],
          "jd.eigh": list(eighs), "eigh.one_thread": list(one_thread)}
    ks = [(f"k{i}", at, at + 0.001, at + 0.002) for i, at in enumerate((1.5, 3.5, 5.5))]
    return spans.ProgramTrace(spans=sp, kernels=ks, reads=[], unlinked=[],
                              program=PROGRAM)


def run_of(pt):
    answer = Answer(values=None, vectors=None, nconv=10, successful=True,
                    iterations=3, operations=7, k1_launches=0, calls=[], wall_s=1.0)
    trace = tracing.Trace(kernels=[], copies=[],
                          spans={k: v for k, v in pt.spans.items() if k in tracing.SPANS},
                          skipped={})
    return Run(answers=[answer], traced=[answer], trace=trace,
               rates=yardstick.card_rates("H100"), program=pt)


def test_the_manifest_registers_both():
    bench = manifest.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = entries[name]
        assert (m["source"], m["layer"], m["moves"], m["workloads"]) == (
            "program_span", "JD host loop", "solve_s.band5_davidson_largest10",
            ["band5_davidson_largest10"])
    assert (entries["jd_eigh_ms"]["unit"], entries["jd_eigh_ms"]["better"]) == ("ms/call", "lower")
    assert (entries["jd_eigh_one_thread_pct"]["unit"],
            entries["jd_eigh_one_thread_pct"]["better"]) == ("%", "higher")


def test_each_reads_its_number_on_a_synthetic_trace():
    # Four eighs of 2, 4, 1 and 1 ms; three hold a one-thread span, and
    # the fourth's lies outside it.
    eighs = [(0.9, 0.902), (1.2, 1.204), (3.2, 3.201), (5.2, 5.201)]
    one = [(0.9005, 0.9015), (1.2001, 1.2039), (3.2001, 3.2009), (5.1, 5.3)]
    run = run_of(synthetic(eighs, one))
    assert manifest.reader("jd_eigh_ms")(run) == pytest.approx(2.0, rel=1e-9)
    assert manifest.reader("jd_eigh_one_thread_pct")(run) == pytest.approx(75.0)
    # Every eigh on one thread; none.
    every = run_of(synthetic(eighs, [(s + 1e-5, e - 1e-5) for s, e in eighs]))
    assert manifest.reader("jd_eigh_one_thread_pct")(every) == pytest.approx(100.0)
    assert manifest.reader("jd_eigh_one_thread_pct")(run_of(synthetic(eighs, []))) == 0.0


@pytest.mark.parametrize("metric", METRICS)
def test_each_reports_nothing_and_says_why_without_its_spans(metric, capsys):
    read = manifest.reader(metric)
    eighs = [(1.2, 1.204)]
    # A program that opens no jd.eigh span.
    assert read(run_of(synthetic([], []))) is None
    assert f"{metric}: no jd.eigh span in the trace: not reported" in capsys.readouterr().err
    # No JD loop in the trace.
    assert read(run_of(synthetic(eighs, eighs, iterations=()))) is None
    assert f"{metric}: no jd.iteration span in the trace: not reported" in capsys.readouterr().err
    # No kernel (no card), no program span, no trace, no program trace.
    pt = synthetic(eighs, eighs)
    pt.kernels = []
    assert read(run_of(pt)) is None
    assert "no device kernel in the trace" in capsys.readouterr().err
    bare = synthetic(eighs, eighs)
    bare.program = ()
    assert read(run_of(bare)) is None
    run = run_of(synthetic(eighs, eighs))
    run.trace = None
    assert read(run) is None
    run = run_of(synthetic(eighs, eighs))
    run.program = None
    assert read(run) is None
    assert "no program trace in the run" in capsys.readouterr().err
