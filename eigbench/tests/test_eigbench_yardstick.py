"""The frozen arithmetic (K1's bytes, peaks by card) and the trace reduction's interval arithmetic, on hand counts."""

import numpy as np
import pytest

from eigbench import manifest, tracing, yardstick
from eigbench.harness import Run
from eigbench.traffic import Answer


def test_k1_bytes_of_a_vector_and_of_a_block():
    # d = 5, n = 10^6, f64: 5 diagonals of 10^6, x and y of 10^6, 5 offsets.
    assert yardstick.k1_bytes(5, 10 ** 6, 10 ** 6, 1, 8) == 8 * (5 + 1 + 1) * 10 ** 6 + 40
    # 10 columns: x and y are 10 wide, the diagonals are read once.
    assert yardstick.k1_bytes(5, 10 ** 6, 10 ** 6, 10, 8) == 8 * (5 + 10 + 10) * 10 ** 6 + 40
    # A rectangular f32 level: 9 diagonals, 250,000 rows, 251,000 columns.
    assert yardstick.k1_bytes(9, 250_000, 251_000, 1, 4) == \
        4 * (9 * 250_000 + 251_000 + 250_000) + 72
    assert yardstick.k1_flops(5, 10 ** 6, 10) == 10 ** 8


def test_k1_bound_is_bytes_over_the_bandwidth_on_an_h100():
    rates = yardstick.card_rates("NVIDIA H100 80GB HBM3")
    assert rates == (3.35e12, 33.5e12, 66.9e12)
    bound = yardstick.k1_bound_s(5, 10 ** 6, 10 ** 6, 1, 8, rates)
    assert bound == pytest.approx(56_000_040 / 3.35e12)
    assert yardstick.card_rates("NVIDIA H100 PCIe")[0] == 2.0e12
    assert yardstick.card_rates("NVIDIA H100 NVL")[0] == 3.9e12
    with pytest.raises(KeyError):
        yardstick.card_rates("NVIDIA A100-SXM4-80GB")


def test_k1_kernels_are_told_by_name():
    assert yardstick.is_k1("void spectra_dia::dia_rows_kernel<double, 5, true, false>(...)")
    assert yardstick.is_k1("void spectra_dia::dia_block_kernel<double, 2, 5>(...)")
    assert not yardstick.is_k1("void at::native::vectorized_elementwise_kernel<4>(...)")


def test_busy_time_merges_overlaps_and_clips_to_the_window():
    iv = [(1.0, 2.0), (1.5, 3.0), (5.0, 6.0), (5.2, 5.4), (-1.0, 0.5), (9.0, 12.0)]
    s, e = tracing.merged(iv, 0.0, 10.0)
    assert s.tolist() == [0.0, 1.0, 5.0, 9.0] and e.tolist() == [0.5, 3.0, 6.0, 10.0]
    assert tracing.busy(iv, 0.0, 10.0) == pytest.approx(0.5 + 2.0 + 1.0 + 1.0)
    assert tracing.busy([], 0.0, 10.0) == 0.0
    gs, ge = tracing.idle_gaps(iv, 0.0, 10.0)
    assert gs.tolist() == [0.5, 3.0, 6.0] and ge.tolist() == [1.0, 5.0, 9.0]
    # Touching intervals leave no gap.
    gs, ge = tracing.idle_gaps([(0.0, 1.0), (1.0, 2.0)], 0.0, 2.0)
    assert len(gs) == 0


def test_gaps_are_named_by_the_innermost_open_span():
    spans = {"request": [(0.0, 10.0)], "solver.compute": [(2.0, 9.0)],
             "op.apply": [(3.0, 4.0), (6.0, 7.0)]}
    gs = np.array([1.0, 3.2, 4.5, 6.5, 9.5, 10.5])
    ge = np.array([1.5, 3.4, 5.5, 6.7, 9.7, 11.0])
    named = dict(tracing.name_gaps(gs, ge, spans))
    assert named == pytest.approx({"request": 0.5 + 0.2, "op.apply": 0.2 + 0.2,
                                   "solver.compute": 1.0, "outside": 0.5})


def answer(calls, launches, iterations=3):
    return Answer(values=None, vectors=None, nconv=10, successful=True,
                  iterations=iterations, operations=7, k1_launches=launches,
                  calls=calls, wall_s=1.0)


def synthetic_run(kernels, ledger, launches):
    trace = tracing.Trace(kernels=kernels, copies=[(0.5, 0.6)],
                          spans={"request": [(0.0, 1.0)]}, skipped={})
    return Run(answers=[answer(ledger, launches)],
               traced=[answer(ledger, launches)], trace=trace,
               rates=yardstick.card_rates("H100"))


def test_k1_roofline_and_idle_readers_on_a_synthetic_trace():
    # Each cell's share is read by the one reader of its quantity.
    k1 = manifest.reader("k1_roofline.lap2d_cheb_largest10")
    idle = manifest.reader("device_idle_pct.band5_davidson_largest10")
    bound = yardstick.k1_bound_s(5, 10 ** 6, 10 ** 6, 1, 8, yardstick.card_rates("H100"))
    kernels = [("void spectra_dia::dia_rows_kernel<double, 5>", 0.1, 0.1 + 2 * bound),
               ("void spectra_dia::dia_rows_kernel<double, 5>", 0.2, 0.2 + 2 * bound),
               ("void gemv_kernel", 0.3, 0.4)]
    run = synthetic_run(kernels, [((5, 10 ** 6, 10 ** 6, 8), {1: 2})], 2)
    assert k1(run) == pytest.approx(50.0)
    busy = 4 * bound + 0.1 + 0.1
    assert idle(run) == pytest.approx(100.0 * (1.0 - busy))
    # Counts that disagree with the trace or the program report nothing.
    assert k1(synthetic_run(kernels, [((5, 10 ** 6, 10 ** 6, 8), {1: 3})], 3)) is None
    assert k1(synthetic_run(kernels, [((5, 10 ** 6, 10 ** 6, 8), {1: 2})], 5)) is None
    assert k1(synthetic_run(kernels[2:], [], 0)) is None
    empty = synthetic_run([], [], 0)
    assert idle(empty) is None and k1(empty) is None
