"""Kernel K1: its share of its roofline over the profiled requests, in %.

The sum over K1's launches of each launch's least time on this card
(``yardstick.k1_bound_s``: its bytes over the bandwidth, or its
operations over the peak, whichever is larger) over the sum of the
device time of K1's kernels in the trace. The launches' shapes come
from the products counted on each operator over a DIA matrix
(``traffic.CountingOp``); they must add up to the program's own count
(``ops.dia_spmv.LAUNCHES``) and to the K1 kernels in the trace, or
nothing is reported (as where the operator launches K1 inside it, in
an inner solve)."""

import sys

from eigbench import yardstick


def read(run):
    if run.trace is None or run.rates is None or not run.traced:
        return None
    ledger = [(*shape, ncol, k) for a in run.traced
              for shape, calls in a.calls for ncol, k in calls.items()]
    counted = sum(row[-1] for row in ledger)
    program = sum(a.k1_launches for a in run.traced)
    k1 = [(s, e) for name, s, e in run.trace.kernels if yardstick.is_k1(name)]
    if not k1 or counted != program or counted != len(k1):
        print(f"k1_roofline: {counted} launches counted, {program} by the "
              f"program, {len(k1)} in the trace: not reported", file=sys.stderr)
        return None
    bound = sum(k * yardstick.k1_bound_s(d, n_rows, n_cols, ncol, item, run.rates)
                for d, n_rows, n_cols, item, ncol, k in ledger)
    device = sum(e - s for s, e in k1)
    return 100.0 * bound / device
