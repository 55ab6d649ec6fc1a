"""Chebyshev filter: kernels launched inside the program's
``cheb.filter`` spans over the number of those spans (one a filtered
product), in the profiled requests; each kernel is put down to the span
open when its launch call ran (``spans.py``)."""

from eigbench import spans


def read(run):
    return spans.read_metric(run, "filter_launches_per_apply",
                             spans.launches_per_span, "cheb.filter")
