"""Chebyshev filter: host microseconds inside the program's
``cheb.filter`` spans over the kernels launched inside them, in the
profiled requests. Traced: the profiler's callbacks lengthen every
launch call, so it reads above an untraced run's pace."""

from eigbench import spans


def read(run):
    return spans.read_metric(run, "filter_host_us_per_launch",
                             spans.host_us_per_launch, "cheb.filter")
