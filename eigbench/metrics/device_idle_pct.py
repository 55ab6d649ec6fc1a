"""Device: the share of the profiled requests' span (first start to
last end, host clock) in which no kernel, copy or set ran on the card,
in %."""

from eigbench import tracing


def read(run):
    if run.trace is None or not run.trace.kernels:
        return None
    window = run.trace.window()
    if window is None:
        return None
    lo, hi = window
    return 100.0 * (1.0 - tracing.busy(run.trace.device_intervals(), lo, hi) / (hi - lo))
