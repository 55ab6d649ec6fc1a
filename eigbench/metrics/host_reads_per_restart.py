"""Driver: device-to-host copies issued inside the program's
``irlm.restart`` spans over the number of those spans (one a restart
of the Lanczos iteration), in the profiled requests."""

from eigbench import spans


def read(run):
    return spans.read_metric(run, "host_reads_per_restart",
                             spans.reads_per_span, "irlm.restart")
