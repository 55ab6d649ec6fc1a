"""JD host loop: host milliseconds inside the program's ``jd.eigh``
spans (the host eigh of the Rayleigh matrix, one a Rayleigh-Ritz step)
over the number of those spans, in the profiled requests. A trace
without the JD loop's ``jd.iteration`` spans, or without ``jd.eigh``
spans (a program that opens none), reports nothing."""

import sys

from eigbench import spans

NAME = "jd_eigh_ms"


def read(run):
    pt = spans.of_run(run, NAME)
    if pt is None:
        return None
    for name in ("jd.iteration", "jd.eigh"):
        if not pt.spans.get(name):
            print(f"{NAME}: no {name} span in the trace: not reported", file=sys.stderr)
            return None
    eighs = pt.spans["jd.eigh"]
    return 1e3 * sum(e - s for s, e in eighs) / len(eighs)
