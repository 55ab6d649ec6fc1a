"""JD host loop: the share of the program's ``jd.eigh`` spans that hold
an ``eigh.one_thread`` span (the eigh ran with numpy's BLAS pool held to
the calling thread), in %, over the profiled requests. A trace without
the JD loop's ``jd.iteration`` spans, or without ``jd.eigh`` spans (a
program that opens none), reports nothing."""

import sys

from eigbench import spans

NAME = "jd_eigh_one_thread_pct"


def read(run):
    pt = spans.of_run(run, NAME)
    if pt is None:
        return None
    for name in ("jd.iteration", "jd.eigh"):
        if not pt.spans.get(name):
            print(f"{NAME}: no {name} span in the trace: not reported", file=sys.stderr)
            return None
    eighs = pt.spans["jd.eigh"]
    held = pt.spans.get("eigh.one_thread") or []
    n = sum(any(s <= a and b <= e for a, b in held) for s, e in eighs)
    return 100.0 * n / len(eighs)
