"""The program's spans in a traced run, and the device work each issued.

``spectra_tpu_torch`` opens named spans at its layer boundaries while a
torch profiler runs (``spectra_tpu_torch.util.profiling.SPANS``).
:func:`reduce` turns a stopped profiler into those spans, the
benchmark's own (``tracing.SPANS``), and the device's kernels and
device-to-host copies, each with the host time of the runtime or
driver call that issued it (``cudaLaunchKernel``, ``cuLaunchKernel``,
``cudaMemcpyAsync``, ...: the call that carries the device event's
correlation id). Device work is put down to the spans that were open
when it was issued; an idle gap of the card to the innermost span open
at its midpoint, the one that started last (:func:`name_gaps`).

The harness reduces a traced run's profiler once and hands the
:class:`ProgramTrace` to the readers in its ``Run`` (``run.program``).
The per-layer metrics of ``BENCHMARK.json`` whose ``source`` is
``program_span`` read it through :func:`read_metric`; one that finds no
program spans (a program that opens none), no device events (no card)
or device work whose issuing call is not in the trace returns None and
says why on standard error.
"""

import dataclasses
import sys

import numpy as np

from eigbench import tracing


@dataclasses.dataclass
class ProgramTrace:
    """Spans and issued device work, in seconds on the profiler's clock."""

    spans: dict  # {span name: [(start, end)]}, the program's and the benchmark's
    kernels: list  # [(name, issued, start, end)]: issued = host start of its launch call
    reads: list  # [(issued, start, end)]: device-to-host copies
    unlinked: list  # [(start, end)] of kernels and copies whose issuing call is absent
    program: tuple = ()  # the program's span names, outermost first

    def window(self):
        """First start to last end of the benchmark's ``request`` spans."""
        req = self.spans.get("request") or []
        if not req:
            return None
        return min(s for s, _ in req), max(e for _, e in req)


def program_span_names():
    """The program's span names, or () where it opens none."""
    from spectra_tpu_torch.util import profiling

    return tuple(getattr(profiling, "SPANS", ()))


def reduce(prof, program=None):
    """The :class:`ProgramTrace` of a stopped ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    program = program_span_names() if program is None else tuple(program)
    events = list(prof.profiler.kineto_results.events())
    issued = {}  # correlation id -> host start of the runtime or driver call
    for ev in events:
        if ev.device_type() == DeviceType.CPU and ev.name().startswith("cu"):
            issued[ev.correlation_id()] = ev.start_ns() * 1e-9
    spans = {name: [] for name in (*tracing.SPANS, *program)}
    kernels, reads, unlinked = [], [], []
    for ev in events:
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            kind = tracing._kind(ev)
            if kind is None:
                continue
            at = issued.get(ev.correlation_id())
            if at is None:
                unlinked.append((start, end))
            elif kind == "kernel":
                kernels.append((ev.name(), at, start, end))
            elif ev.name().startswith("Memcpy DtoH"):
                reads.append((at, start, end))
        elif ev.name() in spans:
            spans[ev.name()].append((start, end))
    return ProgramTrace(spans=spans, kernels=kernels, reads=reads,
                        unlinked=unlinked, program=program)


def _say(metric, why):
    print(f"{metric}: {why}: not reported", file=sys.stderr)


def of_run(run, metric):
    """The :class:`ProgramTrace` of a traced run, or None (said on
    standard error) where ``metric`` has nothing to read."""
    if run.trace is None:
        return None
    pt = run.program
    if pt is None:
        _say(metric, "no program trace in the run")
        return None
    if not pt.program or not any(pt.spans.get(n) for n in pt.program):
        _say(metric, "the program opened no spans")
        return None
    if not pt.kernels:
        _say(metric, "no device kernel in the trace")
        return None
    window = pt.window()
    if window is not None and any(window[0] <= s <= window[1] for s, _ in pt.unlinked):
        _say(metric, f"{len(pt.unlinked)} device events without their issuing call")
        return None
    return pt


def report(pt, named, log=sys.stderr):
    """The card's idle gaps by program span (:func:`name_gaps`'s
    ``named``), folded into the benchmark's spans, and each span's count
    and host seconds, on ``log``."""
    print("spans: idle s by innermost span: "
          + " ".join(f"{k}={v:.6f}" for k, v in named[:24]), file=log)
    print("spans: folded into the benchmark's spans: "
          + " ".join(f"{k}={v:.6f}" for k, v in fold(named)), file=log)
    held = " ".join(f"{k}={len(v)}/{sum(e - s for s, e in v):.6f}"
                    for k, v in pt.spans.items() if v)
    print(f"spans: count/host s {held}; {len(pt.kernels)} kernels, {len(pt.reads)} "
          f"device-to-host reads, {len(pt.unlinked)} unlinked", file=log)


# -- attribution -------------------------------------------------------------


def inside(times, intervals):
    """Whether each of ``times`` lies in one of ``intervals``."""
    times = np.asarray(times, dtype=np.float64)
    if not intervals or not len(times):
        return np.zeros(len(times), dtype=bool)
    lo = min(min(s for s, _ in intervals), float(times.min()))
    hi = max(max(e for _, e in intervals), float(times.max()))
    s, e = tracing.merged(intervals, lo, hi)
    i = np.searchsorted(s, times, side="right") - 1
    return (i >= 0) & (times < e[np.maximum(i, 0)])


def launched_in(pt, name):
    """The kernels issued while a ``name`` span was open."""
    keep = inside([k[1] for k in pt.kernels], pt.spans.get(name) or [])
    return [k for k, y in zip(pt.kernels, keep) if y]


def launches_per_span(pt, name):
    """Kernels issued inside ``name`` spans, over the number of them."""
    iv = pt.spans.get(name) or []
    return len(launched_in(pt, name)) / len(iv) if iv else None


def host_us_per_launch(pt, name):
    """Host microseconds inside ``name`` spans over the kernels issued
    inside them."""
    iv = pt.spans.get(name) or []
    n = len(launched_in(pt, name))
    if not iv or not n:
        return None
    return 1e6 * sum(e - s for s, e in iv) / n


def reads_per_span(pt, name):
    """Device-to-host copies issued inside ``name`` spans, over the
    number of them."""
    iv = pt.spans.get(name) or []
    if not iv:
        return None
    return float(inside([r[0] for r in pt.reads], iv).sum()) / len(iv)


def device_share(pt, part, whole):
    """Device time of the kernels issued inside ``part`` spans over that
    of the kernels issued inside ``whole`` spans, in %."""
    num = sum(e - s for _, _, s, e in launched_in(pt, part))
    den = sum(e - s for _, _, s, e in launched_in(pt, whole))
    if not pt.spans.get(part) or not den:
        return None
    return 100.0 * num / den


def read_metric(run, metric, fn, *names):
    """``fn(ProgramTrace, *names)`` for a run, None where it has nothing
    to read."""
    pt = of_run(run, metric)
    if pt is None:
        return None
    missing = [n for n in names if not pt.spans.get(n)]
    if missing:
        _say(metric, f"no {', '.join(missing)} span in the trace")
        return None
    value = fn(pt, *names)
    if value is None:
        _say(metric, "nothing issued inside its spans")
    return value


# -- idle gaps ---------------------------------------------------------------


def innermost(mid, spans):
    """For each of the times ``mid``, the name of the span open at it
    that started last (None where no span is open); on equal starts the
    later name of ``spans`` wins."""
    names = list(spans)
    best = np.full(len(mid), -np.inf)
    label = np.full(len(mid), -1)
    for k, name in enumerate(names):
        iv = sorted(spans[name] or [])
        if not iv:
            continue
        s = np.array([a for a, _ in iv])
        e = np.array([b for _, b in iv])
        i = np.searchsorted(s, mid, side="right") - 1
        j = np.maximum(i, 0)
        hit = (i >= 0) & (mid < e[j]) & (s[j] >= best)
        best[hit] = s[j][hit]
        label[hit] = k
    return [names[k] if k >= 0 else None for k in label]


def name_gaps(gap_starts, gap_ends, spans, bench=tracing.SPANS):
    """Idle seconds by the innermost span open at each gap's midpoint,
    largest first: a benchmark span by its name, a program span as
    ``<benchmark span>/<program span>`` (the innermost benchmark span
    open there), ``"outside"`` where none is."""
    mid = (np.asarray(gap_starts) + np.asarray(gap_ends)) / 2
    length = np.asarray(gap_ends) - np.asarray(gap_starts)
    inner = innermost(mid, spans)
    outer = innermost(mid, {n: spans.get(n) or [] for n in bench})
    out = {}
    for g, (a, b) in enumerate(zip(inner, outer)):
        if a is None:
            key = "outside"
        elif a in bench:
            key = a
        else:
            key = f"{b or 'outside'}/{a}"
        out[key] = out.get(key, 0.0) + float(length[g])
    return sorted(out.items(), key=lambda kv: -kv[1])


def fold(named):
    """:func:`name_gaps`'s seconds with each program span folded into the
    benchmark span it lies in, largest first."""
    out = {}
    for key, sec in named:
        base = key.split("/")[0]
        out[base] = out.get(base, 0.0) + sec
    return sorted(out.items(), key=lambda kv: -kv[1])
