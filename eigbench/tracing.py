"""The traced run's profiler and its reduction to intervals.

A traced run profiles its first requests with ``torch.profiler`` (CPU
and CUDA activity) and the benchmark's own spans (``request``,
``solver.init``, ``solver.compute``, ``op.apply``). :func:`reduce`
turns the profiler's events into device intervals (kernels, copies and
sets) and span intervals on one clock, in seconds; the functions below
compute busy time, idle gaps and where the host was during each gap.
"""

import dataclasses

import numpy as np

#: The benchmark's spans, outermost first.
SPANS = ("request", "solver.init", "solver.compute", "op.apply")


@dataclasses.dataclass
class Trace:
    """Device intervals and span intervals, in seconds on one clock."""

    kernels: list  # [(name, start, end)]
    copies: list  # [(start, end)]: memcpy and memset
    spans: dict  # {span name: [(start, end)]}
    skipped: dict  # {name: count} of device events that are neither

    def window(self):
        """The traced requests' span: first start to last end."""
        req = self.spans.get("request") or []
        if not req:
            return None
        return min(s for s, _ in req), max(e for _, e in req)

    def device_intervals(self):
        return [(s, e) for _, s, e in self.kernels] + list(self.copies)


def profiler(device):
    """A ``torch.profiler.profile`` for ``device`` (not started)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if str(device).startswith("cuda"):
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)


def _kind(ev):
    """'kernel', 'copy' or None (a span's device range, a wait) for a
    device event. Builds of torch without ``activity_type`` on their
    events are told by name."""
    name = ev.name()
    if name.startswith(("Memcpy", "Memset")):
        return "copy"
    act = getattr(ev, "activity_type", None)
    if act is not None:
        return "kernel" if "kernel" in str(act()).lower() else None
    annotation = getattr(ev, "is_user_annotation", None)
    if name in SPANS or (annotation is not None and annotation()) or "Sync" in name:
        return None
    return "kernel"


def reduce(prof):
    """The :class:`Trace` of a stopped profiler."""
    from torch.autograd import DeviceType

    kernels, copies, spans, skipped = [], [], {s: [] for s in SPANS}, {}
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() * 1e-9
        end = start + ev.duration_ns() * 1e-9
        if ev.device_type() == DeviceType.CUDA:
            kind = _kind(ev)
            if kind == "kernel":
                kernels.append((ev.name(), start, end))
            elif kind == "copy":
                copies.append((start, end))
            else:
                skipped[ev.name()] = skipped.get(ev.name(), 0) + 1
        elif ev.name() in spans:
            spans[ev.name()].append((start, end))
    return Trace(kernels=kernels, copies=copies, spans=spans, skipped=skipped)


def merged(intervals, lo, hi):
    """The union of ``intervals`` inside [lo, hi], as sorted disjoint
    (start, end) arrays."""
    if not intervals:
        return np.zeros(0), np.zeros(0)
    iv = np.asarray(intervals, dtype=np.float64)
    s, e = np.clip(iv[:, 0], lo, hi), np.clip(iv[:, 1], lo, hi)
    keep = e > s
    s, e = s[keep], e[keep]
    order = np.argsort(s, kind="stable")
    s, e = s[order], e[order]
    if len(s) == 0:
        return s, e
    reach = np.maximum.accumulate(e)
    # A new run starts where an interval begins after all before it end.
    new = np.empty(len(s), dtype=bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    starts = s[new]
    idx = np.flatnonzero(new)
    ends = np.maximum.reduceat(e, idx)
    return starts, ends


def busy(intervals, lo, hi) -> float:
    """Seconds of [lo, hi] covered by at least one interval."""
    s, e = merged(intervals, lo, hi)
    return float((e - s).sum())


def idle_gaps(intervals, lo, hi):
    """The parts of [lo, hi] that no interval covers, as (start, end)
    arrays."""
    s, e = merged(intervals, lo, hi)
    gs = np.concatenate([[lo], e])
    ge = np.concatenate([s, [hi]])
    keep = ge > gs
    return gs[keep], ge[keep]


def name_gaps(gap_starts, gap_ends, spans, order=SPANS):
    """Idle seconds by the innermost span open at each gap's midpoint
    (``"outside"`` where none is), largest first."""
    mid = (gap_starts + gap_ends) / 2
    length = gap_ends - gap_starts
    label = np.full(len(mid), -1)
    for rank, name in enumerate(order):  # later = inner
        iv = sorted(spans.get(name) or [])
        if not iv:
            continue
        s = np.array([a for a, _ in iv])
        e = np.array([b for _, b in iv])
        i = np.searchsorted(s, mid, side="right") - 1
        inside = (i >= 0) & (mid < e[np.maximum(i, 0)])
        label[inside] = rank
    out = {}
    for rank in np.unique(label):
        name = "outside" if rank < 0 else order[rank]
        out[name] = float(length[label == rank].sum())
    return sorted(out.items(), key=lambda kv: -kv[1])


def top_kernels(kernels, count=10):
    """Device seconds by kernel name, largest first."""
    total = {}
    for name, s, e in kernels:
        total[name] = total.get(name, 0.0) + (e - s)
    return sorted(total.items(), key=lambda kv: -kv[1])[:count]
