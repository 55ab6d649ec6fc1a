"""One run of one cell: set-up, the measured window, the comparison
with the reference, and the per-layer metrics of a traced run.

Set-up builds the port's kernels (``ops._build.build_all``: nvcc the
first time, then the libraries under ``build/spectra_tpu_torch/`` in
the checkout), makes the matrix from the configuration on the host,
builds the cell's operators on the device and runs one warm-up request
from a start vector outside the window's sequence. The window then runs
requests back to back, each from its own start vector (``(seed,
index)``) and each ending with its values and vectors on the host,
until ``seconds`` have passed; it ends with the last request that began
before then. ``solve_s`` is the window's length over its requests. Once
it has closed, the peak of device memory is read, the operators are
freed, and every answer is held against the reference.

A traced run profiles its first :data:`TRACED_REQUESTS` requests
(``tracing``), reduces the profile once to device intervals and the
benchmark's spans (``tracing.reduce``) and once to the program's spans
and the device work each issued (``spans.reduce``), hands both to the
per-layer metrics' readers in a :class:`Run`, and reports those
metrics instead of the end-to-end ones, with the card's idle gaps named
by the innermost span open in each (``spans.name_gaps``).
"""

import dataclasses
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from eigbench import manifest, spans, tracing, traffic, yardstick
from eigbench.reference.compare import fails

#: Requests profiled in a traced run: two whole solves.
TRACED_REQUESTS = 2


@dataclasses.dataclass
class Run:
    """What a metric reader reads."""

    answers: list  # traffic.Answer, the window's requests
    traced: list  # the profiled ones
    trace: tracing.Trace | None
    rates: tuple | None  # yardstick.card_rates of the card
    program: spans.ProgramTrace | None = None  # the program's spans in the trace

    def mean(self, field):
        vals = [getattr(a, field) for a in self.answers]
        return float(np.mean(vals)) if vals else None


def _merge(base, over):
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = _merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def power_limit():
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def run_cell(name, seed, seconds, trace, device="cuda", t_process=None,
             config_overrides=None, traffic_overrides=None, log=sys.stderr,
             root=manifest.ROOT):
    """Run cell ``name`` of the ``BENCHMARK.json`` in ``root`` once, with
    the files it names there; returns the result's dict (``checks``
    last). ``t_process`` is the host clock at the process's start."""
    t_process = time.perf_counter() if t_process is None else t_process
    bench = manifest.load(root)
    cell = manifest.workload(bench, name)
    cfg, cfg_mod = manifest.config(bench, cell["config"], root)
    cfg = _merge(cfg, config_overrides)
    mix = _merge(manifest.traffic(cell["traffic"], root), traffic_overrides)
    limits = manifest.limits(name, root)
    on_card = torch.device(device).type == "cuda"

    # -- set-up ------------------------------------------------------------
    if on_card:
        from spectra_tpu_torch.ops import _build

        _build.build_all()
    operands = manifest.operands(cfg_mod, cfg)
    span = traffic.no_span
    if trace:
        from torch.profiler import record_function

        span = record_function
    served = traffic.build(mix, operands, device, span if trace else None)
    if trace:  # the profiler's own first start, outside the window
        with tracing.profiler(device):
            torch.ones(1, device=device).add_(1)
        traffic.synchronize(device)
    traffic.request(mix, served, traffic.WARMUP_KEY, span)

    # -- the window --------------------------------------------------------
    answers, crashed = [], False
    prof = tracing.profiler(device) if trace else None
    if prof is not None:
        prof.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_process
    while True:
        try:
            answers.append(traffic.request(mix, served, (seed, len(answers)), span))
        except Exception:  # the program failed a request: it counts as failed
            traceback.print_exc(file=log)
            crashed = True
            break
        if trace and len(answers) == TRACED_REQUESTS:
            t2 = time.perf_counter()
            prof.stop()
            print(f"trace: the profiler stopped in {time.perf_counter() - t2:.1f} s", file=log)
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    if trace and len(answers) < TRACED_REQUESTS:
        prof.stop()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del served

    # -- the comparison ----------------------------------------------------
    t2 = time.perf_counter()
    want = mix["wanted"]
    sigma = float(want.get("sigma", 0.0))
    ref_values, _ = cfg_mod.reference(cfg, int(want["nev"]), want["which"], sigma,
                                      np.float64, vectors=False)
    compare = manifest.comparison(cfg_mod)
    worst = dict.fromkeys(limits, 0)
    failed = int(crashed)
    for a in answers:
        nums = compare(operands, ref_values, a.values, a.vectors,
                       a.nconv, a.successful, sigma)
        a.vectors = None
        bad = fails(nums, limits)
        failed += bool(bad)
        for k in limits:
            if worst[k] is not None:
                worst[k] = None if nums.get(k) is None else max(worst[k], nums[k])
    if crashed or not answers:
        worst = dict.fromkeys(limits)
    attempted = len(answers) + int(crashed)
    print(f"compared {len(answers)} answers in {time.perf_counter() - t2:.1f} s; "
          "requests (wall s, iterations, operations): "
          + " ".join(f"{a.wall_s:.4f},{a.iterations},{a.operations}" for a in answers),
          file=log)
    checks = {k: {"value": worst[k], "limit": limits[k]} for k in limits}

    # -- metrics -----------------------------------------------------------
    dev = {"platform": "gpu" if on_card else torch.device(device).type,
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": int(cell["chips"]),
           "memory_peak_bytes": int(memory_peak)}
    result = {"correct": failed == 0 and attempted > 0, "attempted": attempted,
              "failed": failed}
    if not trace:
        measured = {"solve_s": (t1 - t0) / max(len(answers), 1), "setup_s": setup_s}
        # A quantity split by cell (``solve_s.<cell>``) is measured alike.
        result["metrics"] = {
            m["name"]: {"value": measured[m["name"].split(".")[0]], "unit": m["unit"]}
            for m in manifest.metrics_of(bench, name, "end_to_end")
        }
    else:
        t2 = time.perf_counter()
        tr = tracing.reduce(prof)
        pt = spans.reduce(prof)
        print(f"trace: {len(tr.kernels)} kernels, {len(tr.copies)} copies, "
              f"{sum(map(len, tr.spans.values()))} spans, reduced in "
              f"{time.perf_counter() - t2:.1f} s; not device work: "
              f"{sorted(tr.skipped.items())[:10]}", file=log)
        run = Run(answers=answers, traced=answers[:TRACED_REQUESTS],
                  trace=tr,
                  rates=yardstick.card_rates(dev["kind"]) if on_card else None,
                  program=pt)
        result["metrics"] = {}
        for m in manifest.metrics_of(bench, name, "per_layer"):
            value = manifest.reader(m["name"], root)(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": value, "unit": m["unit"]}
        window = tr.window()
        if window is not None and tr.kernels:
            lo, hi = window
            dev["busy_s"] = tracing.busy(tr.device_intervals(), lo, hi)
            dev["window_s"] = hi - lo
            gs, ge = tracing.idle_gaps(tr.device_intervals(), lo, hi)
            named = spans.name_gaps(gs, ge, pt.spans)
            spans.report(pt, named, log)
            result["breakdown"] = {
                "device_ops": [[k, v] for k, v in tracing.top_kernels(tr.kernels)],
                "idle_gaps": [[k, v] for k, v in named[:10]],
            }
    if on_card:
        dev["power_limit"] = power_limit()
    result["device"] = dev
    result["checks"] = checks
    return result
