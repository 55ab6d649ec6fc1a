"""Smoke test of the PyTorch port (``spectra_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. environment: the card's name and power limit (``nvidia-smi``), the
   build of every kernel under ``spectra_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once), and a check that f32 products are not TF32;
2. every kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few others (tolerance below);
3. the kernel's time at the full-width shape, in f64 and f32, beside its
   memory bound, its plain version and one ``torch.sparse`` CSR product;
4. ``SymEigsSolver`` on the g=100 2-D Laplacian (n = 10^4), checked
   against the analytic spectrum;
5. the main path: BASELINE config #2 as ``bench.py`` runs it, the
   Chebyshev-filtered IRLM for the 10 largest eigenvalues of the
   1M-node 2-D Laplacian, with the launch counters set to 0 just before
   and read just after;
6. a ``kernels`` line with each kernel's numbers;
7. the last line, ``{"ok": true, "device": {...}}``.

Any failed check raises, so the script exits non-zero and prints no
``ok`` line. Without a CUDA device it exits with code 2 before any phase.
Only the port is imported, never jax or the JAX package.
"""

import json
import subprocess
import sys
import time

import numpy as np

#: Peak rates of the cards this runs on (NVIDIA data sheets): device
#: memory bytes/s, and FP64 / FP32 non-tensor-core FLOP/s.
CARDS = {
    "H100 PCIe": (2.0e12, 25.6e12, 51.2e12),
    "H100 NVL": (3.9e12, 30.0e12, 60.0e12),
    "H100": (3.35e12, 33.5e12, 66.9e12),  # SXM
    "H200": (4.8e12, 33.5e12, 66.9e12),
}

G_FULL = 1000  # the 1M-node 2-D Laplacian of BASELINE config #2
DEGREE = 120
REPLACES = "spectra_tpu/ops/dia_pallas.py:45"


def emit(**obj):
    print(json.dumps(obj), flush=True)


def laplacian_2d(g):
    import scipy.sparse as sps

    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))).tocsr()


def laplacian_3d(g):
    import scipy.sparse as sps

    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    eye = sps.eye(g)
    return (
        sps.kron(sps.kron(lap1, eye), eye)
        + sps.kron(sps.kron(eye, lap1), eye)
        + sps.kron(sps.kron(eye, eye), lap1)
    ).tocsr()


def analytic_2d(g):
    mu = 4 * np.sin(np.pi * np.arange(1, g + 1) / (2 * (g + 1))) ** 2
    return np.sort((mu[:, None] + mu[None, :]).ravel())


def card_rates(name):
    for key in ("H100 PCIe", "H100 NVL", "H100", "H200"):
        if key in name:
            return CARDS[key]
    raise RuntimeError(f"no peak rates known for {name!r}")


class Timer:
    """CUDA-event timing. ``cold`` flushes the 50 MB L2 before each
    call (the solver loop touches other vectors between SpMVs) and
    times each call alone; the median is returned, in ms."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def cold(self, fn, reps=40):
        torch = self.torch
        fn()
        pairs = []
        for _ in range(reps):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in pairs]))

    def chained(self, step, x, iters=200):
        """ms per ``x = step(x)`` over ``iters`` chained calls."""
        torch = self.torch
        for _ in range(10):
            x = step(x)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            x = step(x)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters


def phase_environment(torch):
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from spectra_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 matmul is on: f32 basis products would not be f32")
    name = torch.cuda.get_device_name(0)
    emit(
        phase="environment", nvidia_smi=smi, device=name,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, kernels=_build.sources(),
        build_s=build_s,
    )
    return name, smi


def check_kernel(torch, dmod, pf):
    """Kernel against plain on the card. Expected: bitwise equal
    (-fmad=false); the stated tolerance is 1e-13 * max|y| in f64 and
    1e-5 * max|y| in f32. Returns the largest |kernel - plain|."""
    import scipy.sparse as sps

    rng = np.random.default_rng(0)
    n = 777
    cases = {
        "laplacian_2d_g1000": laplacian_2d(G_FULL),
        "n777_offsets_-3_0_1": sps.diags(
            [np.ones(n - 3), 2.0 + np.arange(n), -np.ones(n - 1)], [-3, 0, 1]
        ).tocsr(),
        "laplacian_3d_g100": laplacian_3d(100),
    }
    offsets17 = tuple(
        sorted(int(o) for o in rng.choice(np.arange(-5000, 5001), 17, replace=False))
    )
    worst = 0.0
    for dtype, rtol in ((torch.float64, 1e-13), (torch.float32, 1e-5)):
        mats = {k: pf.dia_from_scipy(A, dtype=dtype) for k, A in cases.items()}
        mats["banded_17_diagonals"] = pf.DiaMatrix(
            data=torch.randn((17, 10**6), dtype=dtype, device="cuda"),
            offsets=offsets17, n_rows=10**6, n_cols=10**6,
        )
        inputs = [(k, m, torch.randn(m.n_cols, dtype=dtype, device="cuda"))
                  for k, m in mats.items()]
        big = mats["laplacian_2d_g1000"]
        inputs.append(("matmat_10_columns_g1000", big, torch.randn(
            (big.n_cols, 10), dtype=dtype, device="cuda")))
        for label, m, x in inputs:
            y = m.matvec(x) if x.ndim == 1 else m.matmat(x)
            ref = dmod.dia_spmv_plain(m.data, m.offsets, x, m.n_cols)
            torch.cuda.synchronize()
            err = float((y - ref).abs().max())
            scale = float(ref.abs().max())
            ok = err <= rtol * scale
            emit(phase="kernel_vs_plain", kernel="dia_spmv", case=label,
                 dtype=str(dtype).split(".")[1], d=len(m.offsets),
                 n=m.n_rows, max_abs_err=err, max_abs_y=scale,
                 bitwise_equal=bool(torch.equal(y, ref)), ok=ok)
            if not ok:
                raise RuntimeError(f"dia_spmv disagrees with plain on {label}")
            worst = max(worst, err)
    return worst


def time_kernel(torch, dmod, pf, rates):
    """K1 at the full-width shape (d=5, n=10^6), f64 and f32."""
    bandwidth, f64_rate, f32_rate = rates
    timer = Timer(torch)
    A = laplacian_2d(G_FULL)
    out = {}
    for dtype, rate in ((torch.float64, f64_rate), (torch.float32, f32_rate)):
        m = pf.dia_from_scipy(A, dtype=dtype)
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(A.indptr.astype(np.int64)),
            torch.from_numpy(A.indices.astype(np.int64)),
            torch.from_numpy(A.data.astype(np.dtype(str(dtype).split(".")[1]))),
            size=A.shape,
        ).to("cuda")
        x = torch.randn(m.n_cols, dtype=dtype, device="cuda")
        d, n, item = len(m.offsets), m.n_rows, x.element_size()
        kernel_ms = timer.cold(lambda: m.matvec(x))
        plain_ms = timer.cold(
            lambda: dmod.dia_spmv_plain(m.data, m.offsets, x, m.n_cols)
        )
        library_ms = timer.cold(lambda: csr @ x)
        chained_ms = timer.chained(lambda v: m.matvec(v) * 0.125, x.clone())
        # Host cost of one wrapper call: enqueue 100 launches, no sync.
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            m.matvec(x)
        enqueue_us = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
        bytes_moved = (d + 2) * n * item  # data, x and y, once each
        flops = 2 * A.nnz
        bound_ms = max(bytes_moved / bandwidth, flops / rate) * 1e3
        out[str(dtype).split(".")[1]] = dict(
            ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
            bound_ms=bound_ms,
            bound_by="bytes" if bytes_moved / bandwidth >= flops / rate
            else "operations",
            # The chained loop runs at the slower of the device and the
            # host's enqueue (enqueue_us per call), so both rates are given.
            chained_ms=chained_ms, gnnz_s=A.nnz / (chained_ms * 1e-3) / 1e9,
            kernel_gnnz_s=A.nnz / (kernel_ms * 1e-3) / 1e9,
            enqueue_us=enqueue_us, bytes=bytes_moved, nnz=int(A.nnz), d=d,
            n=n,
        )
        emit(phase="kernel_timing", kernel="dia_spmv", dtype=str(dtype),
             **out[str(dtype).split(".")[1]])
    return out


def run_irlm(torch, stt, dmod):
    g = 100
    A = laplacian_2d(g)
    op = stt.SparseSymMatProd.from_full(A)
    before = dmod.LAUNCHES
    t0 = time.perf_counter()
    s = stt.SymEigsSolver(op, nev=6, ncv=30)
    s.init()
    nconv = s.compute(stt.SortRule.LargestAlge, maxit=1000, tol=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dmod.LAUNCHES - before
    vals = s.eigenvalues()
    err = float(np.abs(np.sort(vals) - analytic_2d(g)[-6:]).max())
    emit(phase="irlm_g100", nconv=nconv, info=s.info().name,
         iterations=s.num_iterations(), operations=s.num_operations(),
         launches=launches, wall_s=wall, max_err_vs_analytic=err)
    if nconv != 6 or s.info() != stt.CompInfo.Successful or err > 1e-9:
        raise RuntimeError("IRLM on the g=100 Laplacian did not converge")
    if launches < s.num_operations():
        raise RuntimeError("the IRLM's SpMVs did not all go through the kernel")


def run_main_path(torch, stt, dmod):
    """Config #2 as bench.py:152-186 runs it; returns K1's launches."""
    from spectra_tpu_torch.util.rng import SimpleRandom

    A = laplacian_2d(G_FULL)
    n = A.shape[0]
    v0 = SimpleRandom(0).random_vec(n)
    op = stt.SparseSymMatProd.from_full(A)  # DIA storage on the card
    torch.cuda.synchronize()
    dmod.LAUNCHES = 0
    t0 = time.perf_counter()
    e = stt.ChebSymEigsSolver(
        op, nev=10, ncv=30, which="largest", degree=DEGREE,
        cut_fraction=0.005,
    )
    e.set_restart_chunk(3)
    e.init(v0)
    nconv = e.compute(maxit=60)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dmod.LAUNCHES
    vals = e.eigenvalues()
    err = float(np.abs(np.sort(vals) - analytic_2d(G_FULL)[-len(vals):]).max())
    # SpMVs the solve must have made: the 30-step Lanczos of the
    # spectrum bounds (2 in init + 29 steps), degree per filtered
    # operation, and one matmat for the Rayleigh quotients.
    expected = 31 + e.num_operations() * DEGREE + 1
    res = e._result
    emit(phase="main_path_cheb_g1000", nconv=nconv, info=e.info().name,
         restarts=e.num_iterations(), filtered_operations=e.num_operations(),
         launches=launches, expected_spmvs=expected, wall_s=wall,
         max_err_vs_analytic=err, V_device=str(res.V.device),
         f_device=str(res.f.device), history=e.convergence_history())
    if nconv != 10 or err > 1e-9:
        raise RuntimeError("config #2 did not converge to the analytic spectrum")
    if res.V.device.type != "cuda" or res.f.device.type != "cuda":
        raise RuntimeError("the Krylov basis left the card")
    if launches == 0 or launches != expected:
        raise RuntimeError(f"K1 launched {launches} times, expected {expected}")
    return launches, op, v0


def profile_start(torch, stt, op, v0):
    """Where the time of the main path goes: the solve's start (spectrum
    bounds and the first 30-step filtered factorization, ~3.6k SpMVs)
    under torch.profiler, outside the counted run. Reports device time
    by kernel and the device's busy share of the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e = stt.ChebSymEigsSolver(
            op, nev=10, ncv=30, which="largest", degree=DEGREE,
            cut_fraction=0.005,
        )
        e.init(v0)
        e.compute(maxit=0)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernel rows only: an aten operator's row repeats the device time
    # of the kernels it launched. One stream, so kernels do not overlap.
    rows = [
        (ev.self_device_time_total / 1e3, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    emit(phase="profile_main_path_start", wall_ms=wall_ms,
         device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if busy_ms else None,
         top=[dict(name=k[:80], device_ms=t, calls=c) for t, k, c in rows[:10]])


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.ops import dia_spmv as dmod
    from spectra_tpu_torch.sparse import formats as pf

    torch.manual_seed(0)
    name, _ = phase_environment(torch)
    rates = card_rates(name)
    worst = check_kernel(torch, dmod, pf)
    timing = time_kernel(torch, dmod, pf, rates)
    run_irlm(torch, stt, dmod)
    launches, op, v0 = run_main_path(torch, stt, dmod)
    profile_start(torch, stt, op, v0)

    f64 = timing["float64"]
    emit(kernels=[dict(
        name="dia_spmv", route="cuda",
        source="spectra_tpu_torch/csrc/dia_spmv.cu",
        replaces=REPLACES,
        replaces_function="spectra_tpu/ops/dia_pallas.py::dia_spmv_pallas",
        shape=f"d={f64['d']}, n={f64['n']}, float64",
        launches=launches, max_abs_err=worst,
        ms=f64["ms"], plain_ms=f64["plain_ms"], bound_ms=f64["bound_ms"],
        bound_by=f64["bound_by"], library_ms=f64["library_ms"],
        max_err=worst, kernel_us=f64["ms"] * 1e3,
        plain_us=f64["plain_ms"] * 1e3, library_us=f64["library_ms"] * 1e3,
        bound_us=f64["bound_ms"] * 1e3, float32=timing["float32"],
    )])
    emit(ok=True, device=dict(
        platform="gpu", kind=name, count=torch.cuda.device_count()
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
