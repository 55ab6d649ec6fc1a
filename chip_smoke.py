"""Smoke test of the PyTorch port (``spectra_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout:

    python3 chip_smoke.py

Phases, each printing JSON lines and its wall time:

1. environment: the card's name and power limit (``nvidia-smi``), the
   build of every kernel under ``spectra_tpu_torch/csrc`` (one ``nvcc``
   per source, all at once), and a check that f32 products are not TF32;
2. the streaming probe ``y = 2 x`` over 2^28 f32 (1 GiB), bitwise
   against ``x * 2`` and timed beside ``torch.mul(x, 2)``: the card's
   measured bytes per second beside the data sheet;
3. K1 (the DIA SpMV) against its plain PyTorch version on the card;
4. K2 (the double-single hi/lo DIA SpMV) against its plain versions, at
   the north star's operator (3-D g=243, n = 14,348,907), its multigrid
   level 1 and shapes with n of every residue mod 4, all three entry
   points; the f64 entry also against the three-step route;
5. K1's time at config #2's shape, f64 and f32, beside its bound, its
   plain version and one ``torch.sparse`` CSR product;
6. K2's time at g=243 in four modes: (A) K1 on the f64 matrix, (B) K2
   on resident planes, (C) ``DiaHiLoMatrix.matvec``, the f64 entry, and
   (C0) the three-step route split, K2, combine; B, C and C0 also at MG
   level 1; each beside its bound, plain version and the
   ``torch.sparse`` CSR f64 product;
7. the probes P3 ``dia_noshift`` and P4 ``dia_roll2d`` (rows 32 to 256)
   at d=5, n=10^6 in f32, against their plain versions and beside K1
   f32 at the same shape;
8. the probe P5 ``dia_spmv_f32`` (K1's f32 kernel) on the g=243 planes,
   beside K2 mode B;
9. ``SymEigsSolver`` on the g=100 2-D Laplacian (n = 10^4) with implicit
   and thick restarts, and a checkpoint round trip;
10. config #2 as ``bench.py`` runs it (the Chebyshev-filtered IRLM for
    the 10 largest eigenvalues of the 1M-node 2-D Laplacian), and a
    profile of its start;
11. config #3 (``bench.py:106-135``): shift-invert with the multigrid
    inner solve, k=10 nearest sigma=0 of the 1M-node 2-D Laplacian, as
    ``bench.py`` runs it (selective re-orthogonalization, restart chunk
    20) and with full re-orthogonalization;
12. the north star as ``scripts/tpu_northstar_100m.py:158-174`` runs
    it: shift-invert with the multigrid inner solve, the stepped driver
    and ``compute_locked`` for the 20 smallest eigenvalues, counted with
    multiplicity, of the 3-D 7-point Laplacian at g=243 (100,088,055
    nonzeros), each level of its built hierarchy timed beside its bound
    and its launches per run, and a profile of a few of its inner
    solves;
13. a ``kernels`` line with each kernel's numbers;
14. the last line, ``{"ok": true, "device": {...}}``.

Each path (the probes, config #2, config #3, the north star) sets the
launch counters to 0 just before it and reads them just after. Any
failed check raises, so the script exits non-zero and prints no ``ok``
line. Without a CUDA device it exits with code 2 before any phase. Only
the port is imported, never jax or the JAX package.
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
G_NORTH = 243  # the 3-D Laplacian of the north star: 100,088,055 nnz
DEGREE = 120
REPLACES = {
    "dia_spmv": (
        "spectra_tpu/ops/dia_pallas.py:45",
        "spectra_tpu/ops/dia_pallas.py::dia_spmv_pallas",
    ),
    "dia_spmv_ds": (
        "spectra_tpu/ops/dia_ds.py:143",
        "spectra_tpu/ops/dia_ds.py::_ds_pallas (entry points "
        "dia_spmv_ds_padded :83, dia_spmv_ds_ext :116); also "
        "scripts/tpu_dia_ds_probe.py:67 dia_spmv_ds",
    ),
    "stream_scale": (
        "scripts/tpu_pallas_stream_probe.py:29",
        "scripts/tpu_pallas_stream_probe.py::scale_pallas",
    ),
    "dia_noshift": (
        "scripts/tpu_dia_variants.py:68",
        "scripts/tpu_dia_variants.py::dia_noshift",
    ),
    "dia_roll2d": (
        "scripts/tpu_dia_variants.py:110",
        "scripts/tpu_dia_variants.py::dia_roll2d",
    ),
    "dia_spmv_f32": (
        "scripts/tpu_dia_f32_ceiling.py:33",
        "scripts/tpu_dia_f32_ceiling.py::dia_spmv_f32 (ported by K1's f32 kernel)",
    ),
}
SOURCES = {
    "dia_spmv": "dia_spmv.cu",
    "dia_spmv_ds": "dia_ds.cu",
    "stream_scale": "stream_scale.cu",
    "dia_noshift": "dia_variants.cu",
    "dia_roll2d": "dia_variants.cu",
    "dia_spmv_f32": "dia_spmv.cu",
}
ROLL2D_ROWS = (32, 64, 128, 256)
#: Where the g=100 checkpoint round trip writes its file (gitignored).
CHECKPOINT_DIR = "build/chip_smoke"


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


def analytic_3d_smallest(g, count=64):
    """The smallest eigenvalues of the 3-D Laplacian, with multiplicity:
    only the ``count`` smallest 1-D modes contribute to them."""
    mu = 4 * np.sin(np.pi * np.arange(1, g + 1) / (2 * (g + 1))) ** 2
    m = mu[: min(g, count)]
    return np.sort((m[:, None, None] + m[None, :, None] + m[None, None, :]).ravel())


def prefix_captured(vals, lam, atol=1e-8):
    """Length of the multiplicity-counted smallest prefix captured
    (``scripts/tpu_northstar_100m.py``)."""
    prefix = 0
    for i, v in enumerate(np.sort(np.asarray(vals))):
        if i < len(lam) and abs(v - lam[i]) < atol:
            prefix = i + 1
        else:
            break
    return prefix


def expected_launches(mg, cls, cycles, solves):
    """SpMVs with ``cls`` operators that ``mg_solve`` and the shift-solve
    make, from the port's code: per V-cycle ``nu1 + 1 + nu2`` on every
    level of that type (``v_cycle``) and one on level 0 for the residual
    of ``mg_solve``'s loop; per solve one on level 0 for the first
    residual and one for the backward-error check
    (``_poison_if_unconverged``, on the operator, which is level 0)."""
    on = [isinstance(op, cls) for op in mg.ops]
    per_cycle = (mg.nu1 + 1 + mg.nu2) * sum(on) + int(on[0])
    return cycles * per_cycle + solves * 2 * int(on[0])


def torch_csr(torch, A, np_dtype):
    """``A`` as a ``torch.sparse`` CSR tensor on the card."""
    return torch.sparse_csr_tensor(
        torch.from_numpy(A.indptr.astype(np.int64)),
        torch.from_numpy(A.indices.astype(np.int64)),
        torch.from_numpy(A.data.astype(np_dtype)),
        size=A.shape,
    ).to("cuda")


def enqueue_us(torch, fn, calls=100):
    """Host microseconds of one call: enqueue ``calls`` calls, no sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


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

    def samples(self, fn, reps=40):
        """ms of each of ``reps`` calls, the L2 flushed before each."""
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
        return [s.elapsed_time(e) for s, e in pairs]

    def cold(self, fn, reps=40):
        return float(np.median(self.samples(fn, reps)))

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
    offsets40 = tuple(
        sorted(int(o) for o in rng.choice(np.arange(-500, 501), 40, replace=False))
    )
    worst = 0.0
    for dtype, rtol in ((torch.float64, 1e-13), (torch.float32, 1e-5)):
        mats = {k: pf.dia_from_scipy(A, dtype=dtype) for k, A in cases.items()}
        mats["banded_17_diagonals"] = pf.DiaMatrix(
            data=torch.randn((17, 10**6), dtype=dtype, device="cuda"),
            offsets=offsets17, n_rows=10**6, n_cols=10**6,
        )
        # 40 diagonals: the most a multigrid level may have
        mats["banded_40_diagonals"] = pf.DiaMatrix(
            data=torch.randn((40, 10**5), dtype=dtype, device="cuda"),
            offsets=offsets40, n_rows=10**5, n_cols=10**5,
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
        csr = torch_csr(torch, A, np.dtype(str(dtype).split(".")[1]))
        x = torch.randn(m.n_cols, dtype=dtype, device="cuda")
        d, n, item = len(m.offsets), m.n_rows, x.element_size()
        kernel_ms = timer.cold(lambda: m.matvec(x))
        plain_ms = timer.cold(
            lambda: dmod.dia_spmv_plain(m.data, m.offsets, x, m.n_cols)
        )
        library_ms = timer.cold(lambda: csr @ x)
        chained_ms = timer.chained(lambda v: m.matvec(v) * 0.125, x.clone())
        host_us = enqueue_us(torch, lambda: m.matvec(x))
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
            enqueue_us=host_us, bytes=bytes_moved, nnz=int(A.nnz), d=d,
            n=n,
        )
        emit(phase="kernel_timing", kernel="dia_spmv", dtype=str(dtype),
             **out[str(dtype).split(".")[1]])
    return out


def run_irlm(torch, stt, dmod):
    """The g=100 IRLM with implicit and thick restarts, and a checkpoint
    round trip: save after the first segment of ``set_restart_chunk``,
    load into a fresh solver, finish; it must equal the uninterrupted
    chunked run bitwise (values and counts)."""
    import os

    g, chunk = 100, 10
    A = laplacian_2d(g)
    op = stt.SparseSymMatProd.from_full(A)

    def solve(label, restart_method="implicit", chunked=False, maxit=1000,
              resume=None):
        s = stt.SymEigsSolver(op, nev=6, ncv=30)
        s.set_restart_method(restart_method)
        if chunked:
            s.set_restart_chunk(chunk)
        s.init()
        if resume is not None:
            s.load_checkpoint(resume)
        before = dmod.LAUNCHES
        t0 = time.perf_counter()
        nconv = s.compute(stt.SortRule.LargestAlge, maxit=maxit, tol=1e-10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dmod.LAUNCHES - before
        vals = s.eigenvalues()
        err = float(np.abs(np.sort(vals) - analytic_2d(g)[-6:]).max()) if len(vals) else None
        emit(phase="irlm_g100", run=label, restart_method=restart_method,
             nconv=nconv, info=s.info().name, iterations=s.num_iterations(),
             operations=s.num_operations(), launches=launches, wall_s=wall,
             max_err_vs_analytic=err)
        if resume is None and launches < s.num_operations():
            raise RuntimeError("the IRLM's SpMVs did not all go through the kernel")
        return s, nconv, vals, err

    implicit, n_i, v_i, err_i = solve("implicit")
    thick, n_t, v_t, err_t = solve("thick", restart_method="thick")
    for label, n, err in (("implicit", n_i, err_i), ("thick", n_t, err_t)):
        if n != 6 or err > 1e-9:
            raise RuntimeError(f"IRLM ({label}) on the g=100 Laplacian did not converge")
    thick_diff = float(np.abs(np.sort(v_t) - np.sort(v_i)).max())
    if n_t != n_i or thick_diff > 1e-12:
        raise RuntimeError(f"thick and implicit restarts disagree by {thick_diff}")

    whole, _, v_w, _ = solve("chunked", chunked=True)
    part, _, _, _ = solve("first segment", chunked=True, maxit=chunk)
    if part.info() != stt.CompInfo.NotConverging:
        raise RuntimeError("the first segment already converged: no round trip")
    os.makedirs(CHECKPOINT_DIR, exist_ok=True)
    path = os.path.join(CHECKPOINT_DIR, "irlm_g100.npz")
    part.save_checkpoint(path)
    resumed, n_r, v_r, _ = solve("resumed", chunked=True, resume=path)
    os.remove(path)
    same = (
        np.array_equal(v_r, v_w)
        and (resumed.num_iterations(), resumed.num_operations())
        == (whole.num_iterations(), whole.num_operations())
        and np.array_equal(v_w, v_i)
        and whole.num_operations() == implicit.num_operations()
    )
    emit(phase="irlm_g100_checkpoint", chunk=chunk, bitwise_equal=bool(same),
         thick_vs_implicit_max_diff=thick_diff,
         counts=dict(implicit=(implicit.num_iterations(), implicit.num_operations()),
                     thick=(thick.num_iterations(), thick.num_operations()),
                     chunked=(whole.num_iterations(), whole.num_operations()),
                     resumed=(resumed.num_iterations(), resumed.num_operations())))
    if n_r != 6 or not same:
        raise RuntimeError("the checkpoint round trip is not bitwise the plain run")


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


def device_time_rows(prof):
    """(device ms, kernel name, calls) per kernel, largest first. Kernel
    rows only: an aten operator's row repeats the device time of the
    kernels it launched. One stream, so kernels do not overlap."""
    from torch.autograd import DeviceType

    rows = [
        (ev.self_device_time_total / 1e3, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    return rows


def emit_profile(phase, prof, wall_ms, **extra):
    rows = device_time_rows(prof)
    busy_ms = sum(r[0] for r in rows)
    emit(phase=phase, wall_ms=wall_ms, device_busy_ms=busy_ms,
         device_busy_share=busy_ms / wall_ms if busy_ms else None,
         top=[dict(name=k[:80], device_ms=t, calls=c) for t, k, c in rows[:12]],
         **extra)


def profile_start(torch, stt, op, v0):
    """Where the time of config #2 goes: the solve's start (spectrum
    bounds and the first 30-step filtered factorization, ~3.6k SpMVs)
    under torch.profiler, outside the counted run. Reports device time
    by kernel and the device's busy share of the wall time."""
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
    emit_profile("profile_main_path_start", prof, wall_ms)


def phase_stream(torch, smod, bandwidth):
    """The streaming probe over 2^28 f32, bitwise against ``x * 2``, then
    timed in two passes beside ``torch.mul(x, 2)`` (the kernel first, then
    the call first), 20 calls each per pass, L2 flushed: its rate is the
    card's measured stream rate. The counter is set to 0 after the
    comparison and read after the timing, so it counts the timed
    launches."""
    n = 1 << 28
    x = torch.randn(n, dtype=torch.float32, device="cuda")
    timer = Timer(torch)
    y = smod.stream_scale2(x)
    ref = smod.stream_scale2_plain(x)
    torch.cuda.synchronize()
    err = float((y - ref).abs().max())
    bitwise = bool(torch.equal(y, ref))
    del y, ref
    calls = dict(kernel=lambda: smod.stream_scale2(x),
                 library=lambda: torch.mul(x, 2.0))
    times = {k: [] for k in calls}
    torch.cuda.synchronize()
    smod.LAUNCHES = 0
    for order in (list(calls), list(calls)[::-1]):
        for k in order:
            times[k] += timer.samples(calls[k], 20)
    torch.cuda.synchronize()
    launches = smod.LAUNCHES
    plain_ms = timer.cold(lambda: smod.stream_scale2_plain(x), reps=20)
    bytes_moved = 8 * n
    ms, library_ms = (float(np.median(times[k])) for k in ("kernel", "library"))
    out = dict(
        n=n, bytes=bytes_moved, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        over_library=ms / library_ms,
        bound_ms=bytes_moved / bandwidth * 1e3, bound_by="bytes",
        gb_s=bytes_moved / (ms * 1e-3) / 1e9,
        library_gb_s=bytes_moved / (library_ms * 1e-3) / 1e9,
        plain_gb_s=bytes_moved / (plain_ms * 1e-3) / 1e9,
        datasheet_gb_s=bandwidth / 1e9, launches=launches, max_abs_err=err,
        bitwise_equal=bitwise,
        enqueue_us=enqueue_us(torch, lambda: smod.stream_scale2(x), 20),
    )
    emit(phase="stream_probe", kernel="stream_scale", **out)
    if not bitwise:
        raise RuntimeError("stream_scale disagrees with x * 2")
    return out


def ext_reference(torch, data, offsets, x_ext, n):
    """The f64 product with a halo-extended x (the ``_ext`` entry)."""
    lo = max(0, -min(offsets))
    y = torch.zeros(n, dtype=torch.float64, device="cuda")
    for k, off in enumerate(offsets):
        y = y + data[k] * x_ext[lo + off : lo + off + n]
    return y


def check_ds_kernel(torch, dsmod, pf, pmg, A243):
    """K2 against its plain versions on the card, every entry at every
    case. Expected: bitwise equal (every step a separately rounded
    operation in both); stated tolerance ``1e-12 * max|y|`` of the f64
    K1 product, both against the plain version and against that product.
    The f64 entry (``DiaHiLoMatrix.matvec``, one launch) must also be
    bitwise its plain version and the three-step route
    ``combine_f64(padded(split_f64(x)))`` launched on the card, or the
    phase raises. The cases cover n of every residue mod 4 and n < 4.
    Returns the largest |kernel - plain| (combined to f64) and the
    timing cases: the g=243 operator and MG level 1, each as
    ``(f64 DiaMatrix, hi/lo matrix, scipy CSR)``."""
    import scipy.sparse as sps

    rng = np.random.default_rng(1)
    # Host steps of the hierarchy build, timed alone: scipy's todia (with
    # the row alignment and the copy to the card) and scipy's Galerkin
    # product P^T (A P) for level 1.
    t0 = time.perf_counter()
    dia243 = pf.dia_from_scipy(A243)
    torch.cuda.synchronize()
    todia_s = time.perf_counter() - t0
    P = pmg.prolong_matrix((G_NORTH,) * 3, "clip")
    t0 = time.perf_counter()
    A1 = (P.T.tocsr() @ (A243 @ P)).tocsr()
    galerkin_s = time.perf_counter() - t0
    del P
    emit(phase="north_star_host_steps", dia_from_scipy_s=todia_s,
         galerkin_level1_s=galerkin_s, level1_nnz=int(A1.nnz))
    n = 777
    offsets17 = tuple(
        sorted(int(o) for o in rng.choice(np.arange(-5000, 5001), 17, replace=False))
    )
    dia1 = pf.dia_from_scipy(A1)

    def random_dia(d_offsets, rows):
        return pf.DiaMatrix(
            data=torch.randn((len(d_offsets), rows), dtype=torch.float64, device="cuda"),
            offsets=d_offsets, n_rows=rows, n_cols=rows,
        )

    cases = {
        "laplacian_3d_g243": dia243,  # n mod 4 = 3
        "mg_level1_g122": dia1,  # n mod 4 = 0
        "n777_offsets_-3_0_1": pf.dia_from_scipy(sps.diags(
            [np.ones(n - 3), 2.0 + np.arange(n), -np.ones(n - 1)], [-3, 0, 1]
        ).tocsr()),  # n mod 4 = 1
        "offsets_-17_0_17": random_dia((-17, 0, 17), 10**5),
        "banded_17_diagonals": random_dia(offsets17, 10**6),
        "n1002_offsets_-5_9": random_dia((-5, 9), 1002),  # n mod 4 = 2
        "n3_offsets_-1_0_1": random_dia((-1, 0, 1), 3),
        "n1_offset_0": random_dia((0,), 1),
    }
    worst = 0.0

    def judge(label, entry, y, yp, ref, d, n, **extra):
        nonlocal worst
        scale = float(ref.abs().max())
        err_plain = float((y - yp).abs().max())
        err_f64 = float((y - ref).abs().max())
        ok = err_plain <= 1e-12 * scale and err_f64 <= 1e-12 * scale
        emit(phase="kernel_vs_plain", kernel="dia_spmv_ds", case=label,
             entry=entry, d=d, n=n, max_abs_err=err_plain,
             max_abs_err_vs_f64=err_f64, max_abs_y=scale, ok=ok, **extra)
        if not ok:
            raise RuntimeError(f"dia_spmv_ds disagrees on {label} ({entry})")
        worst = max(worst, err_plain)

    for label, dia in cases.items():
        hilo = pf.DiaHiLoMatrix.from_dia(dia)
        hi, lo, offs, n = hilo.data_hi, hilo.data_lo, hilo.offsets, hilo.n_rows
        x = torch.randn(n, dtype=torch.float64, device="cuda")
        ref = dia.matvec(x)
        xh, xl = dsmod.split_f64(x)
        yh, yl = dsmod.dia_spmv_ds_padded(hi, lo, xh, xl, offsets=offs, n=n)
        ph, pl = dsmod.dia_spmv_ds_plain(hi, lo, xh, xl, offsets=offs, n=n)
        judge(label, "padded", dsmod.combine_f64(yh, yl), dsmod.combine_f64(ph, pl),
              ref, len(offs), n,
              bitwise_equal=bool(torch.equal(yh, ph) and torch.equal(yl, pl)))
        before = dsmod.LAUNCHES
        y = hilo.matvec(x)
        torch.cuda.synchronize()
        launches = dsmod.LAUNCHES - before
        three_step = dsmod.combine_f64(yh, yl)
        yp = dsmod.dia_spmv_ds_f64_plain(hi, lo, x, offsets=offs, n=n)
        bitwise, bitwise_route = bool(torch.equal(y, yp)), bool(torch.equal(y, three_step))
        judge(label, "f64", y, yp, ref, len(offs), n, bitwise_equal=bitwise,
              bitwise_equal_three_step_route=bitwise_route, launches=launches,
              plane_ld=hi.shape[1])
        if not (bitwise and bitwise_route and launches == 1):
            raise RuntimeError(
                f"the f64 entry on {label} is not one launch bitwise equal to its "
                f"plain version ({bitwise}) and the three-step route ({bitwise_route})"
            )
        del y, yp, three_step, yh, yl, ph, pl
        if label == "banded_17_diagonals":
            lo_, hi_ = max(0, -min(offs)), max(0, max(offs))
            x_ext = torch.randn(lo_ + n + hi_, dtype=torch.float64, device="cuda")
            xh, xl = dsmod.split_f64(x_ext)
            yh, yl = dsmod.dia_spmv_ds_ext(hi, lo, xh, xl, offsets=offs, n=n)
            ph, pl = dsmod.dia_spmv_ds_ext_plain(hi, lo, xh, xl, offsets=offs, n=n)
            judge(label + "_random_halos", "ext", dsmod.combine_f64(yh, yl),
                  dsmod.combine_f64(ph, pl), ext_reference(torch, dia.data, offs, x_ext, n),
                  len(offs), n,
                  bitwise_equal=bool(torch.equal(yh, ph) and torch.equal(yl, pl)))
        if label == "laplacian_3d_g243":
            # matmat: one launch per column, each the f64 entry.
            X = torch.randn((n, 10), dtype=torch.float64, device="cuda")
            Y = hilo.matmat(X)
            ref = dia.matmat(X)
            err_mm, bitwise_mm = 0.0, True
            for c in range(10):
                yp = dsmod.dia_spmv_ds_f64_plain(
                    hi, lo, X[:, c].contiguous(), offsets=offs, n=n
                )
                scale = float(ref[:, c].abs().max())
                err = float((Y[:, c] - yp).abs().max())
                err_f64 = float((Y[:, c] - ref[:, c]).abs().max())
                if err > 1e-12 * scale or err_f64 > 1e-12 * scale:
                    raise RuntimeError(f"dia_spmv_ds matmat column {c} disagrees")
                err_mm = max(err_mm, err)
                bitwise_mm = bitwise_mm and bool(torch.equal(Y[:, c], yp))
            emit(phase="kernel_vs_plain", kernel="dia_spmv_ds",
                 case="matmat_10_columns_g243", entry="f64", d=len(offs),
                 n=n, max_abs_err=err_mm, bitwise_equal=bitwise_mm, ok=True)
            worst = max(worst, err_mm)
            del X, Y, ref
        cases[label] = hilo if label in ("laplacian_3d_g243", "mg_level1_g122") else None
        del hilo
    timing = {
        "g243": (dia243, cases["laplacian_3d_g243"], A243),
        "mg_level1": (dia1, cases["mg_level1_g122"], A1),
    }
    del cases
    torch.cuda.empty_cache()
    return worst, timing


def time_ds(torch, dsmod, dmod, timing_cases, rates, stream_gbs):
    """K2 in the modes of ``scripts/tpu_dia_ds_probe.py``, with the L2
    flushed before each call: (A) K1 on the f64 matrix, (B) K2 on
    resident x planes, (C) ``DiaHiLoMatrix.matvec``, the f64 entry that
    splits x and combines y in the kernel (the route the solver takes),
    and (C0) the earlier route ``combine_f64(K2(split_f64(x)))``, eight
    launches, timed in the same run. At the g=243 operator all four, at
    MG level 1 B, C and C0. Each beside its bound from bytes, its plain
    version and the ``torch.sparse`` CSR f64 product (one library call
    computing the same y = A x). B, C and C0 are validated against the
    f64 product to ~1e-14 relative, as the probe does."""
    bandwidth, f64_rate, f32_rate = rates
    timer = Timer(torch)
    out, accuracy = {}, {}
    for case, (dia, hilo, A) in timing_cases.items():
        n, offs, d = dia.n_rows, dia.offsets, len(dia.offsets)
        x = torch.randn(n, dtype=torch.float64, device="cuda")
        xh, xl = dsmod.split_f64(x)
        hi, lo = hilo.data_hi, hilo.data_lo
        ref = dia.matvec(x)
        scale = float(ref.abs().max())
        csr = torch_csr(torch, A, np.float64)
        library_ms = timer.cold(lambda: csr @ x)
        accuracy[case] = dict(
            B=dsmod.combine_f64(*dsmod.dia_spmv_ds_padded(hi, lo, xh, xl, offsets=offs, n=n)),
            C=hilo.matvec(x), torch_sparse=csr @ x,
        )
        accuracy[case] = {k: float((v - ref).abs().max()) / scale
                          for k, v in accuracy[case].items()}
        del csr, ref
        # The terms this data needs: row i and diagonal k with i + off in range.
        terms = sum(n - abs(o) for o in offs)
        modes = {
            "B_k2_resident_planes": dict(
                fn=lambda: dsmod.dia_spmv_ds_padded(hi, lo, xh, xl, offsets=offs, n=n),
                plain=lambda: dsmod.dia_spmv_ds_plain(hi, lo, xh, xl, offsets=offs, n=n),
                bytes=(d * 8 + 16) * n, ops=23 * terms, rate=f32_rate,
            ),
            "C_hilo_matvec_f64_entry": dict(
                fn=lambda: hilo.matvec(x),
                plain=lambda: dsmod.dia_spmv_ds_f64_plain(hi, lo, x, offsets=offs, n=n),
                bytes=(d * 8 + 16) * n, ops=23 * terms, rate=f32_rate,
            ),
            "C0_split_k2_combine": dict(
                fn=lambda: dsmod.combine_f64(*dsmod.dia_spmv_ds_padded(
                    hi, lo, *dsmod.split_f64(x), offsets=offs, n=n)),
                plain=lambda: dsmod.dia_spmv_ds_f64_plain(hi, lo, x, offsets=offs, n=n),
                bytes=(d * 8 + 16 + 32) * n, ops=23 * terms, rate=f32_rate,
            ),
        }
        if case == "g243":
            modes = dict(A_k1_f64=dict(
                fn=lambda: dia.matvec(x),
                plain=lambda: dmod.dia_spmv_plain(dia.data, offs, x, n),
                bytes=(d + 2) * 8 * n, ops=2 * terms, rate=f64_rate,
            ), **modes)
        out[case] = {}
        for name, m in modes.items():
            ms = timer.cold(m["fn"])
            plain_ms = timer.cold(m["plain"])
            t_bytes = m["bytes"] / bandwidth
            t_ops = m["ops"] / m["rate"]
            at_stream = m["bytes"] / (stream_gbs * 1e9) * 1e3
            out[case][name] = dict(
                ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=m["bytes"], bound_ms_at_stream_rate=at_stream,
                fraction_of_bound=max(t_bytes, t_ops) * 1e3 / ms,
                fraction_of_stream_rate=at_stream / ms,
                gnnz_s=int(A.nnz) / (ms * 1e-3) / 1e9,
                enqueue_us=enqueue_us(torch, m["fn"]),
            )
            emit(phase="ds_timing", case=case, mode=name, d=d, n=n, nnz=int(A.nnz),
                 **out[case][name])
        c, c0 = out[case]["C_hilo_matvec_f64_entry"], out[case]["C0_split_k2_combine"]
        emit(phase="ds_route_speedup", case=case, c0_over_c=c0["ms"] / c["ms"],
             c_over_library=c["ms"] / c["library_ms"])
        del x, xh, xl, modes
    emit(phase="ds_accuracy", rel_err_vs_k1_f64=accuracy)
    if any(v > 1e-13 for a in accuracy.values() for k, v in a.items() if k != "torch_sparse"):
        raise RuntimeError("the double-single product is not f64-grade")
    return out


def timed_entry(timer, fn, plain, library, bytes_moved, ops, rate, bandwidth):
    """Cold times of a kernel, its plain version and a library call
    (None: no single PyTorch call computes the function), with the bound
    from the bytes the function must move and the operations it does."""
    ms = timer.cold(fn)
    t_bytes, t_ops = bytes_moved / bandwidth, ops / rate
    return dict(
        ms=ms, plain_ms=timer.cold(plain),
        library_ms=None if library is None else timer.cold(library),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, fraction_of_bound=max(t_bytes, t_ops) * 1e3 / ms,
    )


def phase_dia_variants(torch, vmod, dmod, pf, rates):
    """P3 ``dia_noshift`` and P4 ``dia_roll2d`` at the probe's shape, the
    g=1000 2-D Laplacian in f32 (d=5, n=10^6), bitwise against their
    plain versions, then timed as K1 is (L2 flushed, CUDA events, median
    of 40) beside their bound, their plain version, K1 f32 at the same
    shape and one ``torch.sparse`` CSR f32 product (P4's library time;
    no single PyTorch call computes P3's wrong-on-purpose function). The
    launch counters are set to 0 after the comparisons and read after
    the timing."""
    bandwidth, _, f32_rate = rates
    timer = Timer(torch)
    A = laplacian_2d(G_FULL)
    m = pf.dia_from_scipy(A, dtype=torch.float32)
    data, offs, n = m.data, m.offsets, m.n_rows
    x = torch.randn(n, dtype=torch.float32, device="cuda")
    csr = torch_csr(torch, A, np.float32)
    d = len(offs)
    checks = {"dia_noshift": (vmod.dia_noshift(data, offs, x),
                              vmod.dia_noshift_plain(data, x))}
    k1_plain = dmod.dia_spmv_plain(data, offs, x, n)
    for rows in ROLL2D_ROWS:
        y = vmod.dia_roll2d(data, offs, x, rows=rows)
        checks[f"dia_roll2d_r{rows}"] = (y, vmod.dia_roll2d_plain(data, offs, x, rows))
        if not torch.equal(y, k1_plain):
            raise RuntimeError(f"dia_roll2d rows={rows} is not K1's product")
    errs = {}
    for label, (y, ref) in checks.items():
        errs[label] = float((y - ref).abs().max())
        bitwise = bool(torch.equal(y, ref))
        kernel = "dia_roll2d" if label.startswith("dia_roll2d") else label
        emit(phase="kernel_vs_plain", kernel=kernel, case=label,
             d=d, n=n, max_abs_err=errs[label], bitwise_equal=bitwise, ok=bitwise)
        if not bitwise:
            raise RuntimeError(f"{label} disagrees with its plain version")
    del checks, k1_plain
    terms = sum(n - abs(o) for o in offs)
    bytes_moved = (d + 2) * 4 * n
    torch.cuda.synchronize()
    vmod.LAUNCHES.update(dia_noshift=0, dia_roll2d=0)
    out = {"k1_f32": timed_entry(
        timer, lambda: dmod.dia_spmv(data, offs, x, n),
        lambda: dmod.dia_spmv_plain(data, offs, x, n), lambda: csr @ x,
        bytes_moved, 2 * terms, f32_rate, bandwidth,
    )}
    out["dia_noshift"] = timed_entry(
        timer, lambda: vmod.dia_noshift(data, offs, x),
        lambda: vmod.dia_noshift_plain(data, x), None,
        bytes_moved, 2 * d * n, f32_rate, bandwidth,
    )
    for rows in ROLL2D_ROWS:
        out[f"dia_roll2d_r{rows}"] = timed_entry(
            timer, lambda rows=rows: vmod.dia_roll2d(data, offs, x, rows=rows),
            lambda rows=rows: vmod.dia_roll2d_plain(data, offs, x, rows),
            lambda: csr @ x, bytes_moved, 2 * terms, f32_rate, bandwidth,
        )
        out[f"dia_roll2d_r{rows}"].update(
            rows=rows, shared_bytes=vmod.window_bytes(offs, rows)
        )
    torch.cuda.synchronize()
    launches = dict(vmod.LAUNCHES)
    for label, t in out.items():
        emit(phase="dia_variants_timing", kernel=label, d=d, n=n,
             k1_f32_ms=out["k1_f32"]["ms"], **t)
    best = min(ROLL2D_ROWS, key=lambda r: out[f"dia_roll2d_r{r}"]["ms"])
    return out, errs, launches, best


def phase_f32_ceiling(torch, vmod, dmod, pf, A243, rates, ds_t):
    """P5 ``dia_spmv_f32``, K1's f32 kernel, on the g=243 planes (d=7,
    n=14,348,907) beside K2 mode B: does K2 take twice P5's time for
    twice P5's bytes (bound by bytes) or more (bound by its f32
    arithmetic)? Bitwise against its plain version, then timed with its
    bound, plain version and a ``torch.sparse`` CSR f32 product. K1's
    counter is set to 0 after the comparison and read after the
    timing."""
    bandwidth, _, f32_rate = rates
    timer = Timer(torch)
    m = pf.dia_from_scipy(A243, dtype=torch.float32)
    data, offs, n = m.data, m.offsets, m.n_rows
    x = torch.randn(n, dtype=torch.float32, device="cuda")
    y = vmod.dia_spmv_f32(data, offs, x)
    ref = vmod.dia_spmv_f32_plain(data, offs, x)
    err = float((y - ref).abs().max())
    bitwise = bool(torch.equal(y, ref))
    emit(phase="kernel_vs_plain", kernel="dia_spmv_f32", case="laplacian_3d_g243",
         d=len(offs), n=n, max_abs_err=err, bitwise_equal=bitwise, ok=bitwise)
    if not bitwise:
        raise RuntimeError("dia_spmv_f32 disagrees with its plain version")
    del y, ref
    csr = torch_csr(torch, A243, np.float32)
    terms = sum(n - abs(o) for o in offs)
    torch.cuda.synchronize()
    dmod.LAUNCHES = 0
    t = timed_entry(
        timer, lambda: vmod.dia_spmv_f32(data, offs, x),
        lambda: vmod.dia_spmv_f32_plain(data, offs, x), lambda: csr @ x,
        (len(offs) + 2) * 4 * n, 2 * terms, f32_rate, bandwidth,
    )
    torch.cuda.synchronize()
    launches = dmod.LAUNCHES
    b = ds_t["g243"]["B_k2_resident_planes"]
    t.update(k2_mode_b_ms=b["ms"], k2_mode_b_bytes=b["bytes"],
             k2_over_p5_time=b["ms"] / t["ms"], k2_over_p5_bytes=b["bytes"] / t["bytes"])
    emit(phase="f32_ceiling", kernel="dia_spmv_f32", d=len(offs), n=n, **t)
    del csr, data, x, m
    torch.cuda.empty_cache()
    return t, err, launches


def run_config3(torch, stt, dmod, dsmod, pmg, pf):
    """Config #3 (``bench.py:106-135``): k=10 nearest sigma=0 of the
    1M-node 2-D Laplacian by shift-invert with the multigrid inner
    solve. Every level is below the hi/lo threshold: all K1, no K2. Two
    solves on one built operator: with full re-orthogonalization (the
    first, whose counts include the build's trial solve), then as
    ``bench.py`` runs it, ``set_restart_chunk(20)``,
    ``set_reorth("selective")``, maxit 200. Returns K1's launches of the
    selective run (the path as specified)."""
    from spectra_tpu_torch.util.rng import SimpleRandom

    A = laplacian_2d(G_FULL)
    v0 = SimpleRandom(0).random_vec(A.shape[0])
    torch.cuda.synchronize()
    dmod.LAUNCHES = dsmod.LAUNCHES = 0
    pmg.CYCLES = pmg.SOLVES = 0
    t0 = time.perf_counter()
    op = stt.SparseSymShiftSolve.create(A, method="mg").set_shift(0.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    levels = [type(o).__name__ for o in op.mg.ops]
    if not all(isinstance(o, pf.DiaMatrix) for o in op.mg.ops):
        raise RuntimeError("a config #3 level is not a DiaMatrix")
    if op.shifted is not op.mg.ops[0]:
        raise RuntimeError("the operator and MG level 0 are not one matrix")
    runs = {}
    for label, reorth, chunk, maxit in (
        ("full", "full", None, 50), ("selective_chunk20", "selective", 20, 200)
    ):
        if label != "full":
            torch.cuda.synchronize()
            dmod.LAUNCHES = dsmod.LAUNCHES = 0
            pmg.CYCLES = pmg.SOLVES = 0
        t0 = time.perf_counter()
        e = stt.SymEigsShiftSolver.from_factored(op, 10, 30, 0.0)
        e.set_restart_chunk(chunk)
        e.set_reorth(reorth)
        e.init(v0)
        nconv = e.compute(stt.SortRule.LargestMagn, maxit=maxit, tol=1e-10)
        torch.cuda.synchronize()
        solve_s = time.perf_counter() - t0
        k1, k2 = dmod.LAUNCHES, dsmod.LAUNCHES
        cycles, solves = pmg.CYCLES, pmg.SOLVES
        vals = np.sort(e.eigenvalues())
        err = float(np.abs(vals - analytic_2d(G_FULL)[: len(vals)]).max()) if len(vals) else None
        expected_k1 = expected_launches(op.mg, pf.DiaMatrix, cycles, solves)
        emit(phase="config3_shift_invert_g1000", run=label, reorth=reorth,
             restart_chunk=chunk, maxit=maxit, nconv=nconv, info=e.info().name,
             restarts=e.num_iterations(), operations=e.num_operations(),
             inner_solves=solves, v_cycles=cycles, k1_launches=k1,
             expected_k1_launches=expected_k1, k2_launches=k2, levels=levels,
             build_s=build_s, build_parts_s=op.build_s, solve_s=solve_s,
             max_err_vs_analytic=err, history=e.convergence_history())
        if nconv != 10 or e.info() != stt.CompInfo.Successful or err > 1e-9:
            raise RuntimeError(f"config #3 ({label}) did not reach the analytic spectrum")
        if k2 != 0 or k1 != expected_k1:
            raise RuntimeError(
                f"config #3 ({label}): K1 {k1} (expected {expected_k1}), K2 {k2}"
            )
        runs[label] = (vals, k1, solve_s, e.num_iterations(), e.num_operations())
    diff = float(np.abs(runs["full"][0] - runs["selective_chunk20"][0]).max())
    emit(phase="config3_selective_vs_full", max_abs_diff=diff,
         solve_s=dict(full=runs["full"][2], selective=runs["selective_chunk20"][2]),
         restarts_operations=dict(full=runs["full"][3:],
                                  selective=runs["selective_chunk20"][3:]))
    if diff > 1e-12:
        raise RuntimeError(f"config #3 selective and full disagree by {diff}")
    return runs["selective_chunk20"][1], runs["full"][1]


def run_north_star(torch, stt, dmod, dsmod, pmg, pf, A, dia64, matrix_s):
    """The north star at full width as ``scripts/tpu_northstar_100m.py:
    158-174`` runs it: the 20 smallest eigenvalues, counted with
    multiplicity, of the 3-D g=243 Laplacian by shift-invert (sigma=0)
    with the multigrid inner solve, ``set_matvec_granularity(True)``,
    then ``compute_locked(LargestMagn, maxit=60, tol=1e-10,
    sorting=SmallestAlge, want=SmallestAlge, max_rounds=3)``. ncv=40 and
    ``ncv_locked=None``: the script's ncv=32 and ``ncv_locked=24`` were
    cuts for a 16 GB TPU (``:137-143``, ``:170-173``), and the card has
    80 GB. Round 0 is the plain ``compute`` of the same solver, so the
    plain path stays driven; its counts are reported apart. Returns the
    operator, the K1/K2 launches of the run and its V-cycles and inner
    solves."""
    from spectra_tpu_torch.util.rng import SimpleRandom

    n = A.shape[0]
    v0 = SimpleRandom(0).random_vec(n)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    dmod.LAUNCHES = dsmod.LAUNCHES = 0
    pmg.CYCLES = pmg.SOLVES = 0
    t0 = time.perf_counter()
    w = stt.SparseSymShiftSolve.create(A, method="mg")
    create_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    op = w.set_shift(0.0)
    torch.cuda.synchronize()
    set_shift_s = time.perf_counter() - t0
    del w
    build_cycles, build_solves = pmg.CYCLES, pmg.SOLVES
    t0 = time.perf_counter()
    e = stt.SymEigsShiftSolver.from_factored(op, 20, 40, 0.0)
    e.set_matvec_granularity(True)
    e.init(v0)
    nconv = e.compute_locked(
        stt.SortRule.LargestMagn, maxit=60, tol=1e-10,
        sorting=stt.SortRule.SmallestAlge, want=stt.SortRule.SmallestAlge,
        max_rounds=3,
    )
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k1, k2 = dmod.LAUNCHES, dsmod.LAUNCHES
    cycles, solves = pmg.CYCLES, pmg.SOLVES
    peak = torch.cuda.max_memory_allocated()
    mg = op.mg
    expected_k2 = expected_launches(mg, pf.DiaHiLoMatrix, cycles, solves)
    expected_k1 = expected_launches(mg, pf.DiaMatrix, cycles, solves)
    vals = e.eigenvalues()
    lam = analytic_3d_smallest(G_NORTH)
    dist = [float(np.abs(lam - v).min()) for v in vals]
    res = e._result
    # Residuals through K1 on the f64 matrix (the "auto" route would give
    # the hi/lo planes at this size).
    vecs = e.eigenvectors()
    lam_t = torch.from_numpy(vals).to(vecs.device)
    R = dia64.matmat(vecs) - vecs * lam_t
    rel_res = (torch.linalg.vector_norm(R, dim=0) / lam_t.abs()).cpu().numpy()
    del vecs, R
    levels = [type(o).__name__ for o in mg.ops]
    rounds = e.locking_rounds()
    captured = prefix_captured(vals, lam)
    # Round 0 is the plain compute: its multiplicity-counted prefix is
    # what plain compute alone would have delivered.
    round_vals = [r.pop("values") for r in rounds]
    rounds[0]["prefix_captured"] = prefix_captured(round_vals[0], lam)
    emit(phase="north_star_g243", n=n, nnz=int(A.nnz), nconv=nconv,
         info=e.info().name, certified=e.certified(), rounds=len(rounds),
         per_round=rounds, round0=rounds[0], restarts=e.num_iterations(),
         operations=e.num_operations(), inner_solves=solves, v_cycles=cycles,
         build_inner_solves=build_solves, build_v_cycles=build_cycles,
         k2_launches=k2, expected_k2_launches=expected_k2, k1_launches=k1,
         expected_k1_launches=expected_k1, levels=levels,
         level_dims=[list(dm) for dm in mg.dims_per_level],
         host_build_s=dict(matrix=matrix_s, create_symmetrize=create_s,
                           **op.build_s, set_shift_total=set_shift_s),
         solve_s=solve_s, max_memory_allocated=peak,
         max_dist_to_analytic=max(dist),
         max_err_vs_smallest_20=float(np.abs(np.sort(vals) - lam[:20]).max()),
         max_rel_residual=float(rel_res.max()),
         prefix_captured=captured, eigenvalues=vals.tolist(),
         V_device=str(res.V.device))
    if nconv != 20 or e.info() != stt.CompInfo.Successful:
        raise RuntimeError("the north star did not converge 20/20")
    if not e.certified() or captured != 20:
        raise RuntimeError(
            f"the north star is not certified (certified={e.certified()}, "
            f"prefix {captured} of 20)"
        )
    if max(dist) > 1e-9 or np.abs(np.sort(vals) - lam[:20]).max() > 1e-9:
        raise RuntimeError("the north star's values are not the 20 smallest")
    if rel_res.max() > 1e-8:
        raise RuntimeError("a north-star eigenpair residual exceeds 1e-8")
    if not (isinstance(mg.ops[0], pf.DiaHiLoMatrix) and isinstance(mg.ops[1], pf.DiaHiLoMatrix)
            and all(isinstance(o, pf.DiaMatrix) for o in mg.ops[2:])):
        raise RuntimeError(f"unexpected level formats {levels}")
    if op.shifted is not mg.ops[0]:
        raise RuntimeError("the operator and MG level 0 are not one matrix")
    if res.V.device.type != "cuda":
        raise RuntimeError("the Krylov basis left the card")
    if k2 == 0 or k2 != expected_k2 or k1 != expected_k1:
        raise RuntimeError(
            f"north star: K2 {k2} (expected {expected_k2}), "
            f"K1 {k1} (expected {expected_k1})"
        )
    return op, k1, k2, cycles, solves


def dia_csr(torch, pf, m):
    """A DIA level (f64 or hi/lo) as a ``torch.sparse`` CSR f64 tensor
    built on the card, stored zeros dropped: the library call's operand."""
    data = m.to_dia().data if isinstance(m, pf.DiaHiLoMatrix) else m.data
    n = m.n_rows
    rows = torch.arange(n, device="cuda")
    idx, vals = [], []
    for k, off in enumerate(m.offsets):
        cols = rows + off
        keep = (cols >= 0) & (cols < n) & (data[k] != 0)
        idx.append(torch.stack([rows[keep], cols[keep]]))
        vals.append(data[k][keep])
    coo = torch.sparse_coo_tensor(torch.cat(idx, 1), torch.cat(vals), (n, n))
    del data, idx, vals
    return coo.coalesce().to_sparse_csr()


def phase_north_star_levels(torch, dsmod, dmod, pf, mg, counts, rates):
    """Each level of the north star's built hierarchy (``mg.ops``) timed
    as the V-cycle calls it (``level.matvec``), L2 flushed, beside its
    bound, its plain version, one ``torch.sparse`` CSR product and its
    launches per run of the north star. The counters count launches per
    kernel, not per level, so each level's launches are derived from the
    run's counted V-cycles and solves: level 0 makes nu1 + 1 + nu2 SpMVs
    per V-cycle, one more for ``mg_solve``'s residual and two per solve;
    every other level nu1 + 1 + nu2 per V-cycle. Levels 0-1 run K2's f64
    entry, the others K1. Only the sums are checked: the derived
    launches of the K2 levels must add up to the run's counted K2
    launches, those of the K1 levels to its counted K1 launches."""
    bandwidth, f64_rate, f32_rate = rates
    k1, k2, cycles, solves = counts
    timer = Timer(torch)
    per_cycle = mg.nu1 + 1 + mg.nu2
    rows, sums = [], {True: 0, False: 0}
    for lv, m in enumerate(mg.ops):
        n, offs, d = m.n_rows, m.offsets, len(m.offsets)
        hilo = isinstance(m, pf.DiaHiLoMatrix)
        terms = sum(n - abs(o) for o in offs)
        x = torch.randn(n, dtype=torch.float64, device="cuda")
        if hilo:
            kernel, bytes_moved, ops, rate = "dia_spmv_ds", (8 * d + 16) * n, 23 * terms, f32_rate
            plain = lambda: dsmod.dia_spmv_ds_f64_plain(
                m.data_hi, m.data_lo, x, offsets=offs, n=n)
        else:
            kernel, bytes_moved, ops, rate = "dia_spmv", (d + 2) * 8 * n, 2 * terms, f64_rate
            plain = lambda: dmod.dia_spmv_plain(m.data, offs, x, n)
        csr = dia_csr(torch, pf, m)
        t = timed_entry(timer, lambda: m.matvec(x), plain, lambda: csr @ x,
                        bytes_moved, ops, rate, bandwidth)
        launches = cycles * per_cycle + (cycles + 2 * solves if lv == 0 else 0)
        sums[hilo] += launches
        t.update(level=lv, kernel=kernel, dims=list(mg.dims_per_level[lv]), n=n, d=d,
                 nnz=int(csr.values().numel()), launches=launches,
                 card_s_per_run=launches * t["ms"] * 1e-3)
        emit(phase="north_star_level_timing", **t)
        rows.append(t)
        del csr, x
    torch.cuda.empty_cache()
    if sums[True] != k2 or sums[False] != k1:
        raise RuntimeError(f"per-level launches {sums} do not add up to K2 {k2}, K1 {k1}")
    return rows


def profile_north_star(torch, op, solves=3):
    """Where the north star's time goes: a few inner solves (its
    operator applications) under torch.profiler, outside the counted
    run."""
    from torch.profiler import ProfilerActivity, profile

    from spectra_tpu_torch.linalg import multigrid as pmg

    b = torch.randn(op.n, dtype=torch.float64, device="cuda")
    op.perform_op(b)
    torch.cuda.synchronize()
    cycles = pmg.CYCLES
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(solves):
            op.perform_op(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit_profile("profile_north_star_inner_solves", prof, wall_ms,
                 inner_solves=solves, v_cycles=pmg.CYCLES - cycles)


def kernel_entry(name, launches, max_abs_err, t, shape, **extra):
    replaces, function = REPLACES[name]
    return dict(
        name=name, route="cuda", source=f"spectra_tpu_torch/csrc/{SOURCES[name]}",
        replaces=replaces, replaces_function=function, shape=shape,
        launches=launches, max_abs_err=max_abs_err, ms=t["ms"],
        plain_ms=t["plain_ms"], bound_ms=t["bound_ms"], bound_by=t["bound_by"],
        library_ms=t["library_ms"], kernel_us=t["ms"] * 1e3,
        plain_us=t["plain_ms"] * 1e3, bound_us=t["bound_ms"] * 1e3,
        library_us=None if t["library_ms"] is None else t["library_ms"] * 1e3,
        **extra,
    )


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import spectra_tpu_torch as stt
    from spectra_tpu_torch.linalg import multigrid as pmg
    from spectra_tpu_torch.ops import dia_ds as dsmod
    from spectra_tpu_torch.ops import dia_spmv as dmod
    from spectra_tpu_torch.ops import dia_variants as vmod
    from spectra_tpu_torch.ops import stream as smod
    from spectra_tpu_torch.sparse import formats as pf

    torch.manual_seed(0)
    walls = {}

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = time.perf_counter() - t0
        emit(phase_wall=name, s=walls[name])
        return out

    name, _ = phase("environment", phase_environment, torch)
    rates = card_rates(name)
    stream_t = phase("stream_probe", phase_stream, torch, smod, rates[0])
    worst_k1 = phase("k1_vs_plain", check_kernel, torch, dmod, pf)

    t0 = time.perf_counter()
    A243 = laplacian_3d(G_NORTH)
    matrix_s = time.perf_counter() - t0
    emit(phase="north_star_matrix", g=G_NORTH, n=A243.shape[0],
         nnz=int(A243.nnz), build_s=matrix_s)
    worst_k2, ds_cases = phase(
        "k2_vs_plain", check_ds_kernel, torch, dsmod, pf, pmg, A243
    )
    timing = phase("k1_timing", time_kernel, torch, dmod, pf, rates)
    ds_t = phase("k2_timing", time_ds, torch, dsmod, dmod, ds_cases, rates,
                 stream_t["gb_s"])
    dia243 = ds_cases["g243"][0]
    del ds_cases
    torch.cuda.empty_cache()
    var_t, var_errs, var_launches, best_rows = phase(
        "dia_variants", phase_dia_variants, torch, vmod, dmod, pf, rates
    )
    p5_t, p5_err, p5_launches = phase(
        "f32_ceiling", phase_f32_ceiling, torch, vmod, dmod, pf, A243, rates, ds_t
    )
    phase("irlm_g100", run_irlm, torch, stt, dmod)
    launches, op, v0 = phase("config2_main_path", run_main_path, torch, stt, dmod)
    phase("config2_profile", profile_start, torch, stt, op, v0)
    del op, v0
    k1_config3, k1_config3_full = phase(
        "config3", run_config3, torch, stt, dmod, dsmod, pmg, pf
    )
    ns_op, k1_ns, k2_ns, ns_cycles, ns_solves = phase(
        "north_star", run_north_star, torch, stt, dmod, dsmod, pmg, pf, A243,
        dia243, matrix_s,
    )
    del dia243
    level_t = phase(
        "north_star_levels", phase_north_star_levels, torch, dsmod, dmod, pf,
        ns_op.mg, (k1_ns, k2_ns, ns_cycles, ns_solves), rates,
    )
    phase("north_star_profile", profile_north_star, torch, ns_op)

    f64 = timing["float64"]
    c_mode = ds_t["g243"]["C_hilo_matvec_f64_entry"]
    emit(kernels=[
        kernel_entry(
            "dia_spmv", launches, worst_k1, f64,
            f"d={f64['d']}, n={f64['n']}, float64 (config #2)",
            max_err=worst_k1, float32=timing["float32"],
            launches_config2=launches, launches_config3=k1_config3,
            launches_config3_full_reorth=k1_config3_full,
            launches_north_star=k1_ns,
            north_star_levels=[t for t in level_t if t["kernel"] == "dia_spmv"],
        ),
        kernel_entry(
            "dia_spmv_ds", k2_ns, worst_k2, c_mode,
            f"d=7, n={G_NORTH ** 3}, f32 hi/lo planes, f64 x and y "
            "(north-star operator, DiaHiLoMatrix.matvec)",
            modes=ds_t, launches_north_star=k2_ns, launches_config3=0,
            north_star_levels=[t for t in level_t if t["kernel"] == "dia_spmv_ds"],
        ),
        kernel_entry(
            "stream_scale", stream_t["launches"], stream_t["max_abs_err"],
            stream_t, "n=2^28, float32",
            gb_s=stream_t["gb_s"], datasheet_gb_s=stream_t["datasheet_gb_s"],
            over_library=stream_t["over_library"],
            launches_path="the stream-probe phase (a probe, on no solver path)",
        ),
        kernel_entry(
            "dia_noshift", var_launches["dia_noshift"], var_errs["dia_noshift"],
            var_t["dia_noshift"], "d=5, n=10^6, float32 (g=1000 2-D Laplacian)",
            k1_f32_ms=var_t["k1_f32"]["ms"],
            launches_path="the dia_variants phase (a probe, on no solver path)",
        ),
        kernel_entry(
            "dia_roll2d", var_launches["dia_roll2d"],
            max(v for k, v in var_errs.items() if k.startswith("dia_roll2d")),
            var_t[f"dia_roll2d_r{best_rows}"],
            f"d=5, n=10^6, float32, rows={best_rows} (the fastest of {list(ROLL2D_ROWS)})",
            rows_sweep={r: var_t[f"dia_roll2d_r{r}"] for r in ROLL2D_ROWS},
            k1_f32_ms=var_t["k1_f32"]["ms"],
            launches_path="the dia_variants phase (a probe, on no solver path)",
        ),
        kernel_entry(
            "dia_spmv_f32", p5_launches, p5_err, p5_t,
            f"d=7, n={G_NORTH ** 3}, float32 (g=243 planes)",
            k2_mode_b_ms=p5_t["k2_mode_b_ms"],
            launches_path="the f32_ceiling phase (K1's f32 kernel as the probe)",
        ),
    ])
    emit(phase_walls=walls, total_s=sum(walls.values()))
    emit(ok=True, device=dict(
        platform="gpu", kind=name, count=torch.cuda.device_count()
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main())
