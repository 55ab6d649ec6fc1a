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
3. K1 (the DIA SpMV), f64 and f32, vector and matmat (2 to 33
   columns), and P3
   ``dia_noshift`` (K1's body without the shifted reads) bitwise against
   their plain PyTorch versions on the card, random data at the
   out-of-range positions included;
3b. ``k1_levels``: K1 at the shapes of the north star's coarse levels
   (27-point, 61^3, 31^3, 16^3), cold (median, min, max), back to back,
   beside its bound, plain version, CSR call and launch floor (n=1,
   d=1);
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
   at d=5, n=10^6 in f32, and P4 also at the 61^3 27-point planes in f32
   (n = 226,981), against their plain versions (P4 also at odd n, wide
   offsets, n=1 and rows=1) and beside K1 f32 at the same shapes;
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
11b. config #1 (``bench.py:189-227``): the 3 largest in magnitude of a
    dense 1000x1000 symmetric matrix, on both dense drivers (the native
    Krylov-Schur driver on the host, built from
    ``spectra_tpu_torch/csrc/dense_eigs.cpp``, and the IRLM on the card),
    timed as ``bench.py`` times it;
11c. the dense shift-solve: the Bunch-Kaufman factorization of config
    #1's matrix at sigma=0.5 on the card, its solve, and
    ``SymEigsShiftSolver`` for the 3 eigenvalues nearest sigma;
11d. the five generalized modes (``GEigsMode``) once each, on dense
    matrices at n=1000 built as ``tests/test_sym_geigs.py`` builds them,
    and on config #5a's sparse pair at g=64;
11e. config #5a as ``scripts/tpu_generalized_1m.py`` runs it at g=1000:
    the 10 smallest of ``A x = lambda B x`` (2-D Laplacian, FEM mass
    matrix, n = 10^6) by generalized shift-invert with the multigrid
    inner solve and the stepped driver, against the analytic values,
    with K1's launches (B's SpMVs and every level) counted, and a
    profile of a few of its inner solves;
11f. config #4 as ``bench.py:272-300`` runs it: the 6 largest in
    magnitude of the g=500 2-D convection-diffusion operator (n =
    250,000, non-symmetric, DIA d=5) by the IRAM, checked by its
    backward error, with K1's launches asserted equal to the solve's
    operator applications, K1 bitwise on A's planes and timed at this
    shape, and a profile of three restarts;
11g. the reference benchmark's general case (dense n=1000, nev 10,
    ncv 30) on both dense drivers (the native driver's general leg on
    the host, the IRAM on the card);
11h. the general shift modes once each: the real and complex dense LU
    shift-solves at n=1000, the sparse real shift-solve by SuperLU and
    by BiCGStab (K1) and the sparse complex one by SuperLU on config
    #4's operator at g=100, and the Krylov-Schur restart there;
11i. the Hermitian solvers at the reference's test sizes: the complex
    IRLM on a dense Hermitian n=1000 (k=20, ncv=50, LargestAlge and
    SmallestMagn), the same matrix through its J-structured real
    embedding and through the Hermitian Bunch-Kaufman shift-solve, and a
    sparse Hermitian matrix at n = 10^4 against ``scipy``'s ``eigsh``;
11j. config #5b as ``bench.py:386-402`` runs it: ``DavidsonSymEigsSolver``
    for the 10 largest of the diagonally dominant banded matrix (DIA,
    d=5) at n = 10^6 and 250,000, K1's launches asserted equal to the
    operator's calls (one a block), then at n = 100,000 against host
    ARPACK, and a profile of three iterations at n = 10^6;
11k. ``contrib``: the partial SVD on dense tall and wide matrices and
    on config #4's operator at g=100 (K1), LOBPCG for the 10 smallest of
    the g=100 Laplacian (K1 on blocks) and with deflation constraints;
11l. K1 on 10- and 20-column f64 blocks at config #5b's shapes (n =
    250,000 and 10^6), on LOBPCG's 10 columns at n = 10^4 and on the
    partial SVD's vectors and 5 columns at n = 10^4, bitwise against its
    plain version, timed beside its bound, plain version and the
    ``torch.sparse`` CSR product;
11l'. ``cheb_step``: the Chebyshev recurrence kernel
    (``ops/cheb_step.py``) bitwise against its plain version (the five
    PyTorch operations the filter made before it) at n = 10^6 and
    1,000,003, f64, f32, c128 and c64, a vector and a 3-column block,
    the first step, a later one and in place over ``t_prev``, then timed
    at config #2's shape, (10^6,) f64, cold beside its byte bound and the
    plain sequence, with each one's host microseconds a call; its
    launches in config #2 (phase 10) are asserted to be ``degree`` a
    filtered operation;
11m. ``frontends``: ``stt.eigsh`` (config #3's shift-invert with the
    multigrid inner solve, and the 10 largest of the same matrix),
    ``stt.eigs`` (config #4's operator at g=100), ``stt.svds`` (dense
    2000 x 1000) and the generalized ``stt.eigsh`` on config #5a's pair
    at g=64, each with its counts and K1 launches;
11n. ``mixed_precision``: ``scripts/tpu_mixed_1m.py``'s configuration
    (banded d=5, 10 largest, ``set_precision("mixed")`` at tol 1e-6
    against double at 1e-10) at n = 10^6 and 250,000, K1's f32 launches
    asserted equal to the f32 twin's operations and its f64 block
    launches to two a refinement round;
11o. ``nonfinite``: config #2's matrix with a NaN on its diagonal
    through ``SymEigsSolver`` and ``stt.eigsh`` (maxit 5), the mixed
    matrix at n = 250,000 times 1e38 (its f32 twin overflows) through
    ``set_precision("mixed")``, and a dense Hermitian n = 1000 holding a
    NaN through ``HermEigsSolver``: each ends with ``NumericalIssue`` (the
    frontend with ``NoConvergence``) at the CPU's counts, with K1's
    launches equal to the operations; K1 on NaN planes, a NaN-carrying
    x and the twin's infinite planes against its plain version;
12. the north star as ``scripts/tpu_northstar_100m.py:158-174`` runs
    it: shift-invert with the multigrid inner solve, the stepped driver
    and ``compute_locked`` for the 20 smallest eigenvalues, counted with
    multiplicity, of the 3-D 7-point Laplacian at g=243 (100,088,055
    nonzeros), each level of its built hierarchy timed beside its bound
    and its launches per run, and a profile of a few of its inner
    solves;
12b. ``multidevice_g160``: the multi-device layer on one rank over NCCL
    at full size, the 3-D g=160 Laplacian (n = 4,096,000, the JAX
    package's at-scale sharded record): auto-routing to
    ``ShardedStencilHiLoMatProd``, its SpMV against K1 f64, K2's ``_ext``
    entry bitwise against its plain version and timed beside the
    unsharded ``DiaHiLoMatrix.matvec``, the bound and the CSR call, then
    the 20 smallest by ``sharded_stencil_shift_solve`` (the sharded
    multigrid) and ``compute_locked`` with the north star's settings,
    K1 and K2 ``_ext`` launches asserted against the code's count;
12b'. ``multidevice_cheb_g1000``: config #2 on the row mesh, one rank
    over NCCL at full width (``ChebSymEigsSolver`` over
    ``sharded_stencil_op`` of the g=1000 Laplacian: the f64 stencil class
    on K1), held to ``main_path_cheb_g1000`` of the same run (restarts,
    filtered operations and K1 launches equal, values within 1e-12, the
    recurrence kernel's launches ``degree`` a filtered operation), K1
    bitwise on the halo-extended vector and the Rayleigh quotients'
    10-column block, the sharded product timed beside its K1 launch;
12c. ``multidevice_2rank``: two processes on the one card in a gloo
    world (``--md-worker``; NCCL refuses two ranks on one device), CUDA
    tensors through real halo exchanges staged through pinned host
    buffers: the sharded products on g=160 and config #3's g=1000 matrix
    against the one-rank products, a shift-invert ``compute_locked`` at
    3-D g=32, an ELL IRLM and a Davidson solve, and the share of the
    wall spent in collectives; then the composed solvers on the row
    mesh, each held to one rank: config #2 at g=1000 (500,000 rows a
    rank) against 12b', the partial SVD and ``svds`` over
    ``shard_operator`` of config #4's operator at g=100, mixed precision
    over ``shard_problem`` of the mixed matrix at n = 250,000 and LOBPCG
    on the g=100 Laplacian's sharded stencil, with K1 bitwise on config
    #2's two-rank halo shapes and on the f32 twin's rows;
13. a ``kernels`` line with each kernel's numbers;
14. the last line, ``{"ok": true, "device": {...}}``.

Each path (the probes, config #2, config #3, config #5a, config #4,
config #5b, each frontend call, each mixed-precision solve, the north
star, the g=160 sharded solve, config #2 on the row mesh, each
two-rank composed solve) sets the launch counters to 0 just before it
and reads them just after. Any
failed check raises, so the script exits non-zero and prints no ``ok``
line. Without a CUDA device it exits with code 2 before any phase. Only
the port is imported, never jax or the JAX package.

    python3 chip_smoke.py --k1-parent CHECKOUT

runs only the environment phase and K1, P3 and P4 of the checkout at
``CHECKOUT``, through its own wrappers, against this tree's, in turns
(parent, change, change, parent), at every K1 shape of the paths
(vectors and the blocks of 11l), P5's, P3's and P4's (rows 32 and 256)
and the launch floor.
"""

import json
import os
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
#: (MG level, g) of the north star's levels that run on K1: 27-point
#: stencils on g^3 grids.
K1_LEVELS = ((2, 61), (3, 31), (4, 16))
#: g of config #3's coarse levels 1-4: 9-point stencils on g^2 grids.
CONFIG3_COARSE = (500, 250, 125, 63)
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
    "dia_spmv_ds_ext": (
        "spectra_tpu/ops/dia_ds.py:116",
        "spectra_tpu/ops/dia_ds.py::dia_spmv_ds_ext, the halo-extended entry of "
        "_ds_pallas :143 (called from spectra_tpu/parallel/stencil_spmv.py:173-296)",
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
    "cheb_step": (
        "none",
        "no Pallas kernel: the JAX package leaves the filter's recurrence "
        "passes to XLA (spectra_tpu/matop/chebyshev.py::"
        "ChebyshevFilteredOp.perform_op); on the card it takes the place of "
        "the five PyTorch elementwise launches after each product",
    ),
    "tsqr": (
        "none",
        "no Pallas kernel: the JAX package leaves this QR to XLA "
        "(spectra_tpu/linalg/orthogonalization.py::qr_orthogonalisation); on the card "
        "it takes the place of torch.linalg.qr (cuSOLVER geqr2/larft)",
    ),
}
SOURCES = {
    "dia_spmv": "dia_spmv.cu",
    "dia_spmv_ds": "dia_ds.cu",
    "dia_spmv_ds_ext": "dia_ds.cu",
    "stream_scale": "stream_scale.cu",
    "dia_noshift": "dia_variants.cu",
    "dia_roll2d": "dia_variants.cu",
    "dia_spmv_f32": "dia_spmv.cu",
    "tsqr": "tsqr.cu",
    "cheb_step": "cheb_step.cu",
}
ROLL2D_ROWS = (32, 64, 128, 256)
#: P4's rows in the comparison with a parent checkout.
P4_PARENT_ROWS = (32, 256)
#: Where the g=100 checkpoint round trip writes its file (gitignored).
CHECKPOINT_DIR = "build/chip_smoke"
#: The 3-D Laplacian of the JAX package's at-scale sharded record
#: (``results/sharded_hilo_tpu_smoke.json:hbm_resident_3d_g160``).
G_MD = 160
#: The two-rank phase's solves: the 3-D g for shift-invert with locking.
G_MD_SOLVE = 32


def count_entries(mod):
    """From now on, count the launches of ``mod`` (``ops.dia_spmv``, K1,
    or ``ops.dia_ds``, K2) by entry in the dict it returns, cleared: K1's
    ``"f64"``, ``"f32"``, ``"f64_block"``, ``"f32_block"``, K2's ``"f64"``,
    ``"padded"``, ``"ext"``. Every launch looks its kernel up once through
    ``mod._kernel``, whose arguments name the entry; the first call wraps
    that lookup, later ones return the same dict."""
    counts = getattr(mod._kernel, "entry_counts", None)
    if counts is None:
        lookup, counts = mod._kernel, {}
        if mod.__name__.endswith("dia_spmv"):
            def entry(dtype, block):
                return mod._SUFFIX[dtype] + ("_block" if block else "")
        else:
            def entry(symbol):
                return symbol.rsplit("_", 1)[1]

        def counted(*key):
            name = entry(*key)
            counts[name] = counts.get(name, 0) + 1
            return lookup(*key)

        counted.entry_counts = counts
        mod._kernel = counted
    counts.clear()
    return counts


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
    times each call alone; the median is returned, in ms. ``stats``
    gives the median, min and max of the same samples, ``back_to_back``
    the card's time per call with no host in the way.

    The flush reads 256 MB, so the L2 holds clean lines when the call
    starts (a flush that writes leaves 50 MB of dirty lines whose
    write-back falls into the timed call: up to 10 us at K1's 61^3
    level, PERF.md). A spin kernel of ``HOLD_CYCLES`` holds the stream
    while the host enqueues all the samples: without it a call whose
    host side outlasts the flush left the card idle between the start
    event and the kernel, and that gap was timed (the bimodal K1 times
    at 16^3 that PERF.md records)."""

    HOLD_CYCLES = 40_000_000  # 20 ms at the H100's 1.98 GHz, or longer

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(64 << 20, dtype=torch.float32, device="cuda")
        self.sink = torch.empty((), dtype=torch.float32, device="cuda")

    def samples(self, fn, reps=40):
        """ms of each of ``reps`` calls, the L2 flushed before each."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(self.HOLD_CYCLES)
        pairs = []
        for _ in range(reps):
            torch.sum(self.flush, dim=0, out=self.sink)
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

    def stats(self, fn, reps=40):
        """Median (``ms``), ``min_ms`` and ``max_ms`` of ``samples``."""
        t = self.samples(fn, reps)
        return dict(ms=float(np.median(t)), min_ms=float(min(t)), max_ms=float(max(t)))

    def back_to_back(self, fn, calls=200):
        """ms per call of ``calls`` calls captured in one CUDA graph and
        replayed, no flush: the card's time per launch without the host
        (the outputs of the captured calls share the graph's pool)."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        graph.replay()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        torch.cuda.synchronize()
        del graph
        return s.elapsed_time(e) / calls

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
        cuda=torch.version.cuda, sources=_build.sources(),
        build_s=build_s,
    )
    return name, smi


def check_kernel(torch, dmod, vmod, pf):
    """K1 against its plain version on the card, f64 and f32, vector and
    matmat; P3 ``dia_noshift`` (K1's body without the shifted reads)
    against its own at every square f32 case. Tolerance: bitwise (every
    term a separately rounded product and sum in offset order, x zero
    outside [0, n_cols) in both); any difference raises. The random
    cases hold nonzero data at the out-of-range positions; they include
    the shapes of the north star's K1 levels (d=27) and of config #3's
    coarse levels (d=9, 500^2 in registers, 250^2 to 63^2 staged), whose
    built levels are checked again on their own paths. Returns the
    largest |kernel - plain| (0 when all are bitwise)."""
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
    offsets64 = tuple(
        sorted(int(o) for o in rng.choice(np.arange(-3000, 3001), 64, replace=False))
    )
    top = dmod.STAGED_ROWS_MAX  # staged below, registers from here
    random_cases = {
        **{f"stencil27_random_g{g}": (g**3, g**3, stencil27(g)) for _, g in K1_LEVELS},
        "d1_random_n100003": (100003, 100003, (5,)),
        "d64_random_n200001": (200001, 200001, offsets64),
        "n1_d1_random": (1, 1, (0,)),
        f"staged_n{top - 1}_random": (top - 1, top - 1, (-512, -1, 0, 1, 512)),
        f"registers_n{top}_random": (top, top, (-512, -1, 0, 1, 512)),
        # config #3's 2-D Galerkin levels: staged below 2^17 rows, registers at 500^2
        **{f"stencil9_random_g{g}": (g * g, g * g, stencil9(g)) for g in CONFIG3_COARSE},
        "rect_40x55_random": (40, 55, (-7, -1, 0, 2, 9)),
        "rect_55x40_random": (55, 40, (-7, -1, 0, 2, 9)),
    }
    worst = 0.0
    for dtype in (torch.float64, torch.float32):
        mats = {k: pf.dia_from_scipy(A, dtype=dtype) for k, A in cases.items()}
        mats["banded_17_diagonals"] = random_dia(
            torch, pf, 10**6, 10**6, offsets17, dtype)
        # 40 diagonals: the most a multigrid level may have
        mats["banded_40_diagonals"] = random_dia(
            torch, pf, 10**5, 10**5, offsets40, dtype)
        for label, (rows, cols, offs) in random_cases.items():
            mats[label] = random_dia(torch, pf, rows, cols, offs, dtype)
        inputs = [(k, m, torch.randn(m.n_cols, dtype=dtype, device="cuda"))
                  for k, m in mats.items()]
        for label, cols in (("laplacian_2d_g1000", 10), ("stencil27_random_g31", 10),
                            ("laplacian_2d_g1000", 20), ("rect_40x55_random", 3),
                            ("rect_55x40_random", 33), ("d64_random_n200001", 2),
                            ("n777_offsets_-3_0_1", 20), ("banded_17_diagonals", 2)):
            m = mats[label]
            inputs.append((f"matmat_{cols}_columns_{label}", m, torch.randn(
                (m.n_cols, cols), dtype=dtype, device="cuda")))
        for label, m, x in inputs:
            y = m.matvec(x) if x.ndim == 1 else m.matmat(x)
            ref = dmod.dia_spmv_plain(m.data, m.offsets, x, m.n_cols)
            checks = [("dia_spmv", y, ref)]
            if dtype == torch.float32 and x.ndim == 1 and m.n_rows == m.n_cols:
                checks.append(("dia_noshift", vmod.dia_noshift(m.data, m.offsets, x),
                               vmod.dia_noshift_plain(m.data, x)))
            torch.cuda.synchronize()
            for kernel, got, want in checks:
                err = float((got - want).abs().max())
                bitwise = bool(torch.equal(got, want))
                emit(phase="kernel_vs_plain", kernel=kernel, case=label,
                     dtype=str(dtype).split(".")[1], d=len(m.offsets),
                     n=m.n_rows, n_cols=m.n_cols, columns=1 if x.ndim == 1 else x.shape[1],
                     config=dmod.card_launch(m.n_rows, 1 if x.ndim == 1 else x.shape[1], 0),
                     max_abs_err=err, max_abs_y=float(want.abs().max()),
                     bitwise_equal=bitwise, ok=bitwise)
                if not bitwise:
                    raise RuntimeError(f"{kernel} is not bitwise its plain version on {label}")
                worst = max(worst, err)
        del mats, inputs
    torch.cuda.empty_cache()
    return worst


def time_kernel(torch, dmod, pf, rates):
    """K1 at the full-width shape (d=5, n=10^6), f64 and f32: cold
    (median, min, max), back to back, chained, beside its bound, plain
    version and CSR call."""
    bandwidth, f64_rate, f32_rate = rates
    timer = Timer(torch)
    A = laplacian_2d(G_FULL)
    out = {}
    for dtype, rate in ((torch.float64, f64_rate), (torch.float32, f32_rate)):
        m = pf.dia_from_scipy(A, dtype=dtype)
        csr = torch_csr(torch, A, np.dtype(str(dtype).split(".")[1]))
        x = torch.randn(m.n_cols, dtype=dtype, device="cuda")
        d, n, item = len(m.offsets), m.n_rows, x.element_size()
        kernel = timer.stats(lambda: m.matvec(x))
        kernel_ms = kernel["ms"]
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
            **kernel, plain_ms=plain_ms, library_ms=library_ms,
            back_to_back_ms=timer.back_to_back(lambda: m.matvec(x)),
            bound_ms=bound_ms,
            bound_by="bytes" if bytes_moved / bandwidth >= flops / rate
            else "operations",
            # The chained loop runs at the slower of the device and the
            # host's enqueue (enqueue_us per call), so both rates are given.
            chained_ms=chained_ms, gnnz_s=A.nnz / (chained_ms * 1e-3) / 1e9,
            kernel_gnnz_s=A.nnz / (kernel_ms * 1e-3) / 1e9,
            enqueue_us=host_us, bytes=bytes_moved, nnz=int(A.nnz), d=d,
            n=n, config=dmod.card_launch(n, 1, 0),
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
    from spectra_tpu_torch.ops import cheb_step
    from spectra_tpu_torch.util.rng import SimpleRandom

    A = laplacian_2d(G_FULL)
    n = A.shape[0]
    v0 = SimpleRandom(0).random_vec(n)
    op = stt.SparseSymMatProd.from_full(A)  # DIA storage on the card
    torch.cuda.synchronize()
    dmod.LAUNCHES = cheb_step.LAUNCHES = 0
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
    launches, cheb_launches = dmod.LAUNCHES, cheb_step.LAUNCHES
    vals = e.eigenvalues()
    err = float(np.abs(np.sort(vals) - analytic_2d(G_FULL)[-len(vals):]).max())
    # SpMVs the solve must have made: the 30-step Lanczos of the
    # spectrum bounds (2 in init + 29 steps), degree per filtered
    # operation, and one matmat for the Rayleigh quotients.
    expected = 31 + e.num_operations() * DEGREE + 1
    res = e._result
    emit(phase="main_path_cheb_g1000", nconv=nconv, info=e.info().name,
         restarts=e.num_iterations(), filtered_operations=e.num_operations(),
         launches=launches, expected_spmvs=expected,
         cheb_step_launches=cheb_launches, wall_s=wall,
         max_err_vs_analytic=err, V_device=str(res.V.device),
         f_device=str(res.f.device), history=e.convergence_history())
    if nconv != 10 or err > 1e-9:
        raise RuntimeError("config #2 did not converge to the analytic spectrum")
    if res.V.device.type != "cuda" or res.f.device.type != "cuda":
        raise RuntimeError("the Krylov basis left the card")
    if launches == 0 or launches != expected:
        raise RuntimeError(f"K1 launched {launches} times, expected {expected}")
    if cheb_launches != DEGREE * e.num_operations():
        raise RuntimeError(f"the recurrence kernel launched {cheb_launches} times, "
                           f"expected {DEGREE * e.num_operations()}")
    main = dict(values=np.asarray(vals), restarts=e.num_iterations(),
                operations=e.num_operations(), launches=launches, wall_s=wall,
                cheb_step_launches=cheb_launches)
    return launches, op, v0, main


def device_time_rows(prof):
    """(device ms, kernel name, calls) per kernel, largest first. Kernel
    rows only: an aten operator's row repeats the device time of the
    kernels it launched, and the program's spans (``profiling.SPANS``)
    appear as device rows that span their kernels. One stream, so
    kernels do not overlap."""
    from torch.autograd import DeviceType

    from spectra_tpu_torch.util.profiling import SPANS

    rows = [
        (ev.self_device_time_total / 1e3, ev.key, ev.count)
        for ev in prof.key_averages()
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0
        and ev.key not in SPANS
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
    dia243, A1 = north_star_host_steps(torch, pf, pmg, A243)
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
            kt = timer.stats(m["fn"])
            ms = kt["ms"]
            plain_ms = timer.cold(m["plain"])
            t_bytes = m["bytes"] / bandwidth
            t_ops = m["ops"] / m["rate"]
            at_stream = m["bytes"] / (stream_gbs * 1e9) * 1e3
            out[case][name] = dict(
                **kt, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=m["bytes"], bound_ms_at_stream_rate=at_stream,
                fraction_of_bound=max(t_bytes, t_ops) * 1e3 / ms,
                fraction_of_stream_rate=at_stream / ms,
                gnnz_s=int(A.nnz) / (ms * 1e-3) / 1e9,
                enqueue_us=enqueue_us(torch, m["fn"]),
            )
            if name == "A_k1_f64":
                out[case][name].update(
                    back_to_back_ms=timer.back_to_back(m["fn"]),
                    config=dmod.card_launch(n, 1, 0),
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


def timed_entry(timer, fn, plain, library, bytes_moved, ops, rate, bandwidth,
                back_to_back=False):
    """Cold times of a kernel (median, min and max), its plain version
    and a library call (None: no single PyTorch call computes the
    function), with the bound from the bytes the function must move and
    the operations it does; with ``back_to_back`` also the kernel's
    back-to-back time."""
    t = timer.stats(fn)
    t_bytes, t_ops = bytes_moved / bandwidth, ops / rate
    lib = {} if library is None else timer.stats(library)
    t.update(
        plain_ms=timer.cold(plain),
        library_ms=lib.get("ms"), library_min_ms=lib.get("min_ms"),
        library_max_ms=lib.get("max_ms"),
        bound_ms=max(t_bytes, t_ops) * 1e3,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        bytes=bytes_moved, fraction_of_bound=max(t_bytes, t_ops) * 1e3 / t["ms"],
    )
    if back_to_back:
        t["back_to_back_ms"] = timer.back_to_back(fn)
    return t


def launch_floor(torch, dmod, timer):
    """K1 at n=1, d=1, timed as every K1 shape is: what one launch
    costs the card whatever its work."""
    data = torch.randn((1, 1), dtype=torch.float64, device="cuda")
    x = torch.randn(1, dtype=torch.float64, device="cuda")
    fn = lambda: dmod.dia_spmv(data, (0,), x, 1)
    out = timer.stats(fn)
    out["back_to_back_ms"] = timer.back_to_back(fn)
    return out


def stencil27(g):
    """The 27 offsets of a 3-D 27-point stencil on a g^3 grid: the
    pattern of the north star's Galerkin levels 1-4."""
    return tuple(sorted(a * g * g + b * g + c for a in (-1, 0, 1)
                        for b in (-1, 0, 1) for c in (-1, 0, 1)))


def stencil9(g):
    """The 9 offsets of a 2-D 9-point stencil on a g^2 grid: the pattern
    of config #3's Galerkin levels 1-4."""
    return tuple(sorted(a * g + b for a in (-1, 0, 1) for b in (-1, 0, 1)))


def random_dia(torch, pf, n_rows, n_cols, offsets, dtype=None):
    """A DIA matrix on the card with random data in every position, the
    out-of-range ones included."""
    dtype = torch.float64 if dtype is None else dtype
    return pf.DiaMatrix(
        data=torch.randn((len(offsets), n_rows), dtype=dtype, device="cuda"),
        offsets=tuple(offsets), n_rows=n_rows, n_cols=n_cols,
    )


def phase_k1_levels(torch, dmod, pf, rates):
    """K1 early in the run at the shapes of the north star's K1 levels
    (MG levels 2-4: 27-point, n = 61^3, 31^3, 16^3; synthetic DIA with
    random data and the levels' n, d and bytes), timed as
    ``north_star_level_timing`` times them (L2 flushed, median, min and
    max of 40) plus back to back, beside the bound, the plain version,
    the ``torch.sparse`` CSR call and the launch floor (K1 at n=1, d=1).
    Launches per north-star
    run are filled in after the north star has run."""
    bandwidth, f64_rate, _ = rates
    timer = Timer(torch)
    floor = launch_floor(torch, dmod, timer)
    emit(phase="k1_launch_floor", n=1, d=1, **floor)
    rows = []
    for level, g in K1_LEVELS:
        n, offs = g**3, stencil27(g)
        d = len(offs)
        m = random_dia(torch, pf, n, n, offs)
        x = torch.randn(n, dtype=torch.float64, device="cuda")
        csr = dia_csr(torch, pf, m)
        terms = sum(n - abs(o) for o in offs)
        t = timed_entry(
            timer, lambda: m.matvec(x),
            lambda: dmod.dia_spmv_plain(m.data, offs, x, n), lambda: csr @ x,
            (d + 2) * 8 * n, 2 * terms, f64_rate, bandwidth, back_to_back=True,
        )
        t.update(level=level, kernel="dia_spmv", dims=[g] * 3, n=n, d=d,
                 nnz=int(csr.values().numel()), launches=None, card_s_per_run=None,
                 floor_ms=floor["ms"], floor_back_to_back_ms=floor["back_to_back_ms"],
                 config=dmod.card_launch(n, 1, 0))
        emit(phase="k1_levels", **t)
        rows.append(t)
        del m, x, csr
    torch.cuda.empty_cache()
    return rows, floor


def roll2d_cases(torch, pf):
    """P4's cases beyond its two timed shapes, each ``(label, data,
    offsets, rows)`` with random f32 data: n odd (9001), the 27-point
    planes at a small g with n odd (7^3), offsets larger than one CTA's
    slice, n = 1 and rows = 1 (``tests/test_torch_cuda.py`` holds the
    same)."""
    band = (-700, -129, -128, -1, 0, 3, 128, 300)
    wide = (-20000, -1, 0, 1, 20000)
    out = []
    for label, n, offs, rows in (
        ("odd_n9001", 9001, band, 32), ("stencil27_g7", 7**3, stencil27(7), 8),
        ("wide_offsets_n50001", 50001, wide, 8), ("n1", 1, (0,), 32),
        ("rows1_n50001", 50001, wide, 1),
    ):
        out.append((label, torch.randn((len(offs), n), dtype=torch.float32,
                                       device="cuda"), offs, rows))
    return out


def phase_dia_variants(torch, vmod, dmod, pf, rates):
    """P3 ``dia_noshift`` and P4 ``dia_roll2d`` at the probe's shape, the
    g=1000 2-D Laplacian in f32 (d=5, n=10^6), and P4 with K1 f32 beside
    it at the north star's 61^3 level in f32 (27-point, n = 226,981,
    random data): bitwise against their plain versions (P4 also against
    K1's plain version, and at the odd-n, wide-offset, n=1 and rows=1
    cases of ``roll2d_cases``), then timed as K1 is (L2 flushed, CUDA
    events, median of 40) beside their bound, their plain version, K1
    f32 at the same shape and one ``torch.sparse`` CSR f32 product (P4's
    library time; no single PyTorch call computes P3's wrong-on-purpose
    function). P4 runs at every ``rows`` of ``ROLL2D_ROWS`` at both
    shapes. The launch counters are set to 0 after the comparisons and
    read after the timing."""
    bandwidth, _, f32_rate = rates
    timer = Timer(torch)
    A = laplacian_2d(G_FULL)
    m = pf.dia_from_scipy(A, dtype=torch.float32)
    g61 = K1_LEVELS[0][1]
    shapes = {
        "g1000": (m.data, m.offsets, torch_csr(torch, A, np.float32)),
        f"g{g61}": random_dia(torch, pf, g61**3, g61**3, stencil27(g61), torch.float32),
    }
    m61 = shapes[f"g{g61}"]
    shapes[f"g{g61}"] = (m61.data, m61.offsets, dia_csr(torch, pf, m61))
    cases = [(f"{shape}_r{rows}", data, offs, rows)
             for shape, (data, offs, _) in shapes.items() for rows in ROLL2D_ROWS]
    cases += roll2d_cases(torch, pf)
    data, offs, _ = shapes["g1000"]
    n, d = data.shape[1], len(offs)
    x = torch.randn(n, dtype=torch.float32, device="cuda")
    errs = {}

    def check(label, kernel, y, ref, **extra):
        errs[label] = float((y - ref).abs().max()) if y.numel() else 0.0
        bitwise = bool(torch.equal(y, ref))
        emit(phase="kernel_vs_plain", kernel=kernel, case=label,
             max_abs_err=errs[label], bitwise_equal=bitwise, ok=bitwise, **extra)
        if not bitwise:
            raise RuntimeError(f"{kernel} disagrees with its plain version on {label}")

    check("dia_noshift", "dia_noshift", vmod.dia_noshift(data, offs, x),
          vmod.dia_noshift_plain(data, x), d=d, n=n)
    for label, cdata, coffs, rows in cases:
        cn = cdata.shape[1]
        cx = x if cn == n else torch.randn(cn, dtype=torch.float32, device="cuda")
        y = vmod.dia_roll2d(cdata, coffs, cx, rows=rows)
        plan = vmod.card_plan(cn, coffs, rows, 0)
        check(f"dia_roll2d_{label}", "dia_roll2d", y,
              vmod.dia_roll2d_plain(cdata, coffs, cx, rows), d=len(coffs), n=cn,
              rows=rows, plan=plan._asdict())
        if not torch.equal(y, dmod.dia_spmv_plain(cdata, coffs, cx, cn)):
            raise RuntimeError(f"dia_roll2d {label} is not K1's product")
    torch.cuda.synchronize()
    vmod.LAUNCHES.update(dia_noshift=0, dia_roll2d=0)
    out = {}
    for shape, (sdata, soffs, csr) in shapes.items():
        sn, sd = sdata.shape[1], len(soffs)
        sx = x if sn == n else torch.randn(sn, dtype=torch.float32, device="cuda")
        terms = sum(sn - abs(o) for o in soffs)
        bytes_moved = (sd + 2) * 4 * sn
        out[f"k1_f32_{shape}"] = timed_entry(
            timer, lambda: dmod.dia_spmv(sdata, soffs, sx, sn),
            lambda: dmod.dia_spmv_plain(sdata, soffs, sx, sn), lambda: csr @ sx,
            bytes_moved, 2 * terms, f32_rate, bandwidth,
        )
        if shape == "g1000":
            out["dia_noshift"] = timed_entry(
                timer, lambda: vmod.dia_noshift(data, offs, x),
                lambda: vmod.dia_noshift_plain(data, x), None,
                bytes_moved, 2 * d * n, f32_rate, bandwidth,
            )
        for rows in ROLL2D_ROWS:
            t = out[f"dia_roll2d_{shape}_r{rows}"] = timed_entry(
                timer, lambda rows=rows: vmod.dia_roll2d(sdata, soffs, sx, rows=rows),
                lambda rows=rows: vmod.dia_roll2d_plain(sdata, soffs, sx, rows),
                lambda: csr @ sx, bytes_moved, 2 * terms, f32_rate, bandwidth,
            )
            plan = vmod.card_plan(sn, soffs, rows, 0)
            t.update(rows=rows, d=sd, n=sn, plan=plan._asdict(), ctas=plan.ctas,
                     window_bytes=vmod.window_bytes(soffs, rows),
                     shared_bytes=plan.shared_bytes,
                     k1_f32_ms=out[f"k1_f32_{shape}"]["ms"])
    torch.cuda.synchronize()
    launches = dict(vmod.LAUNCHES)
    for label, t in out.items():
        emit(phase="dia_variants_timing", kernel=label, **t)
    del shapes, cases, m, m61
    torch.cuda.empty_cache()
    return out, errs, launches


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
    level_d = [len(o.offsets) for o in op.mg.ops]
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
             level_d=level_d, build_s=build_s, build_parts_s=op.build_s, solve_s=solve_s,
             max_err_vs_analytic=err, history=e.convergence_history())
        if nconv != 10 or e.info() != stt.CompInfo.Successful or err > 1e-9:
            raise RuntimeError(f"config #3 ({label}) did not reach the analytic spectrum")
        if k2 != 0 or k1 != expected_k1:
            raise RuntimeError(
                f"config #3 ({label}): K1 {k1} (expected {expected_k1}), K2 {k2}"
            )
        runs[label] = (vals, k1, solve_s, e.num_iterations(), e.num_operations())
    check_levels(torch, dmod, pf, op.mg, "config3")
    diff = float(np.abs(runs["full"][0] - runs["selective_chunk20"][0]).max())
    emit(phase="config3_selective_vs_full", max_abs_diff=diff,
         solve_s=dict(full=runs["full"][2], selective=runs["selective_chunk20"][2]),
         restarts_operations=dict(full=runs["full"][3:],
                                  selective=runs["selective_chunk20"][3:]))
    if diff > 1e-12:
        raise RuntimeError(f"config #3 selective and full disagree by {diff}")
    return runs["selective_chunk20"][1], runs["full"][1]


def check_levels(torch, dmod, pf, mg, path, extra=()):
    """K1 bitwise against its plain version on each built DIA level of a
    path's hierarchy (``mg.ops``) and on the path's ``extra`` (case,
    DiaMatrix) pairs, after the path's counted run: the launches at the
    path's own shapes and data. Any difference raises."""
    cases = [(f"{path}_mg_level{lv}", m) for lv, m in enumerate(mg.ops)]
    for case, m in [*cases, *((f"{path}_{c}", m) for c, m in extra)]:
        if type(m) is not pf.DiaMatrix:
            continue
        x = torch.randn(m.n_cols, dtype=m.data.dtype, device="cuda")
        y, ref = m.matvec(x), dmod.dia_spmv_plain(m.data, m.offsets, x, m.n_cols)
        bitwise = bool(torch.equal(y, ref))
        emit(phase="kernel_vs_plain", kernel="dia_spmv", case=case,
             dtype=str(m.data.dtype).split(".")[1], d=len(m.offsets), n=m.n_rows,
             n_cols=m.n_cols, config=dmod.card_launch(m.n_rows, 1, 0),
             max_abs_err=float((y - ref).abs().max()), bitwise_equal=bitwise, ok=bitwise)
        if not bitwise:
            raise RuntimeError(f"K1 is not bitwise its plain version on {case}")


def dense_matrix_config1(n=1000):
    """``bench.py:200-203``: the README example's matrix."""
    rng = np.random.default_rng(123)
    A = rng.uniform(size=(n, n)) - 0.5
    return A + A.T


def run_config1(torch, stt):
    """Config #1 as ``bench.py:189-227`` runs it: k=3 largest in
    magnitude, ncv=6, tol 1e-10, v0 ``SimpleRandom(0)``, on the dense
    drivers ``auto`` (which routes this problem to the native driver on
    the host) and ``torch`` (the IRLM on the card); each wall is the
    minimum of 3 timed solves after a warm-up. Each run must converge
    3/3 within 1e-9 of ``numpy.linalg.eigh``, with ``||AU - U Lambda||_inf
    <= 1e-9``, and no native solve may fall back."""
    import os

    from spectra_tpu_torch.solvers import _native_dense
    from spectra_tpu_torch.util.rng import SimpleRandom

    n, k, m = 1000, 3, 6
    A = dense_matrix_config1(n)
    v0 = SimpleRandom(0).random_vec(n)
    w = np.linalg.eigvalsh(A)
    want = np.sort(w[np.argsort(-np.abs(w))[:k]])
    _native_dense.FALLBACKS = 0
    prev = os.environ.get("SPECTRA_TPU_DENSE_DRIVER")
    walls = {}
    try:
        for driver in ("auto", "torch"):
            os.environ["SPECTRA_TPU_DENSE_DRIVER"] = driver
            op = stt.DenseSymMatProd.create(A)  # on the card
            e = stt.SymEigsSolver(op, nev=k, ncv=m)
            native = _native_dense.eligible(e)
            e.init(v0)
            e.compute(stt.SortRule.LargestMagn, maxit=1000, tol=1e-10)
            times = []
            for _ in range(3):
                e.init(v0)
                t0 = time.perf_counter()
                nconv = e.compute(stt.SortRule.LargestMagn, maxit=1000, tol=1e-10)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            vals = e.eigenvalues()
            U = e.eigenvectors().cpu().numpy()
            resid = float(np.abs(A @ U - U * vals[None, :]).max())
            err = float(np.abs(np.sort(vals) - want).max()) if len(vals) == k else None
            walls[driver] = min(times)
            emit(phase="config1_dense", driver=driver, routed_native=native, n=n, k=k,
                 ncv=m, nconv=nconv, info=e.info().name, restarts=e.num_iterations(),
                 operations=e.num_operations(), wall_s=min(times), walls_s=times,
                 max_err_vs_eigh=err, residual_inf=resid,
                 vectors_device=str(e.eigenvectors().device))
            if native != (driver == "auto"):
                raise RuntimeError(f"config #1 ({driver}) took the wrong driver")
            if nconv != k or e.info() != stt.CompInfo.Successful or err > 1e-9 or resid > 1e-9:
                raise RuntimeError(f"config #1 ({driver}) did not reach eigh's values")
    finally:
        if prev is None:
            os.environ.pop("SPECTRA_TPU_DENSE_DRIVER", None)
        else:
            os.environ["SPECTRA_TPU_DENSE_DRIVER"] = prev
    emit(phase="config1_dense_fallbacks", fallbacks=_native_dense.FALLBACKS,
         native_over_torch=walls["auto"] / walls["torch"])
    if _native_dense.FALLBACKS != 0:
        raise RuntimeError("a native dense solve fell back to the IRLM")


def run_dense_shift_invert(torch, stt):
    """``DenseSymShiftSolve`` on config #1's matrix at sigma=0.5: the
    Bunch-Kaufman factorization on the card (cold, then again), the
    relative residual of one solve, and ``SymEigsShiftSolver`` for the 3
    eigenvalues nearest sigma, within 1e-9 of ``eigh``."""
    n, sigma = 1000, 0.5
    A = dense_matrix_config1(n)
    shift = stt.DenseSymShiftSolve.create(A)
    factor_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        op = shift.set_shift(sigma)
        torch.cuda.synchronize()
        factor_s.append(time.perf_counter() - t0)
    b = torch.from_numpy(np.random.default_rng(5).normal(size=n)).to("cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x = op.perform_op(b)
    torch.cuda.synchronize()
    solve_ms = (time.perf_counter() - t0) * 1e3
    Ad = torch.from_numpy(A).to("cuda")
    r = torch.linalg.vector_norm(Ad @ x - sigma * x - b)
    rel = float(r / torch.linalg.vector_norm(b))
    # the solve's backward error, |r| / (|A - sigma I| |x| + |b|), in the
    # 2-norm with |A - sigma I| <= its largest absolute row sum
    shifted_inf = float((Ad - sigma * torch.eye(n, dtype=Ad.dtype, device="cuda"))
                        .abs().sum(dim=1).max())
    backward = float(r / (shifted_inf * torch.linalg.vector_norm(x)
                          + torch.linalg.vector_norm(b)))
    w = np.linalg.eigvalsh(A)
    want = np.sort(w[np.argsort(np.abs(w - sigma))[:3]])
    t0 = time.perf_counter()
    e = stt.SymEigsShiftSolver.from_factored(op, 3, 6, sigma)
    e.init()
    nconv = e.compute(stt.SortRule.LargestMagn, maxit=1000, tol=1e-10)
    torch.cuda.synchronize()
    eig_s = time.perf_counter() - t0
    vals = e.eigenvalues()
    err = float(np.abs(np.sort(vals) - want).max()) if len(vals) == 3 else None
    emit(phase="dense_shift_invert", n=n, sigma=sigma, factorize_s=factor_s,
         pivots_2x2=int(op.factors.is2x2.sum()), solve_ms=solve_ms,
         rel_residual=rel, backward_error=backward, nconv=nconv, info=e.info().name,
         restarts=e.num_iterations(), operations=e.num_operations(), solve_s=eig_s,
         max_err_vs_eigh=err, factors_device=str(op.factors.L.device))
    if backward > 1e-14:
        raise RuntimeError(f"the BKLDLT solve's backward error is {backward}")
    if nconv != 3 or e.info() != stt.CompInfo.Successful or err > 1e-9:
        raise RuntimeError("dense shift-invert did not reach eigh's values")


def config5a_pair(g):
    """``scripts/tpu_generalized_1m.py::pair``: the 2-D 5-point Laplacian
    and the FEM mass matrix ``kron(I, tridiag(1/6, 2/3, 1/6))``."""
    import scipy.sparse as sps

    m1 = sps.diags([1.0 / 6, 2.0 / 3, 1.0 / 6], [-1, 0, 1], shape=(g, g))
    return laplacian_2d(g), sps.kron(sps.eye(g), m1).tocsr()


def config5a_analytic(g, k=10):
    """The k smallest of config #5a's pencil: ``(lambda_a + lambda_b) /
    mu_b`` with ``theta_i = i pi / (g + 1)``, ``lambda_i = 2 - 2 cos
    theta_i``, ``mu_i = (2 + cos theta_i) / 3``; b indexes the inner
    (fast) axis, on which B acts."""
    theta = np.arange(1, g + 1) * np.pi / (g + 1)
    lam, mu = 2.0 - 2.0 * np.cos(theta), (2.0 + np.cos(theta)) / 3.0
    return np.sort(((lam[:, None] + lam[None, :]) / mu[None, :]).ravel())[:k]


def geigs_check(A, B, e, k, label, storage, wall):
    """One generalized run's check: nconv and ``||AU - BU Lambda||_inf
    <= 1e-9`` (BASELINE.md:23)."""
    import scipy.sparse as sps

    vals = e.eigenvalues()
    U = e.eigenvectors().cpu().numpy()
    R = A @ U - (B @ U) * vals[None, :]
    resid = float(np.abs(R).max()) if len(vals) else None
    emit(phase="generalized_modes", mode=label, storage=storage, n=A.shape[0],
         nconv=len(vals), info=e.info().name, restarts=e.num_iterations(),
         operations=e.num_operations(), residual_inf=resid, wall_s=wall,
         sparse=bool(sps.issparse(A)))
    if len(vals) != k or e.info().name != "Successful" or resid > 1e-9:
        raise RuntimeError(f"generalized mode {label} ({storage}) failed: residual {resid}")


def run_generalized_modes(torch, stt):
    """Each of the five ``GEigsMode``s once on dense storage at n=1000
    (the matrices of ``tests/test_sym_geigs.py``: ``_rand_sym`` and
    ``_spd``, Buckling's (K, K_G)) and once on config #5a's sparse pair at
    g=64 (``SparseCholesky``, ``SparseRegularInverse`` and the host
    ``splu`` of ``SymShiftInvert``). Each must converge with
    ``||AU - BU Lambda||_inf <= 1e-9``."""
    M = stt.GEigsMode
    LA, LM = stt.SortRule.LargestAlge, stt.SortRule.LargestMagn

    def rand_sym(n, seed=123):
        rng = np.random.RandomState(seed)
        A = rng.uniform(size=(n, n)) - 0.5
        return A + A.T

    def spd(n, seed=42):
        rng = np.random.RandomState(seed)
        Mm = rng.uniform(size=(n, n)) - 0.5
        B = (Mm + Mm.T) * 0.1
        np.fill_diagonal(B, np.abs(B).sum(axis=1) + 1.0)
        return B

    def run(label, storage, A, B, make, rule, k):
        t0 = time.perf_counter()
        e = make()
        e.init()
        e.compute(rule, maxit=1000, tol=1e-10)
        torch.cuda.synchronize()
        geigs_check(A, B, e, k, label, storage, time.perf_counter() - t0)

    n = 1000
    A, B = rand_sym(n), spd(n)
    run("Cholesky", "dense", A, B, lambda: stt.SymGEigsSolver(
        stt.DenseSymMatProd.create(A), stt.DenseCholesky.create(B), 5, 20), LA, 5)
    run("ShiftInvert", "dense", A, B, lambda: stt.SymGEigsShiftSolver(
        stt.SymShiftInvert.create(A, B), stt.DenseSymMatProd.create(B), 4, 16, 0.3),
        LM, 4)
    K, KG = spd(n, seed=5), rand_sym(n, seed=6)
    run("Buckling", "dense", K, KG, lambda: stt.SymGEigsShiftSolver(
        stt.SymShiftInvert.create(K, KG), stt.DenseSymMatProd.create(K), 4, 16, 1.0,
        M.Buckling), LM, 4)
    A9, B10 = rand_sym(n, seed=9), spd(n, seed=10)
    run("Cayley", "dense", A9, B10, lambda: stt.SymGEigsShiftSolver(
        stt.SymShiftInvert.create(A9, B10), stt.DenseSymMatProd.create(B10), 4, 16,
        0.5, M.Cayley), LM, 4)

    As, Bs = config5a_pair(64)
    run("Cholesky", "sparse", As, Bs, lambda: stt.SymGEigsSolver(
        stt.SparseSymMatProd.from_full(As), stt.SparseCholesky.create(Bs), 5, 20), LA, 5)
    run("RegularInverse", "sparse", As, Bs, lambda: stt.SymGEigsSolver(
        stt.SparseSymMatProd.from_full(As), stt.SparseRegularInverse.create(Bs), 5, 20,
        M.RegularInverse), LA, 5)
    run("ShiftInvert", "sparse", As, Bs, lambda: stt.SymGEigsShiftSolver(
        stt.SymShiftInvert.create(As, Bs), stt.SparseSymMatProd.from_full(Bs), 4, 16,
        0.0), LM, 4)
    run("Buckling", "sparse", As, Bs, lambda: stt.SymGEigsShiftSolver(
        stt.SymShiftInvert.create(As, Bs), stt.SparseSymMatProd.from_full(As), 4, 16,
        0.05, M.Buckling), LM, 4)
    run("Cayley", "sparse", As, Bs, lambda: stt.SymGEigsShiftSolver(
        stt.SymShiftInvert.create(As, Bs), stt.SparseSymMatProd.from_full(Bs), 4, 16,
        0.05, M.Cayley), LM, 4)


class CountingOp:
    """``op`` with a count of its ``perform_op`` calls and of the columns
    they carried: the SpMVs of config #5a's B and of config #5b's
    Davidson solve, each one K1 launch (a vector or a block)."""

    def __init__(self, op):
        self.op = op
        self.calls = 0
        self.columns = 0

    dtype = property(lambda self: self.op.dtype)
    device = property(lambda self: self.op.device)

    def rows(self):
        return self.op.rows()

    def cols(self):
        return self.op.cols()

    def diagonal(self):
        return self.op.diagonal()

    def perform_op(self, x):
        self.calls += 1
        self.columns += 1 if x.ndim == 1 else x.shape[1]
        return self.op.perform_op(x)


def run_config5a(torch, stt, dmod, dsmod, pmg, pf):
    """Config #5a as ``scripts/tpu_generalized_1m.py:62-69`` runs it at
    g=1000: ``SymShiftInvert(A, B, method="mg").set_shift(0)``,
    ``SymGEigsShiftSolver.from_factored(op, bop, 10, 30, 0)``, the stepped
    driver, ``compute(LargestMagn, maxit=50, tol=1e-10)`` from
    ``SimpleRandom(0)``. B (d=3) and every multigrid level run on K1; its
    launches must equal B's SpMVs (counted by :class:`CountingOp` around
    B's operator) plus what the V-cycles and inner solves imply. Checks
    10/10, every value within a relative 1e-9 of the analytic ones, and
    ``||AU - BU Lambda||_inf / ||A||_inf <= 1e-9``. Returns the operator
    and K1's launches."""
    from spectra_tpu_torch.util.rng import SimpleRandom

    g = G_FULL
    A, B = config5a_pair(g)
    n = A.shape[0]
    v0 = SimpleRandom(0).random_vec(n)
    torch.cuda.synchronize()
    dmod.LAUNCHES = dsmod.LAUNCHES = 0
    pmg.CYCLES = pmg.SOLVES = 0
    bop = CountingOp(stt.SparseSymMatProd.from_full(B))
    t0 = time.perf_counter()
    op = stt.SymShiftInvert.create(A, B, method="mg").set_shift(0.0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_cycles, build_solves = pmg.CYCLES, pmg.SOLVES
    t0 = time.perf_counter()
    eigs = stt.SymGEigsShiftSolver.from_factored(op, bop, 10, 30, 0.0)
    eigs.set_matvec_granularity(True)
    eigs.init(v0)
    nconv = eigs.compute(stt.SortRule.LargestMagn, maxit=50, tol=1e-10)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k1, k2 = dmod.LAUNCHES, dsmod.LAUNCHES
    cycles, solves = pmg.CYCLES, pmg.SOLVES
    b_spmvs = bop.calls
    expected_k1 = b_spmvs + expected_launches(op.mg, pf.DiaMatrix, cycles, solves)
    vals = np.sort(eigs.eigenvalues())
    want = config5a_analytic(g)
    rel_err = float(np.max(np.abs(vals - want) / want)) if len(vals) == 10 else None
    U = eigs.eigenvectors().cpu().numpy()
    vals_u = eigs.eigenvalues()
    resid = float(np.abs(A @ U - (B @ U) * vals_u[None, :]).max())
    a_inf = float(abs(A).sum(axis=1).max())
    b_mat = bop.op.ell
    emit(phase="config5a_generalized_g1000", n=n, nconv=nconv, info=eigs.info().name,
         restarts=eigs.num_iterations(), operations=eigs.num_operations(),
         inner_solves=solves, v_cycles=cycles, build_inner_solves=build_solves,
         build_v_cycles=build_cycles, b_spmvs=b_spmvs, k1_launches=k1,
         expected_k1_launches=expected_k1, k2_launches=k2,
         b_format=type(b_mat).__name__, b_d=len(getattr(b_mat, "offsets", ())),
         levels=[type(o).__name__ for o in op.mg.ops],
         level_d=[len(o.offsets) for o in op.mg.ops],
         build_s=build_s, build_parts_s=op.build_s, solve_s=solve_s,
         max_rel_err_vs_analytic=rel_err, residual_inf_over_a_inf=resid / a_inf,
         eigenvalues=vals.tolist(), history=eigs.convergence_history())
    if nconv != 10 or eigs.info() != stt.CompInfo.Successful or rel_err > 1e-9:
        raise RuntimeError("config #5a did not reach the analytic spectrum")
    if resid / a_inf > 1e-9:
        raise RuntimeError(f"config #5a's residual over ||A||_inf is {resid / a_inf}")
    if not all(isinstance(o, pf.DiaMatrix) for o in (b_mat, *op.mg.ops)):
        raise RuntimeError("a config #5a operator is not a DiaMatrix")
    if b_spmvs < eigs.num_operations() or k2 != 0 or k1 != expected_k1:
        raise RuntimeError(
            f"config #5a: K1 {k1} (expected {expected_k1}), K2 {k2}, B SpMVs {b_spmvs}"
        )
    check_levels(torch, dmod, pf, op.mg, "config5a", extra=(("B", b_mat),))
    return op, k1


def config4_matrix(g):
    """``bench.py:284-292``: the 2-D convection-diffusion operator
    ``kron(I, lap1) + kron(lap1, I) + 0.3 kron(I, upw1)``, upwind
    convection on the inner axis."""
    import scipy.sparse as sps

    lap1 = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(g, g))
    upw1 = sps.diags([-1.0, 1.0], [-1, 0], shape=(g, g))
    return (sps.kron(sps.eye(g), lap1) + sps.kron(lap1, sps.eye(g))
            + 0.3 * sps.kron(sps.eye(g), upw1)).tocsr()


def gen_check(A, e, k, phase, **extra):
    """One general solve's check: k/k ``Successful`` and
    ``||AU - U Lambda||_inf <= 1e-9`` on the original A, in complex128
    on the host."""
    vals = e.eigenvalues()
    U = e.eigenvectors().cpu().numpy()
    resid = float(np.abs(A @ U - U * vals[None, :]).max()) if len(vals) else None
    emit(phase=phase, n=A.shape[0], nconv=len(vals), info=e.info().name,
         restarts=e.num_iterations(), operations=e.num_operations(),
         residual_inf=resid, vectors_device=str(e.eigenvectors().device), **extra)
    if len(vals) != k or e.info().name != "Successful" or resid > 1e-9:
        raise RuntimeError(f"{phase} {extra.get('run', '')} failed: {len(vals)}/{k}, "
                           f"residual {resid}")


def run_config4(torch, stt, dmod, pf, rates, floor):
    """Config #4 as ``bench.py:272-300`` runs it: ``SparseGenMatProd.create``
    of the g=500 convection-diffusion operator (n = 250,000, nnz =
    1,248,000; DIA on the card, d=5, under the hi/lo threshold),
    ``GenEigsSolver(op, nev=6, ncv=30)``, ``init(SimpleRandom(0))``,
    ``compute(LargestMagn, maxit=500, tol=1e-10)``. Checks 6/6
    ``Successful``, ``||AU - U Lambda||_inf <= 1e-9`` (the backward error
    is the contract: f64 cannot reach the analytic spectrum, whose
    similarity has condition number 1.3^249.5), values closed under
    conjugation, and K1's launches equal to ``num_operations()``, one a
    product. Then K1 bitwise on A's planes against its plain version, and
    timed at this shape beside its bound, the launch floor and the
    ``torch.sparse`` CSR call. Returns the operator, the start, K1's
    launches and its timing."""
    from spectra_tpu_torch.util.rng import SimpleRandom

    bandwidth, f64_rate, _ = rates
    g = 500
    A = config4_matrix(g)
    n = A.shape[0]
    v0 = SimpleRandom(0).random_vec(n)
    op = stt.SparseGenMatProd.create(A)  # DIA on the card
    m = op.ell
    if not isinstance(m, pf.DiaMatrix) or m.offsets != (-g, -1, 0, 1, g):
        raise RuntimeError(f"config #4's operator is {type(m).__name__} {m.offsets}")
    torch.cuda.synchronize()
    dmod.LAUNCHES = 0
    t0 = time.perf_counter()
    e = stt.GenEigsSolver(op, nev=6, ncv=30)
    e.init(v0)
    nconv = e.compute(stt.SortRule.LargestMagn, maxit=500, tol=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dmod.LAUNCHES
    vals = e.eigenvalues()
    gen_check(
        A, e, 6, "config4_gen_sparse_g500", run="bench.py", nnz=int(A.nnz),
        format=type(m).__name__, offsets=list(m.offsets), k1_launches=launches,
        solve_s=wall, eigenvalues_re=vals.real.tolist(), eigenvalues_im=vals.imag.tolist(),
    )
    closed = all(np.min(np.abs(np.conj(v) - vals)) <= 1e-12 * abs(v) for v in vals)
    if nconv != 6 or not closed:
        raise RuntimeError(f"config #4: nconv {nconv}, closed under conjugation {closed}")
    if launches != e.num_operations():
        raise RuntimeError(f"config #4: K1 {launches} launches, {e.num_operations()} products")
    x = torch.randn(n, dtype=torch.float64, device="cuda")
    y = m.matvec(x)
    want = dmod.dia_spmv_plain(m.data, m.offsets, x, m.n_cols)
    if not torch.equal(y, want):
        raise RuntimeError("K1 is not bitwise its plain version on config #4's planes")
    timer = Timer(torch)
    csr = torch_csr(torch, A, np.float64)
    d = len(m.offsets)
    t = timed_entry(
        timer, lambda: m.matvec(x), lambda: dmod.dia_spmv_plain(m.data, m.offsets, x, n),
        lambda: csr @ x, (d + 2) * 8 * n, 2 * A.nnz, f64_rate, bandwidth,
        back_to_back=True,
    )
    t.update(kernel="dia_spmv", n=n, d=d, nnz=int(A.nnz), launches=launches,
             floor_ms=floor["ms"], floor_back_to_back_ms=floor["back_to_back_ms"],
             enqueue_us=enqueue_us(torch, lambda: m.matvec(x)),
             config=dmod.card_launch(n, 1, 0), max_abs_err=0.0)
    emit(phase="config4_k1_timing", **t)
    return op, v0, launches, t


def profile_config4(torch, stt, op, v0):
    """Where config #4's time goes: the start and three restarts of the
    same solve under torch.profiler, outside the counted run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e = stt.GenEigsSolver(op, nev=6, ncv=30)
        e.init(v0)
        e.compute(stt.SortRule.LargestMagn, maxit=3, tol=1e-10)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit_profile("profile_config4_restarts", prof, wall_ms,
                 restarts=e.num_iterations() - 1, operations=e.num_operations())


def gen_matrix_n1000():
    """``benchmark/harness.py:44-45,101-102``: the reference benchmark's
    general case, ``default_rng(1000).uniform(size=(1000, 1000)) - 0.5``."""
    return np.random.default_rng(1000).uniform(size=(1000, 1000)) - 0.5


def run_gen_dense(torch, stt):
    """The reference benchmark's case ``("gen", 1000, 10, 30)``
    (``benchmark/harness.py:71-83,143``): nev 10, ncv 30, LargestMagn,
    maxit 1000, tol 1e-10, v0 ``SimpleRandom(0)``, on the dense drivers
    ``auto`` (the native driver's general leg, host) and ``torch`` (the
    IRAM on dense products on the card); each wall the minimum of 3
    after a warm-up, as ``bench.py`` takes it. Checks 10/10,
    ``||AU - U Lambda||_inf <= 1e-9``, every value within 1e-8 of an
    eigenvalue from ``numpy.linalg.eigvals`` and no native fallback."""
    import os

    from spectra_tpu_torch.solvers import _native_dense
    from spectra_tpu_torch.util.rng import SimpleRandom

    A = gen_matrix_n1000()
    n, k, m = 1000, 10, 30
    v0 = SimpleRandom(0).random_vec(n)
    w = np.linalg.eigvals(A)
    _native_dense.FALLBACKS = 0
    prev = os.environ.get("SPECTRA_TPU_DENSE_DRIVER")
    walls = {}
    try:
        for driver in ("auto", "torch"):
            os.environ["SPECTRA_TPU_DENSE_DRIVER"] = driver
            e = stt.GenEigsSolver(stt.DenseGenMatProd.create(A), nev=k, ncv=m)
            native = _native_dense.eligible(e, sym=False)
            e.init(v0)
            e.compute(stt.SortRule.LargestMagn, maxit=1000, tol=1e-10)
            times = []
            for _ in range(3):
                e.init(v0)
                t0 = time.perf_counter()
                e.compute(stt.SortRule.LargestMagn, maxit=1000, tol=1e-10)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            walls[driver] = min(times)
            err = float(max(np.min(np.abs(w - v)) for v in e.eigenvalues()))
            gen_check(A, e, k, "gen_dense_n1000", run=driver, routed_native=native,
                      wall_s=min(times), walls_s=times, max_dist_to_eigvals=err)
            if native != (driver == "auto") or err > 1e-8:
                raise RuntimeError(f"gen n=1000 ({driver}): native {native}, error {err}")
    finally:
        if prev is None:
            os.environ.pop("SPECTRA_TPU_DENSE_DRIVER", None)
        else:
            os.environ["SPECTRA_TPU_DENSE_DRIVER"] = prev
    emit(phase="gen_dense_n1000_fallbacks", fallbacks=_native_dense.FALLBACKS,
         native_over_torch=walls["auto"] / walls["torch"])
    if _native_dense.FALLBACKS != 0:
        raise RuntimeError("a native general solve fell back to the IRAM")


def run_gen_shift_modes(torch, stt, dmod):
    """One solve of each general shift mode, each checked by
    ``||AU - U Lambda||_inf <= 1e-9`` on the original A, with its wall:
    the real and the complex dense LU shift-solves on the n=1000 matrix
    (sigma 0.5, and 0.5 + 0.5i), the sparse real shift-solve by SuperLU
    and by BiCGStab (K1 on the card) and the sparse complex one by
    SuperLU on config #4's operator at g=100 (sigma 0, and 0.2 + 0.3i),
    and the Krylov-Schur restart on the same operator."""
    A = gen_matrix_n1000()
    S = config4_matrix(100)
    runs = [
        ("dense_real_shift_lu", A, lambda: stt.GenEigsRealShiftSolver(
            stt.DenseGenRealShiftSolve.create(A), 6, 20, 0.5)),
        ("dense_complex_shift_lu", A, lambda: stt.GenEigsComplexShiftSolver(
            stt.DenseGenComplexShiftSolve.create(A), 6, 20, 0.5, 0.5)),
        ("sparse_real_shift_splu", S, lambda: stt.GenEigsRealShiftSolver(
            stt.SparseGenRealShiftSolve.create(S, method="splu"), 6, 20, 0.0)),
        ("sparse_real_shift_bicgstab", S, lambda: stt.GenEigsRealShiftSolver(
            stt.SparseGenRealShiftSolve.create(S, method="bicgstab"), 6, 20, 0.0)),
        ("sparse_complex_shift_splu", S, lambda: stt.GenEigsComplexShiftSolver(
            stt.SparseGenComplexShiftSolve.create(S, method="splu"), 6, 20, 0.2, 0.3)),
        ("krylov_schur_g100", S, lambda: stt.GenEigsSolver(
            stt.SparseGenMatProd.create(S), 6, 30)),
    ]
    for label, M, make in runs:
        torch.cuda.synchronize()
        before = dmod.LAUNCHES
        t0 = time.perf_counter()
        e = make()
        if label == "krylov_schur_g100":
            e.set_restart_method("krylov_schur")
        e.init()
        e.compute(stt.SortRule.LargestMagn, maxit=1000, tol=1e-10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dmod.LAUNCHES - before
        gen_check(M, e, 6, "gen_shift_modes", run=label, wall_s=wall, k1_launches=launches)
        if label in ("sparse_real_shift_bicgstab", "krylov_schur_g100") and launches == 0:
            raise RuntimeError(f"{label} made no K1 launch")


def rand_herm(n, seed=123):
    """``tests/test_herm_eigs.py:10-13``: a random dense Hermitian matrix."""
    rng = np.random.RandomState(seed)
    A = (rng.uniform(size=(n, n)) - 0.5) + 1j * (rng.uniform(size=(n, n)) - 0.5)
    return A + A.conj().T


def sparse_herm(n, per_row, seed):
    """A random sparse Hermitian matrix built as ``tests/test_sparse.py:
    17-27`` builds its complex matrices, then ``A + A^H``: about
    ``per_row`` nonzeros a row."""
    import scipy.sparse as sps

    density = per_row / 4 / n
    A = sps.random(n, n, density=density, random_state=np.random.RandomState(seed),
                   format="csr")
    A = A + 1j * sps.random(n, n, density=density,
                            random_state=np.random.RandomState(seed + 1))
    return (A + A.conj().T).tocsr()


def herm_check(phase, A, vals, U, k, want, wall, **extra):
    """One Hermitian solve's check: k pairs, ``||AU - U Lambda||_inf <=
    1e-9`` on the host in complex128, and every value within 1e-9 of
    ``want`` (both sorted)."""
    resid = float(np.abs(A @ U - U * vals[None, :]).max()) if len(vals) else None
    err = float(np.abs(np.sort(vals) - np.sort(want)).max()) if len(vals) == k else None
    emit(phase=phase, nconv=len(vals), residual_inf=resid, max_err_vs_reference=err,
         wall_s=wall, eigenvalues=np.sort(vals).tolist(), **extra)
    if len(vals) != k or resid > 1e-9 or err > 1e-9:
        raise RuntimeError(f"{phase} {extra.get('run', '')}: {len(vals)}/{k}, "
                           f"residual {resid}, error {err}")


def run_hermitian(torch, stt):
    """The Hermitian solvers at the reference's test sizes
    (``test/HermEigs.cpp``): ``HermEigsSolver`` on ``DenseHermMatProd`` of
    ``rand_herm(1000)``, k=20, ncv=50, LargestAlge and SmallestMagn; the
    same matrix through ``RealEmbeddedHermMatProd`` (the J-structured
    Lanczos on the card) and through ``DenseHermShiftSolve`` at sigma=0.5
    (the Hermitian Bunch-Kaufman factorization on the card); and
    ``SparseHermMatProd`` (ELL) of a random sparse Hermitian matrix at
    n = 10^4, about 20 nonzeros a row, k=10, LargestAlge, against
    ``scipy.sparse.linalg.eigsh``. Each checked by ``herm_check``."""
    from scipy.sparse.linalg import eigsh

    n, k, m = 1000, 20, 50
    A = rand_herm(n)
    w = np.linalg.eigvalsh(A)
    op = stt.DenseHermMatProd.create(A)
    wanted = {"LargestAlge": w[-k:], "SmallestMagn": w[np.argsort(np.abs(w))[:k]]}
    for rule, want in wanted.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        e = stt.HermEigsSolver(op, nev=k, ncv=m)
        e.init()
        e.compute(getattr(stt.SortRule, rule), maxit=1000, tol=1e-10)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        U = e.eigenvectors()
        if U.device != op.device or not U.is_complex():
            raise RuntimeError(f"the Hermitian eigenvectors are {U.dtype} on {U.device}")
        herm_check("hermitian", A, e.eigenvalues(), U.cpu().numpy(), k, want, wall,
                   run=f"dense_{rule}", n=n, info=e.info().name,
                   restarts=e.num_iterations(), operations=e.num_operations())

    t0 = time.perf_counter()
    emb = stt.RealEmbeddedHermMatProd.create(A)
    e = stt.SymEigsSolver(emb, nev=k, ncv=m)
    e.init()
    e.compute(stt.SortRule.LargestAlge, maxit=1000, tol=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    Z = emb.recover_eigenvectors(e.eigenvectors()).cpu().numpy()
    herm_check("hermitian", A, e.eigenvalues(), Z, k, w[-k:], wall,
               run="real_embedded_LargestAlge", n=2 * n, info=e.info().name,
               structured=type(e._arnop).__name__,
               restarts=e.num_iterations(), operations=e.num_operations())

    sigma = 0.5
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    shifted = stt.DenseHermShiftSolve.create(A).set_shift(sigma)
    torch.cuda.synchronize()
    factor_s = time.perf_counter() - t0
    e = stt.SymEigsShiftSolver.from_factored(shifted, k, m, sigma)
    e.init()
    e.compute(stt.SortRule.LargestMagn, maxit=1000, tol=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    herm_check("hermitian", A, e.eigenvalues(), e.eigenvectors().cpu().numpy(), k,
               w[np.argsort(np.abs(w - sigma))[:k]], wall, run="shift_invert_bkldlt",
               n=n, sigma=sigma, factorize_s=factor_s, info=e.info().name,
               pivots_2x2=int(shifted.factors.is2x2.sum()),
               restarts=e.num_iterations(), operations=e.num_operations())

    S = sparse_herm(10_000, 20, 17)
    t0 = time.perf_counter()
    ref = eigsh(S, k=10, which="LA", return_eigenvectors=False)
    scipy_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    sop = stt.SparseHermMatProd.create(S)
    e = stt.HermEigsSolver(sop, nev=10, ncv=30)
    e.init()
    e.compute(stt.SortRule.LargestAlge, maxit=1000, tol=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    herm_check("hermitian", S, e.eigenvalues(), e.eigenvectors().cpu().numpy(), 10, ref,
               wall, run="sparse_LargestAlge", n=S.shape[0], nnz=int(S.nnz),
               format=type(sop.ell).__name__, info=e.info().name,
               restarts=e.num_iterations(), operations=e.num_operations(),
               scipy_eigsh_s=scipy_s)


def config5b_matrix(n):
    """``bench.py:386-402``: config #5b's diagonally dominant banded
    matrix, ``diags([off2, off1, d, off1, off2], [-1000, -1, 0, 1, 1000])``
    with ``d = linspace(1, 100, n)**2``."""
    import scipy.sparse as sps

    d = np.linspace(1.0, 100.0, n) ** 2
    off1, off2 = np.full(n, 0.5), np.full(n, 0.25)
    A = sps.diags([off2, off1, d, off1, off2], [-1000, -1, 0, 1, 1000],
                  shape=(n, n), format="csr")
    return A, d


#: The JAX package's iterations at n = 250,000 on its accelerator
#: (``bench_details.json``, ``davidson_250k_k10``), printed beside the
#: port's for information.
JAX_DAVIDSON_250K_NITER = 15


def solve_config5b(torch, stt, dmod, pf, n, label):
    """Config #5b as ``bench.py:386-402`` builds and solves it at size n:
    ``SparseSymMatProd.from_full`` (DIA on the card, d=5, under the hi/lo
    threshold), ``DavidsonSymEigsSolver(op, nev=10)``, ``compute(LargestAlge,
    maxit=150, tol=1e-9 * max(d))``, the operator counted by
    :class:`CountingOp`. Checks 10/10 ``Successful``, every residual
    2-norm within tol, ``||U^T U - I||_max <= 1e-10``, K1's launches equal
    to the operator's calls and its columns equal to ``num_operations()``.
    Every QR of the correction blocks must be the TSQR kernel's.
    Returns (values, K1 launches, the operator, the walls and the TSQR
    kernel's QRs)."""
    from spectra_tpu_torch.linalg import orthogonalization as porth
    from spectra_tpu_torch.ops import tsqr

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    A, d = config5b_matrix(n)
    op = stt.SparseSymMatProd.from_full(A)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    m = op.ell
    if not isinstance(m, pf.DiaMatrix) or m.offsets != (-1000, -1, 0, 1, 1000):
        raise RuntimeError(f"config #5b's operator is {type(m).__name__}")
    tol = 1e-9 * float(d.max())
    counted = CountingOp(op)
    torch.cuda.synchronize()
    dmod.LAUNCHES = 0
    tsqr.LAUNCHES = porth.LIBRARY_QRS = 0
    t0 = time.perf_counter()
    e = stt.DavidsonSymEigsSolver(counted, nev=10)
    nconv = e.compute(stt.SortRule.LargestAlge, maxit=150, tol=tol)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    launches, qrs, library_qrs = dmod.LAUNCHES, tsqr.LAUNCHES, porth.LIBRARY_QRS
    vals = e.eigenvalues()
    U = e.eigenvectors()
    norms = torch.linalg.vector_norm(
        dmod.dia_spmv_plain(m.data, m.offsets, U.contiguous(), n) - U * torch.from_numpy(
            vals).to(U.device)[None, :], dim=0).cpu().numpy()
    orth = float((U.mT @ U - torch.eye(U.shape[1], dtype=U.dtype, device=U.device))
                 .abs().max())
    emit(phase="config5b_davidson", run=label, n=A.shape[0], nnz=int(A.nnz), nconv=nconv,
         info=e.info().name, niter=e.num_iterations(),
         jax_niter_250k_tpu=JAX_DAVIDSON_250K_NITER if n == 250_000 else None,
         operations=e.num_operations(), operator_calls=counted.calls,
         operator_columns=counted.columns, k1_launches=launches,
         tsqr_qrs=qrs, library_qrs=library_qrs, build_s=build_s,
         solve_s=solve_s, tol=tol, max_residual=float(norms.max()),
         orthogonality=orth, format=type(m).__name__, offsets=list(m.offsets),
         eigenvalues=np.sort(vals)[::-1].tolist())
    if nconv != 10 or e.info() != stt.CompInfo.Successful:
        raise RuntimeError(f"config #5b at n={n}: {nconv}/10, {e.info().name}")
    if norms.max() > tol or orth > 1e-10:
        raise RuntimeError(f"config #5b at n={n}: residual {norms.max()}, "
                           f"orthogonality {orth}")
    if launches == 0 or launches != counted.calls or counted.columns != e.num_operations():
        raise RuntimeError(f"config #5b at n={n}: K1 {launches} launches, "
                           f"{counted.calls} calls, {counted.columns} columns, "
                           f"{e.num_operations()} operations")
    # two QRs an iteration that extends the space (all but the last), each
    # the TSQR kernel's, none the library's
    if qrs != 2 * (e.num_iterations() - 1) or library_qrs != 0:
        raise RuntimeError(f"config #5b at n={n}: {qrs} TSQR and {library_qrs} library QRs "
                           f"in {e.num_iterations()} iterations")
    return vals, launches, op, dict(build_s=build_s, solve_s=solve_s, tsqr_qrs=qrs)


def run_config5b(torch, stt, dmod, pf):
    """Config #5b at n = 10^6 (``bench.py``'s at-scale size) and at n =
    250,000 (the JAX package's recorded run), each by
    :func:`solve_config5b`; then the independent check at n = 100,000
    (``bench.py``'s CPU size): the port on the card against host
    ``scipy.sparse.linalg.eigsh(A, k=10, which="LA", tol=1e-9,
    v0=SimpleRandom(0))``, the values within 1e-9 ||A||, as
    ``bench.py:404-427`` compares them. Returns the n = 10^6 operator,
    K1's launches by size and the TSQR kernel's QRs at n = 10^6."""
    from scipy.sparse.linalg import eigsh

    from spectra_tpu_torch.util.rng import SimpleRandom

    launches = {}
    _, launches[1_000_000], op_1m, walls = solve_config5b(torch, stt, dmod, pf, 1_000_000, "1M")
    qrs_1m = walls["tsqr_qrs"]
    _, launches[250_000], _, _ = solve_config5b(torch, stt, dmod, pf, 250_000, "250k")
    n = 100_000
    vals, launches[n], _, walls = solve_config5b(torch, stt, dmod, pf, n, "100k")
    A, d = config5b_matrix(n)
    t0 = time.perf_counter()
    w = eigsh(A, k=10, which="LA", tol=1e-9, v0=SimpleRandom(0).random_vec(n),
              return_eigenvectors=False)
    arpack_s = time.perf_counter() - t0
    err = float(np.abs(np.sort(vals)[::-1] - np.sort(w)[::-1]).max())
    emit(phase="config5b_vs_arpack", n=n, arpack_s=arpack_s, port_solve_s=walls["solve_s"],
         eval_abs_err_vs_arpack=err, eval_err_vs_arpack_over_normA=err / float(d.max()))
    if err > 1e-9 * float(d.max()):
        raise RuntimeError(f"config #5b at n={n} is {err} from ARPACK")
    return op_1m, launches, qrs_1m


def profile_config5b(torch, stt, op):
    """Where config #5b's time goes: three Davidson iterations at n =
    10^6 under torch.profiler, outside the counted run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        e = stt.DavidsonSymEigsSolver(op, nev=10)
        e.compute(stt.SortRule.LargestAlge, maxit=3, tol=1e-9 * 1e4)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    emit_profile("profile_config5b_iterations", prof, wall_ms,
                 iterations=e.num_iterations(), operations=e.num_operations())


def run_contrib(torch, stt, dmod):
    """The ``contrib`` solvers: ``PartialSVDSolver`` on a dense tall
    (2000, 1000) and wide (1000, 2000) normal matrix against
    ``numpy.linalg.svd`` and on config #4's convection operator at g=100
    (DIA: K1 forward, the plain ``rmatvec`` adjoint) against
    ``scipy.sparse.linalg.svds``; ``LOBPCGSolver`` for the 10 smallest of
    the g=100 2-D Laplacian (DIA, K1 on its blocks), ``maxit=500``,
    ``tol_div_n=1e-10``, against the analytic values, and the
    constraint-deflation case of ``tests/test_contrib.py:89-106`` at g=32.
    Each with its residual and wall; K1's launches equal the products'
    calls where the operator is DIA."""
    from scipy.sparse.linalg import svds

    def svd_check(run, A, svds_obj, ref, wall, **extra):
        s = svds_obj.singular_values()
        U = svds_obj.matrix_U(5).cpu().numpy()
        V = svds_obj.matrix_V(5).cpu().numpy()
        resid = float(np.abs(A @ V - U * s[None, :]).max()) if len(s) == 5 else None
        err = float(np.abs(s - ref).max()) if len(s) == 5 else None
        emit(phase="contrib", run=run, nconv=len(s), info=svds_obj.info().name,
             restarts=svds_obj.num_iterations(), operations=svds_obj.num_operations(),
             max_err=err, residual_inf=resid, wall_s=wall,
             singular_values=s.tolist(), **extra)
        if len(s) != 5 or err > 1e-8 * max(1.0, ref[0]) or resid > 1e-7:
            raise RuntimeError(f"partial SVD {run}: error {err}, residual {resid}")

    rng = np.random.default_rng(2000)
    for shape in ((2000, 1000), (1000, 2000)):
        A = rng.normal(size=shape)
        t0 = time.perf_counter()
        p = stt.PartialSVDSolver(A, ncomp=5, ncv=15)
        p.compute()
        torch.cuda.synchronize()
        svd_check(f"partial_svd_dense_{shape[0]}x{shape[1]}", A, p,
                  np.linalg.svd(A, compute_uv=False)[:5], time.perf_counter() - t0)

    S = config4_matrix(100)
    ref = np.sort(svds(S, k=5, return_singular_vectors=False))[::-1]
    torch.cuda.synchronize()
    dmod.LAUNCHES = 0
    t0 = time.perf_counter()
    p = stt.PartialSVDSolver(S, ncomp=5, ncv=20)
    p.compute()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dmod.LAUNCHES
    svd_check("partial_svd_config4_g100", S, p, ref, wall, format=type(p._matop.ell).__name__,
              k1_launches=launches)
    if launches != p.num_operations():
        raise RuntimeError(f"partial SVD on DIA: K1 {launches}, {p.num_operations()} products")

    g = 100
    L = laplacian_2d(g)
    op = CountingOp(stt.SparseGenMatProd.create(L))
    X0 = np.random.default_rng(0).normal(size=(g * g, 10))
    torch.cuda.synchronize()
    dmod.LAUNCHES = 0
    t0 = time.perf_counter()
    lo = stt.LOBPCGSolver(op, X0)
    nconv = lo.compute(maxit=500, tol_div_n=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dmod.LAUNCHES
    vals = np.sort(lo.eigenvalues())
    err = float(np.abs(vals - analytic_2d(g)[:10]).max())
    emit(phase="contrib", run="lobpcg_laplacian_g100", nconv=nconv, info=lo.info().name,
         iterations=lo.num_iterations(), max_err_vs_analytic=err,
         max_residual=float(lo.residuals().max()), tol=1e-10 * g * g, wall_s=wall,
         k1_launches=launches, operator_calls=op.calls, operator_columns=op.columns,
         format=type(op.op.ell).__name__)
    if nconv != 10 or lo.info() != stt.CompInfo.Successful or err > 1e-6:
        raise RuntimeError(f"LOBPCG at g=100: {nconv}/10, error {err}")
    if launches == 0 or launches != op.calls:
        raise RuntimeError(f"LOBPCG at g=100: K1 {launches} launches, {op.calls} calls")

    g = 32
    L = laplacian_2d(g)
    w, V = np.linalg.eigh(L.toarray())
    t0 = time.perf_counter()
    lo = stt.LOBPCGSolver(L, np.random.default_rng(3).normal(size=(g * g, 2)))
    lo.set_constraints(V[:, :2])
    nconv = lo.compute(maxit=300, tol_div_n=1e-10)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    err = float(np.abs(np.sort(lo.eigenvalues()) - w[2:4]).max())
    emit(phase="contrib", run="lobpcg_constraints_g32", nconv=nconv, info=lo.info().name,
         iterations=lo.num_iterations(), max_err_vs_eigh=err,
         max_residual=float(lo.residuals().max()), wall_s=wall)
    if nconv != 2 or lo.info() != stt.CompInfo.Successful or err > 1e-6:
        raise RuntimeError(f"LOBPCG with constraints at g=32: {nconv}/2, error {err}")


#: K1's shapes on the JD and contrib paths, as (label, n, matrix, column
#: counts; 1 is a vector): config #5b's operator (Davidson's 20- then
#: 10-column blocks), LOBPCG's g=100 Laplacian (10 columns) and the
#: partial SVD's g=100 convection operator (its IRLM's vectors, and the
#: 5 columns of ``_cross``).
K1_CONTRIB_SHAPES = (
    ("config5b", 250_000, lambda: config5b_matrix(250_000)[0], (10, 20)),
    ("config5b", 1_000_000, lambda: config5b_matrix(1_000_000)[0], (10, 20)),
    ("lobpcg_g100", 100**2, lambda: laplacian_2d(100), (10,)),
    ("partial_svd_g100", 100**2, lambda: config4_matrix(100), (1, 5)),
)


def phase_k1_blocks(torch, dmod, pf, rates, floor):
    """K1 at ``K1_CONTRIB_SHAPES`` (d=5, f64), bitwise against its plain
    version on the card, then timed cold beside its bound (data, X and Y
    once each), its plain version and one ``torch.sparse`` CSR product
    with the dense block or vector."""
    bandwidth, f64_rate, _ = rates
    timer = Timer(torch)
    out = {}
    for matrix, n, build, columns in K1_CONTRIB_SHAPES:
        A = build()
        m = pf.dia_from_scipy(A)
        csr = torch_csr(torch, A, np.float64)
        d = len(m.offsets)
        for ncol in columns:
            X = torch.randn(n if ncol == 1 else (n, ncol), dtype=torch.float64, device="cuda")
            product = m.matvec if ncol == 1 else m.matmat
            Y = product(X)
            if not torch.equal(Y, dmod.dia_spmv_plain(m.data, m.offsets, X, n)):
                raise RuntimeError(f"K1 is not bitwise its plain version on "
                                   f"{ncol} columns at n={n}")
            t = timed_entry(
                timer, lambda: product(X),
                lambda: dmod.dia_spmv_plain(m.data, m.offsets, X, n),
                lambda: csr @ X, (d * n + 2 * n * ncol) * 8, 2 * A.nnz * ncol,
                f64_rate, bandwidth, back_to_back=True,
            )
            t.update(kernel="dia_spmv", matrix=matrix, n=n, d=d, ncol=ncol,
                     nnz=int(A.nnz), floor_ms=floor["ms"],
                     config=dmod.card_launch(n, ncol, 0),
                     enqueue_us=enqueue_us(torch, lambda: product(X)), max_abs_err=0.0)
            emit(phase="k1_block_timing", **t)
            out[f"{matrix}_n{n}_c{ncol}"] = t
        del m, csr
        torch.cuda.empty_cache()
    return out


def run_frontends(torch, stt, dmod, pmg, pf):
    """Phase 11m: the scipy-style frontends (``stt.eigsh``, ``stt.eigs``,
    ``stt.svds``) at full width. The frontends return arrays only, so the
    phase records the solvers whose ``compute`` a call runs and prints
    their counts. Each call: its wall, nconv, restarts, operations and
    K1 launches (the counters set to 0 just before it). Checks: config
    #3's shift-invert (``method="mg"``) and the 10 largest of the same
    matrix (``ncv=100``: the plain IRLM's default 21 would need tens of
    thousands of restarts on its 3e-5-wide top cluster) within 1e-9 of
    the analytic values, K1 launches equal to what the path implies;
    config #4's operator at g=100 with backward error <= 1e-9 and one K1
    launch an operation; a dense 2000 x 1000 partial SVD within 1e-9
    (relative) of numpy's; config #5a's pair at g=64 within a relative
    1e-9. Returns K1's launches by call."""
    from spectra_tpu_torch.solvers.base import HermEigsBase
    from spectra_tpu_torch.solvers.gen_base import GenEigsBase

    launches = {}

    def call(label, fn):
        seen = []
        saved = {cls: cls.__dict__["compute"] for cls in (HermEigsBase, GenEigsBase)}

        def recording(orig):
            def compute(self, *args, **kwargs):
                seen.append(self)
                return orig(self, *args, **kwargs)
            return compute

        torch.cuda.synchronize()
        dmod.LAUNCHES = 0
        pmg.CYCLES = pmg.SOLVES = 0
        for cls, orig in saved.items():
            cls.compute = recording(orig)
        try:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            for cls, orig in saved.items():
                cls.compute = orig
        launches[label] = dmod.LAUNCHES
        return out, seen[0], wall, dmod.LAUNCHES, pmg.CYCLES, pmg.SOLVES

    def report(label, s, wall, k1, nconv, ok, **extra):
        emit(phase="frontends", call=label, wall_s=wall, nconv=nconv,
             info=s.info().name, restarts=s.num_iterations(),
             operations=s.num_operations(), k1_launches=k1, **extra)
        if not ok:
            raise RuntimeError(f"frontends: {label} missed its check ({extra})")

    A = laplacian_2d(G_FULL)
    lam = analytic_2d(G_FULL)
    (w, v), s, wall, k1, cycles, solves = call(
        "eigsh_sigma0_mg_g1000",
        lambda: stt.eigsh(A, k=10, sigma=0.0, method="mg"))
    err = float(np.abs(w - lam[:10]).max())
    expected = expected_launches(s._op.mg, pf.DiaMatrix, cycles, solves)
    report("eigsh_sigma0_mg_g1000", s, wall, k1, len(w),
           len(w) == 10 and err <= 1e-9 and k1 == expected,
           max_err_vs_analytic=err, expected_k1_launches=expected,
           inner_solves=solves, v_cycles=cycles)
    (w, v), s, wall, k1, _, _ = call(
        "eigsh_LA_g1000", lambda: stt.eigsh(A, k=10, which="LA", ncv=100))
    err = float(np.abs(w - lam[-10:]).max())
    report("eigsh_LA_g1000", s, wall, k1, len(w),
           len(w) == 10 and err <= 1e-9 and k1 == s.num_operations(),
           ncv=100, max_err_vs_analytic=err)
    del A, v

    C = config4_matrix(100)
    (w, v), s, wall, k1, _, _ = call("eigs_config4_g100", lambda: stt.eigs(C, k=6))
    resid = float(np.abs(C @ v - v * w[None, :]).max())
    report("eigs_config4_g100", s, wall, k1, len(w),
           len(w) == 6 and resid <= 1e-9 and k1 == s.num_operations(),
           residual_inf=resid, eigenvalues=[str(x) for x in w])

    M = np.random.default_rng(2000).normal(size=(2000, 1000))
    ref = np.sort(np.linalg.svd(M, compute_uv=False)[:5])
    (u, sv, vh), s, wall, k1, _, _ = call("svds_dense_2000x1000", lambda: stt.svds(M, k=5))
    err = float(np.abs(sv - ref).max() / ref.max())
    resid = float(np.abs(M @ vh.T - u * sv[None, :]).max())
    report("svds_dense_2000x1000", s, wall, k1, len(sv),
           len(sv) == 5 and err <= 1e-9 and resid <= 1e-7,
           rel_err_vs_numpy=err, residual_inf=resid)

    Ka, Mb = config5a_pair(64)
    want = config5a_analytic(64)
    (w, v), s, wall, k1, _, _ = call(
        "eigsh_generalized_sigma0_g64", lambda: stt.eigsh(Ka, k=10, M=Mb, sigma=0.0))
    rel = float(np.abs((w - want) / want).max())
    resid = float(np.abs(Ka @ v - (Mb @ v) * w[None, :]).max())
    report("eigsh_generalized_sigma0_g64", s, wall, k1, len(w),
           len(w) == 10 and rel <= 1e-9 and resid <= 1e-9 and k1 > 0,
           max_rel_err_vs_analytic=rel, residual_inf=resid)
    return launches


def mixed_matrix(n, k=10):
    """``scripts/tpu_mixed_1m.py``'s matrix: ``d = linspace(1, 100, n)``
    with the top k set to ``100 * 1.05^i``, off-diagonals 0.25 / 0.5 at
    offsets +-1000 and +-1 (DIA, d=5)."""
    import scipy.sparse as sps

    d = np.linspace(1.0, 100.0, n)
    d[-k:] = 100.0 * 1.05 ** np.arange(1, k + 1)
    return sps.diags(
        [np.full(n, 0.25), np.full(n, 0.5), d, np.full(n, 0.5), np.full(n, 0.25)],
        [-1000, -1, 0, 1, 1000], shape=(n, n), format="csr",
    )


def run_mixed_precision(torch, stt, dmod, pf):
    """Phase 11n: ``scripts/tpu_mixed_1m.py``'s configuration through the
    port: ``SymEigsSolver(nev=10, ncv=30)``, LargestAlge, maxit 500, v0
    ``SimpleRandom(0)``, mixed at tol 1e-6 and double at tol 1e-10, each
    a warm-up and a timed solve, at n = 10^6 (the script's at-scale
    size) and 250,000 (the size the JAX package recorded; no warm-ups).
    The counters are set to 0 just before each timed solve: K1's f32
    launches must equal the twin's operations, its f64 block launches
    two a refinement round, the double run's f64 launches its
    operations. K1 f32 is held bitwise against its plain version on the
    twin's planes. Raises unless nconv_mixed is 10, the values are within
    1e-9 max|lambda| of the double run's, and every residual re-measured
    on the f64 operator is within 1e-6 max|lambda|. Returns the K1
    launches of the timed runs by n."""
    from spectra_tpu_torch.solvers.mixed import cast_op_f32
    from spectra_tpu_torch.util.rng import SimpleRandom

    k = 10
    out = {}
    for n, warm in ((1_000_000, True), (250_000, False)):
        A = mixed_matrix(n, k)
        v0 = SimpleRandom(0).random_vec(n)

        def run(precision, tol):
            op = stt.SparseSymMatProd.from_full(A)
            s = stt.SymEigsSolver(op, nev=k, ncv=30)
            s.set_precision(precision)
            if warm:
                s.init(v0)
                s.compute(stt.SortRule.LargestAlge, maxit=500, tol=tol)
            s.init(v0)
            torch.cuda.synchronize()
            dmod.LAUNCHES = 0
            entries = count_entries(dmod)
            t0 = time.perf_counter()
            nconv = s.compute(stt.SortRule.LargestAlge, maxit=500, tol=tol)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            return nconv, wall, s, op, dict(entries)

        nc_m, wall_m, s_m, op, l_m = run("mixed", 1e-6)
        nc_d, wall_d, s_d, _, l_d = run("double", 1e-10)
        vals_m = np.sort(s_m.eigenvalues())[::-1]
        vals_d = np.sort(s_d.eigenvalues())[::-1]
        kk = min(nc_m, nc_d)
        err = float(np.abs(vals_m[:kk] - vals_d[:kk]).max()) if kk else None
        scale = float(np.abs(vals_d).max())
        rep = s_m.mixed_report()
        V = s_m.eigenvectors()
        th = torch.from_numpy(s_m.eigenvalues()).to(V.device)
        remeasured = float(torch.linalg.vector_norm(
            op.perform_op(V.contiguous()) - V * th[None, :], dim=0).max())
        twin_ops = s_m.num_operations() - 3 * nc_m
        rounds = rep["refine_rounds"]
        twin = cast_op_f32(op).ell
        x = torch.randn(n, dtype=torch.float32, device="cuda")
        y = dmod.dia_spmv(twin.data, twin.offsets, x, twin.n_cols)
        f32_err = float((y - dmod.dia_spmv_plain(twin.data, twin.offsets, x, twin.n_cols))
                        .abs().max())
        emit(phase="mixed_precision", n=n, nnz=int(A.nnz), warm_up=warm,
             nconv_mixed=nc_m, nconv_double=nc_d, wall_mixed_s=wall_m,
             wall_double_s=wall_d, speedup_vs_double=wall_d / wall_m,
             eval_err_vs_double=err, max_resid_f64=float(np.max(rep["resid_f64"])),
             remeasured_max_resid=remeasured, max_abs_eigenvalue=scale,
             twin_restarts=s_m.num_iterations(), twin_operations=twin_ops,
             refine_rounds=rounds, k1_launches_mixed=l_m, k1_launches_double=l_d,
             double_restarts=s_d.num_iterations(), double_operations=s_d.num_operations(),
             k1_f32_vs_plain_max_abs_err=f32_err, info=s_m.info().name)
        if nc_m != k or nc_d != k:
            raise RuntimeError(f"mixed precision at n={n}: nconv {nc_m} / {nc_d}")
        if err > 1e-9 * scale or remeasured > 1e-6 * scale:
            raise RuntimeError(f"mixed precision at n={n}: error {err}, residual {remeasured}")
        if l_m != {"f32": twin_ops, "f64_block": 2 * rounds} or rounds < 1:
            raise RuntimeError(f"mixed precision at n={n}: K1 launches {l_m}, twin "
                               f"operations {twin_ops}, {rounds} rounds")
        if l_d != {"f64": s_d.num_operations()}:
            raise RuntimeError(f"double at n={n}: K1 launches {l_d}")
        if f32_err != 0.0:
            raise RuntimeError(f"K1 f32 differs from its plain version on the twin: {f32_err}")
        out[n] = {"mixed": l_m, "double": l_d}
        del s_m, s_d, op, twin, V
        torch.cuda.empty_cache()
    return out


def with_nan_diagonal(A, i):
    """A copy of the CSR matrix A with a NaN at its diagonal entry (i, i)."""
    A = A.copy()
    lo, hi = A.indptr[i], A.indptr[i + 1]
    A.data[lo + int(np.searchsorted(A.indices[lo:hi], i))] = np.nan
    return A


def k1_nan_check(torch, dmod, dia, x):
    """K1 on ``x`` against its plain version: NaNs in the same places and
    every other entry bitwise equal. Returns the numbers of NaN and of
    non-finite entries in y."""
    y = dmod.dia_spmv(dia.data, dia.offsets, x, dia.n_cols)
    yp = dmod.dia_spmv_plain(dia.data, dia.offsets, x, dia.n_cols)
    nan = torch.isnan(y)
    if not torch.equal(nan, torch.isnan(yp)) or not torch.equal(y[~nan], yp[~nan]):
        raise RuntimeError("K1 on a non-finite input differs from its plain version")
    return int(nan.sum()), int((~torch.isfinite(y)).sum())


def run_nonfinite(torch, stt, dmod, pf):
    """Phase 11o: a non-finite operator ends every Lanczos run with
    ``NumericalIssue`` (``NoConvergence`` from the frontend), never with
    an exception of torch: config #2's matrix (n = 10^6, DIA on K1) with
    a NaN on its diagonal through ``SymEigsSolver`` (nev 10, ncv 30,
    maxit 5) and ``stt.eigsh`` (k 10, ``maxiter=5``); the mixed matrix at
    n = 250,000 times 1e38, finite in f64 but not its f32 twin, through
    ``set_precision("mixed")``; and a dense Hermitian n = 1000 holding a
    NaN through ``HermEigsSolver`` (nev 20, ncv 50). Each run must make
    ``maxit + 1`` restarts and ``ncv + 1 + maxit * (ncv - nev)``
    operations, as on the CPU, and K1's launches (counters set to 0 just
    before each run) must equal its operations. K1 is then held to its
    plain version on the NaN planes and on a NaN-carrying x (f64), and
    on the twin's infinite planes (f32): NaNs in the same places, the
    rest bitwise."""
    from spectra_tpu_torch.solvers.base import HermEigsBase
    from spectra_tpu_torch.solvers.mixed import cast_op_f32
    from spectra_tpu_torch.util.rng import SimpleRandom

    issue = stt.CompInfo.NumericalIssue
    maxit = 5
    out = {}

    def counted(fn):
        torch.cuda.synchronize()
        dmod.LAUNCHES = 0
        entries = count_entries(dmod)
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0, dmod.LAUNCHES, dict(entries)

    def check(label, s, nev, ncv, wall, launches, on_k1=True, **extra):
        counts = (s.info(), s.num_iterations(), s.num_operations())
        want = (issue, maxit + 1, ncv + 1 + maxit * (ncv - nev))
        emit(phase="nonfinite", run=label, info=s.info().name,
             restarts=counts[1], operations=counts[2], expected=list(want[1:]),
             k1_launches=launches, wall_s=wall, **extra)
        if counts != want:
            raise RuntimeError(f"nonfinite {label}: {counts}, expected {want}")
        if on_k1 and launches != s.num_operations():
            raise RuntimeError(f"nonfinite {label}: K1 launched {launches} times")
        out[label] = launches

    A = with_nan_diagonal(laplacian_2d(G_FULL), G_FULL * G_FULL // 2 + 17)
    v0 = SimpleRandom(0).random_vec(A.shape[0])
    op = stt.SparseSymMatProd.from_full(A)
    if type(op.ell) is not pf.DiaMatrix:
        raise RuntimeError(f"config #2's matrix is not DIA on the card: {type(op.ell)}")
    s = stt.SymEigsSolver(op, nev=10, ncv=30)
    s.init(v0)
    nconv, wall, k1, _ = counted(
        lambda: s.compute(stt.SortRule.LargestAlge, maxit=maxit))
    check("sym_eigs_config2_nan", s, 10, 30, wall, k1, nconv=nconv)

    seen = []
    orig = HermEigsBase.__dict__["compute"]

    def recording(self, *args, **kwargs):
        seen.append(self)
        return orig(self, *args, **kwargs)

    def frontend():
        try:
            stt.eigsh(A, k=10, which="LA", maxiter=maxit)
        except stt.NoConvergence as err:
            return str(err)
        raise RuntimeError("nonfinite: eigsh returned on a NaN matrix")

    HermEigsBase.compute = recording
    try:
        msg, wall, k1, _ = counted(frontend)
    finally:
        HermEigsBase.compute = orig
    if "NumericalIssue" not in msg:
        raise RuntimeError(f"nonfinite: eigsh raised {msg!r}")
    check("eigsh_config2_nan", seen[0], 10, seen[0]._ncv, wall, k1,
          raised="NoConvergence", default_ncv=seen[0]._ncv)

    nan_planes = k1_nan_check(torch, dmod, op.ell, torch.from_numpy(v0).cuda())
    x = torch.randn(A.shape[0], dtype=torch.float64, device="cuda")
    x[torch.randint(0, A.shape[0], (64,), device="cuda")] = float("nan")
    nan_x = k1_nan_check(torch, dmod, op.ell, x)
    del s, op, x

    B = mixed_matrix(250_000) * 1e38
    opm = stt.SparseSymMatProd.from_full(B)
    s = stt.SymEigsSolver(opm, nev=10, ncv=30)
    s.set_precision("mixed")
    s.init(SimpleRandom(0).random_vec(B.shape[0]))
    nconv, wall, k1, entries = counted(
        lambda: s.compute(stt.SortRule.LargestAlge, maxit=maxit, tol=1e-6))
    check("mixed_f32_overflow_n250000", s, 10, 30, wall, k1, nconv=nconv,
          k1_entries=entries)
    if entries != {"f32": s.num_operations()}:
        raise RuntimeError(f"nonfinite mixed: K1 entries {entries}")
    twin = cast_op_f32(opm).ell
    if bool(torch.isfinite(twin.data).all()):
        raise RuntimeError("the f32 twin of the scaled matrix did not overflow")
    x32 = torch.randn(B.shape[0], dtype=torch.float32, device="cuda")
    nan_twin = k1_nan_check(torch, dmod, twin, x32)
    del s, opm, twin, x32

    H = rand_herm(1000)
    H[500, 500] = np.nan
    s = stt.HermEigsSolver(stt.DenseHermMatProd.create(H), nev=20, ncv=50)
    s.init()
    nconv, wall, k1, _ = counted(
        lambda: s.compute(stt.SortRule.LargestAlge, maxit=maxit))
    check("herm_dense_n1000_nan", s, 20, 50, wall, k1, on_k1=False, nconv=nconv)
    if k1 != 0:
        raise RuntimeError(f"nonfinite: the dense Hermitian run launched K1 {k1} times")
    emit(phase="nonfinite_k1", nan_and_nonfinite_in_y={
        "f64_nan_planes": nan_planes, "f64_nan_x": nan_x,
        "f32_twin_planes": nan_twin}, bitwise_outside_nan=True)
    torch.cuda.empty_cache()
    return out


def scipy_dia_rows(A):
    """Row-aligned DIA ``(offsets, rows)`` of ``A`` by scipy's ``todia``
    and the row alignment, the route the port took before its native
    converter."""
    dia = A.todia()
    offsets = tuple(int(o) for o in dia.offsets)
    n_rows, n_cols = A.shape
    rows = np.zeros((len(offsets), n_rows), dtype=dia.data.dtype)
    width = dia.data.shape[1]
    for k, off in enumerate(offsets):
        lo = max(0, -off)
        hi = min(n_rows, n_cols - off, width - off)
        if hi > lo:
            rows[k, lo:hi] = dia.data[k, lo + off: hi + off]
    order = np.argsort(offsets)
    return tuple(offsets[i] for i in order), rows[order]


def north_star_host_steps(torch, pf, pmg, A243):
    """The hierarchy build's host steps at the north star's size, each
    by the native toolkit and by scipy in the same call: the CSR-to-DIA
    conversion of the g=243 operator (native ``csr_to_dia`` against
    scipy's ``todia`` with the row alignment) and the Galerkin product
    of MG level 1 (native ``galerkin_rap`` against scipy's
    ``P.T @ (A @ P)``), with the largest difference of the entries
    relative to the largest entry. Then ``dia_from_scipy`` of the
    operator as the path runs it (native, and the copy to the card).
    Returns that DIA matrix and the native level-1 CSR."""
    from spectra_tpu_torch import native

    t0 = time.perf_counter()
    offs_n, rows_n = native.csr_to_dia(A243.shape[0], A243.shape[1], A243.indptr,
                                       A243.indices, A243.data)
    native_dia_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    offs_s, rows_s = scipy_dia_rows(A243)
    scipy_dia_s = time.perf_counter() - t0
    if offs_n != offs_s:
        raise RuntimeError(f"csr_to_dia offsets {offs_n} against scipy's {offs_s}")
    dia_diff = float(np.abs(rows_n - rows_s).max() / np.abs(rows_s).max())
    del rows_n, rows_s
    P = pmg.prolong_matrix((G_NORTH,) * 3, "clip")
    t0 = time.perf_counter()
    A1 = native.galerkin_rap(A243, P).tocsr()
    native_rap_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    A1s = (P.T.tocsr() @ (A243 @ P)).tocsr()
    scipy_rap_s = time.perf_counter() - t0
    del P
    rap_diff = float(abs(A1 - A1s).max() / abs(A1s).max())
    same_pattern = A1.nnz == A1s.nnz
    del A1s
    t0 = time.perf_counter()
    dia243 = pf.dia_from_scipy(A243)
    torch.cuda.synchronize()
    todia_s = time.perf_counter() - t0
    emit(phase="north_star_host_steps", dia_from_scipy_s=todia_s,
         csr_to_dia_native_s=native_dia_s, todia_scipy_s=scipy_dia_s,
         dia_max_rel_diff=dia_diff, galerkin_level1_native_s=native_rap_s,
         galerkin_level1_scipy_s=scipy_rap_s, galerkin_max_rel_diff=rap_diff,
         level1_nnz=int(A1.nnz), level1_same_nnz_as_scipy=same_pattern,
         host_threads=os.cpu_count())
    if dia_diff != 0.0 or rap_diff > 1e-12:
        raise RuntimeError(f"native host steps disagree with scipy: DIA {dia_diff}, "
                           f"Galerkin {rap_diff}")
    return dia243, A1
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
    emit(phase="north_star_set_shift", toolkit="native", set_shift_total_s=set_shift_s,
         hierarchy_s=op.build_s.get("hierarchy"), dia_s=op.build_s.get("dia"),
         build_parts_s=op.build_s)
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
    """A DIA level (f64, f32 or hi/lo) as a ``torch.sparse`` CSR tensor
    of its dtype (f64 for hi/lo) built on the card, stored zeros
    dropped: the library call's operand."""
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
                        bytes_moved, ops, rate, bandwidth,
                        back_to_back=not hilo)
        launches = cycles * per_cycle + (cycles + 2 * solves if lv == 0 else 0)
        sums[hilo] += launches
        t.update(level=lv, kernel=kernel, dims=list(mg.dims_per_level[lv]), n=n, d=d,
                 nnz=int(csr.values().numel()), launches=launches,
                 card_s_per_run=launches * t["ms"] * 1e-3)
        emit(phase="north_star_level_timing", **t)
        rows.append(t)
        del csr, x
    torch.cuda.empty_cache()
    check_levels(torch, dmod, pf, mg, "north_star")
    if sums[True] != k2 or sums[False] != k1:
        raise RuntimeError(f"per-level launches {sums} do not add up to K2 {k2}, K1 {k1}")
    return rows


def profile_inner_solves(torch, op, phase, solves=3):
    """Where a shift-invert path's time goes: a few inner solves (its
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
    emit_profile(phase, prof, wall_ms,
                 inner_solves=solves, v_cycles=pmg.CYCLES - cycles)


def parent_ops(torch, parent):
    """K1 and P3 of the checkout at ``parent`` through its own Python
    wrappers (``ops/dia_spmv.py``, ``ops/dia_variants.py``), each bound
    to its own ``csrc`` source built with this tree's flags (one ``nvcc``
    each, both at once). Returns the two wrapper modules' namespaces."""
    import ctypes
    import types
    from pathlib import Path

    from spectra_tpu_torch.ops import _build

    out_dir = _build.BUILD_DIR.parent / "k1_parent"
    out_dir.mkdir(parents=True, exist_ok=True)
    root = Path(parent) / "spectra_tpu_torch"
    names = ("dia_spmv", "dia_variants")
    builds = {
        name: subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(root / "csrc" / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for name in names
    }
    mods = {}
    for name in names:
        log, _ = builds[name].communicate(timeout=600)
        if builds[name].returncode != 0:
            raise RuntimeError(f"the parent's {name}.cu did not build:\n{log}")
        path = root / "ops" / f"{name}.py"
        ns = {"__name__": f"parent_{name}"}
        exec(compile(path.read_text(), str(path), "exec"), ns)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        ns["_build"] = types.SimpleNamespace(load=lambda _, lib=lib: lib)
        mods[name] = types.SimpleNamespace(**ns)
    return mods["dia_spmv"], mods["dia_variants"]


def compare_parent(torch, dmod, vmod, pf, rates, parent):
    """The parent's K1, P3 and P4 and this tree's, each through its own
    wrapper, interleaved in one run (parent, change, change, parent) at
    every K1 shape of the paths: the north star's levels 2-4 (27-point,
    random data), config #2's (the 2-D g=1000 Laplacian, f64 and f32,
    and P3 and P4, at rows of ``P4_PARENT_ROWS``, on it in f32), the
    g=243 operator (7-point, random data, f64
    as mode A and f32 as P5), the launch floor (n=1, d=1) and the shapes
    of ``K1_CONTRIB_SHAPES`` (f64 blocks of 5 to 20 columns, and the
    partial SVD's vectors). Each turn:
    cold median, min, max (L2 flushed, 40 calls), back to back (200
    calls in one CUDA graph) and the host's enqueue time per call
    (``enqueue_us``, the wrapper included). Both outputs must be bitwise
    equal (the new kernel adds ``data * 0`` where the parent skipped a
    term: the same sum for finite data)."""
    bandwidth, f64_rate, f32_rate = rates
    timer = Timer(torch)
    old_k1, old_vmod = parent_ops(torch, parent)
    g2 = laplacian_2d(G_FULL)
    offs243 = (-G_NORTH**2, -G_NORTH, -1, 0, 1, G_NORTH, G_NORTH**2)
    lap = lambda: g2
    # (label, n, matrix: offsets of random data or a builder, dtype,
    # kernel, columns)
    shapes = [(f"level{lv}_g{g}", g**3, stencil27(g), torch.float64, "dia_spmv", 1)
              for lv, g in K1_LEVELS]
    shapes += [("config2_f64", G_FULL**2, lap, torch.float64, "dia_spmv", 1),
               ("config2_f32", G_FULL**2, lap, torch.float32, "dia_spmv", 1),
               ("p3_config2_f32", G_FULL**2, lap, torch.float32, "dia_noshift", 1),
               *((f"p4_config2_f32_r{r}", G_FULL**2, lap, torch.float32,
                  f"dia_roll2d_r{r}", 1) for r in P4_PARENT_ROWS),
               ("g243_operator", G_NORTH**3, offs243, torch.float64, "dia_spmv", 1),
               ("p5_g243_f32", G_NORTH**3, offs243, torch.float32, "dia_spmv", 1),
               ("launch_floor", 1, (0,), torch.float64, "dia_spmv", 1),
               *((f"{matrix}_n{n}_c{ncol}", n, build, torch.float64, "dia_spmv", ncol)
                 for matrix, n, build, columns in K1_CONTRIB_SHAPES for ncol in columns)]
    out = {}
    for label, n, source, dtype, kernel, ncol in shapes:
        if callable(source):
            m = pf.dia_from_scipy(source(), dtype=dtype)
        else:
            m = random_dia(torch, pf, n, n, source, dtype)
        x = torch.randn(n if ncol == 1 else (n, ncol), dtype=dtype, device="cuda")
        offs, d = m.offsets, len(m.offsets)
        config = dmod.card_launch(n, ncol, 0)
        if kernel == "dia_noshift":
            calls = dict(parent=lambda: old_vmod.dia_noshift(m.data, offs, x),
                         change=lambda: vmod.dia_noshift(m.data, offs, x))
        elif kernel.startswith("dia_roll2d"):
            rows = int(kernel.rsplit("_r", 1)[1])
            calls = dict(
                parent=lambda: old_vmod.dia_roll2d(m.data, offs, x, rows=rows),
                change=lambda: vmod.dia_roll2d(m.data, offs, x, rows=rows))
            config = vmod.card_plan(n, offs, rows, 0)._asdict()
        else:
            calls = dict(parent=lambda: old_k1.dia_spmv(m.data, offs, x, n),
                         change=lambda: dmod.dia_spmv(m.data, offs, x, n))
        bitwise = bool(torch.equal(calls["parent"](), calls["change"]()))
        turns = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            t = timer.stats(calls[who])
            t["back_to_back_ms"] = timer.back_to_back(calls[who])
            t["enqueue_us"] = enqueue_us(torch, calls[who])
            turns[who].append(t)
        csr = None if kernel == "dia_noshift" else dia_csr(torch, pf, m)
        terms = d * n if kernel == "dia_noshift" else sum(n - abs(o) for o in offs)
        rate = f64_rate if dtype == torch.float64 else f32_rate
        bound_ms = max((d + 2 * ncol) * x.element_size() * n / bandwidth,
                       2 * terms * ncol / rate) * 1e3
        mean = lambda who, key: float(np.mean([t[key] for t in turns[who]]))
        out[label] = dict(
            kernel=kernel, n=n, d=d, ncol=ncol, dtype=str(dtype).split(".")[1],
            bitwise_equal_parent=bitwise, config=config,
            parent=turns["parent"], change=turns["change"],
            parent_ms=mean("parent", "ms"), change_ms=mean("change", "ms"),
            parent_enqueue_us=mean("parent", "enqueue_us"),
            change_enqueue_us=mean("change", "enqueue_us"),
            library=None if csr is None else timer.stats(lambda: csr @ x),
            bound_ms=bound_ms,
        )
        emit(phase="k1_parent_vs_change", case=label, **out[label])
        if not bitwise:
            raise RuntimeError(f"the new {kernel} is not bitwise the parent's on {label}")
        del m, x, csr
        torch.cuda.empty_cache()
    return out


def md_laplacian(g):
    """The 2-D (``g`` = 1000) or 3-D Laplacian of a multi-device case."""
    return laplacian_2d(g) if g == G_FULL else laplacian_3d(g)


def sharded_kernel_check(torch, dmod, dsmod, op, mesh, x):
    """The kernel a sharded operator's ``perform_op`` launches, held to
    its plain version at the path's own shapes and data: ``op.perform_op
    (x)`` (``x`` the rank's rows, a vector or a block) against the plain
    product of the same rows. K1 for a ``ShardedStencilMatProd`` (the
    rank's (d, rows_per) diagonals, offsets shifted by ``lo``, x
    halo-extended by the mesh) and for a ``RowShardedMatProd`` of DIA
    rows (n_cols = n over the gathered x); K2's ``_ext`` entry for the
    hi/lo classes (each column of a block). Tolerance: bitwise. Returns
    the record (None for an operator with no kernel: ELL, dense)."""
    from spectra_tpu_torch.parallel import (
        RowShardedMatProd,
        ShardedStencilHiLoMatProd,
        ShardedStencilMatProd,
    )
    from spectra_tpu_torch.parallel.mesh import _HiLoRows, _window

    def ext_plain(dh, dl, offs, n, x_ext):
        if x_ext.ndim == 2:
            return torch.stack([ext_plain(dh, dl, offs, n, x_ext[:, c].contiguous())
                                for c in range(x_ext.shape[1])], dim=1)
        xh, xl = dsmod.split_f64(x_ext)
        return dsmod.combine_f64(*dsmod.dia_spmv_ds_ext_plain(dh, dl, xh, xl,
                                                              offsets=offs, n=n))

    local = getattr(op, "local", None)
    if isinstance(op, ShardedStencilMatProd):
        kernel, offs = "dia_spmv", op.offsets
        lo, hi = max(0, -min(offs)), max(0, max(offs))
        x_in = mesh.halo(x, lo, hi)
        d, n_rows = op.data.shape
        ref = dmod.dia_spmv_plain(op.data, tuple(o + lo for o in offs), x_in, x_in.shape[0])
    elif isinstance(op, ShardedStencilHiLoMatProd):
        kernel, offs = "dia_spmv_ds_ext", op.offsets
        lo, hi = max(0, -min(offs)), max(0, max(offs))
        x_in = mesh.halo(x, lo, hi)
        d, n_rows = len(offs), op.rows_per
        ref = ext_plain(op.data_hi, op.data_lo, offs, n_rows, x_in)
    elif isinstance(op, RowShardedMatProd) and type(local).__name__ == "DiaMatrix":
        kernel, x_in = "dia_spmv", mesh.all_gather(x)
        d, n_rows = local.data.shape
        ref = dmod.dia_spmv_plain(local.data, local.offsets, x_in, local.n_cols)
    elif isinstance(op, RowShardedMatProd) and isinstance(local, _HiLoRows):
        kernel, offs = "dia_spmv_ds_ext", local.offsets
        lo, hi = max(0, -min(offs)), max(0, max(offs))
        x_in = _window(mesh.all_gather(x), local.first, local.rows, lo, hi)
        d, n_rows = len(offs), local.rows
        ref = ext_plain(local.data_hi, local.data_lo, offs, n_rows, x_in)
    else:
        return None
    y = op.perform_op(x)
    bitwise = bool(torch.equal(y, ref))
    return dict(kernel=kernel, d=int(d), n=int(n_rows), n_cols=int(x_in.shape[0]),
                columns=1 if x.ndim == 1 else int(x.shape[1]), dtype=str(x.dtype)[6:],
                max_abs_err=float((y - ref).abs().max()), bitwise_equal=bitwise,
                ok=bitwise)


def expected_sharded_launches(smg, pf, cycles, solves):
    """K1 and K2 ``_ext`` launches of a sharded shift-invert path, from
    the port's code: per V-cycle ``nu1 + 1 + nu2`` K1 SpMVs on every
    sharded level and every DIA level of the replicated tail, and one on
    level 0 for ``mg_solve_sharded``'s residual; per solve one K1 SpMV
    for the first residual and one SpMV of the operator itself, on K2's
    ``_ext`` entry for a hi/lo operator (the backward-error gate of every
    inner solve, and the trial's own check at build time)."""
    tail = sum(isinstance(o, pf.DiaMatrix) for o in smg.bottom.ops)
    per_cycle = (smg.nu1 + 1 + smg.nu2) * (len(smg.s_ops) + tail) + 1
    return cycles * per_cycle + solves, solves


def run_multidevice_g160(torch, stt, dmod, dsmod, pmg, pf, rates):
    """One rank on NCCL at full size: the 3-D 7-point Laplacian at g=160
    (n = 4,096,000, 28.5M nnz), the JAX package's at-scale sharded record.
    ``sharded_stencil_op`` must route it to ``ShardedStencilHiLoMatProd``
    (per-shard working set 9 x 8 x 4,096,000 bytes, over 120 MiB); its
    SpMV is held to K1 f64 on the same matrix within 1e-13 relative, K2's
    ``_ext`` entry bitwise to its plain version at the path's shapes
    (halo-extended x from the mesh), and both are timed (cold median,
    min, max; back to back) beside the unsharded ``DiaHiLoMatrix.matvec``,
    the bound and one ``torch.sparse`` CSR product. Then the 20 smallest
    by ``sharded_stencil_shift_solve`` and ``compute_locked`` with the
    north-star script's settings, launches asserted against the code's
    count. Returns the ``_ext`` entry's kernel-line numbers."""
    from spectra_tpu_torch import distributed
    from spectra_tpu_torch.parallel import (
        ShardedStencilHiLoMatProd,
        row_mesh,
        sharded_stencil_op,
        sharded_stencil_shift_solve,
    )
    from spectra_tpu_torch.parallel.mesh import _free_port
    from spectra_tpu_torch.parallel.mg_sharded import ShardedMGState
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia
    from spectra_tpu_torch.util.rng import SimpleRandom

    bandwidth, f64_rate, f32_rate = rates
    distributed.initialize(init_method=f"tcp://127.0.0.1:{_free_port()}",
                           num_processes=1, process_id=0)
    mesh = row_mesh()
    if mesh.backend != "nccl" or mesh.staged:
        raise RuntimeError(f"one rank runs {mesh.backend} ({mesh.transport}), not NCCL")
    t0 = time.perf_counter()
    A = md_laplacian(G_MD)
    matrix_s = time.perf_counter() - t0
    n = A.shape[0]
    t0 = time.perf_counter()
    op = sharded_stencil_op(host_dia(A), mesh)
    torch.cuda.synchronize()
    op_s = time.perf_counter() - t0
    if not isinstance(op, ShardedStencilHiLoMatProd):
        raise RuntimeError(f"auto-routing chose {type(op).__name__} at g={G_MD}")
    offs, d, rp = op.offsets, len(op.offsets), op.rows_per
    lo, hi = max(0, -min(offs)), max(0, max(offs))
    dia64 = pf.dia_from_scipy(A)
    hilo1 = pf.DiaHiLoMatrix.from_dia(dia64)
    x = torch.randn(n, dtype=torch.float64, device="cuda")
    ref = dia64.matvec(x)
    y = op.perform_op(x)
    rel = float((y - ref).abs().max() / ref.abs().max())
    unsharded_rel = float((hilo1.matvec(x) - ref).abs().max() / ref.abs().max())
    x_ext = mesh.halo(x, lo, hi)
    xh, xl = dsmod.split_f64(x_ext)
    yh, yl = dsmod.dia_spmv_ds_ext(op.data_hi, op.data_lo, xh, xl, offsets=offs, n=rp)
    ph, pl = dsmod.dia_spmv_ds_ext_plain(op.data_hi, op.data_lo, xh, xl, offsets=offs, n=rp)
    bitwise = bool(torch.equal(yh, ph) and torch.equal(yl, pl))
    ext_err = float((dsmod.combine_f64(yh, yl) - dsmod.combine_f64(ph, pl)).abs().max())
    emit(phase="kernel_vs_plain", kernel="dia_spmv_ds", entry="ext",
         case=f"multidevice_g{G_MD}_one_rank", d=d, n=rp, lo=lo, hi=hi,
         max_abs_err=ext_err, bitwise_equal=bitwise, ok=bitwise)
    del yh, yl, ph, pl
    if not bitwise or rel > 1e-13:
        raise RuntimeError(f"g={G_MD}: _ext bitwise {bitwise}, sharded SpMV rel {rel}")
    timer = Timer(torch)
    csr = torch_csr(torch, A, np.float64)
    terms = sum(n - abs(o) for o in offs)
    ext_bytes = (8 * d + 16) * rp + 8 * (lo + hi)
    ext_t = timed_entry(
        timer,
        lambda: dsmod.dia_spmv_ds_ext(op.data_hi, op.data_lo, xh, xl, offsets=offs, n=rp),
        lambda: dsmod.dia_spmv_ds_ext_plain(op.data_hi, op.data_lo, xh, xl,
                                            offsets=offs, n=rp),
        lambda: csr @ x, ext_bytes, 23 * terms, f32_rate, bandwidth, back_to_back=True,
    )
    spmv = dict(
        sharded=timer.stats(lambda: op.perform_op(x)),
        sharded_back_to_back_ms=timer.back_to_back(lambda: op.perform_op(x)),
        unsharded_hilo_matvec=timer.stats(lambda: hilo1.matvec(x)),
        unsharded_back_to_back_ms=timer.back_to_back(lambda: hilo1.matvec(x)),
        k1_f64=timer.stats(lambda: dia64.matvec(x)),
        csr=timer.stats(lambda: csr @ x),
    )
    spmv_bound = ((d * 8 + 16) * n) / bandwidth * 1e3
    emit(phase="multidevice_g160_spmv", g=G_MD, n=n, nnz=int(A.nnz), d=d,
         op=type(op).__name__, per_shard_working_set=(d + 2) * 8 * rp,
         rel_err_vs_k1_f64=rel, unsharded_rel_err_vs_k1_f64=unsharded_rel,
         ext_kernel=ext_t, spmv_bound_ms=spmv_bound, matrix_s=matrix_s, op_build_s=op_s,
         **spmv)
    del dia64, hilo1, csr, xh, xl, x_ext, y, ref, x
    torch.cuda.empty_cache()

    v0 = SimpleRandom(0).random_vec(n)
    torch.cuda.synchronize()
    dmod.LAUNCHES = dsmod.LAUNCHES = 0
    k2_entries = count_entries(dsmod)
    pmg.CYCLES = pmg.SOLVES = 0
    mesh.reset_stats()
    t0 = time.perf_counter()
    si = sharded_stencil_shift_solve(A, 0.0, mesh)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_cycles, build_solves = pmg.CYCLES, pmg.SOLVES
    t0 = time.perf_counter()
    e = stt.SymEigsShiftSolver.from_factored(si, 20, 40, 0.0)
    e.set_matvec_granularity(True)
    e.init(v0)
    nconv = e.compute_locked(
        stt.SortRule.LargestMagn, maxit=60, tol=1e-10,
        sorting=stt.SortRule.SmallestAlge, want=stt.SortRule.SmallestAlge, max_rounds=3,
    )
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k1, k2 = dmod.LAUNCHES, dsmod.LAUNCHES
    k2_ext = k2_entries.get("ext", 0)
    cycles, solves = pmg.CYCLES, pmg.SOLVES
    stats = dict(mesh.stats)
    smg = si.mg
    if si.method != "mg" or not isinstance(smg, ShardedMGState):
        raise RuntimeError(f"g={G_MD}: the shift-solve runs {si.method}, not the sharded MG")
    # the path's kernels at its own shapes, after the counted run: K1 on
    # every sharded level (halo-extended x), on the replicated tail's DIA
    # levels, and K2's _ext entry on the shifted operator
    checks = [(f"sharded_level{lv}", o) for lv, o in enumerate(smg.s_ops)]
    for case, o in [*checks, ("shifted", si.shifted)]:
        rec = sharded_kernel_check(torch, dmod, dsmod, o, mesh,
                                   torch.randn(o.rows() // mesh.size, dtype=torch.float64,
                                               device="cuda"))
        emit(phase="kernel_vs_plain", case=f"multidevice_g{G_MD}_{case}", **rec)
        if not rec["ok"]:
            raise RuntimeError(f"g={G_MD}: {rec['kernel']} is not bitwise its plain "
                               f"version on {case}")
    check_levels(torch, dmod, pf, smg.bottom, f"multidevice_g{G_MD}_tail")
    exp_k1, exp_ext = expected_sharded_launches(smg, pf, cycles, solves)
    vals = e.eigenvalues()
    lam = analytic_3d_smallest(G_MD)
    captured = prefix_captured(vals, lam)
    err = float(np.abs(np.sort(vals) - lam[:20]).max()) if len(vals) == 20 else None
    rounds = e.locking_rounds()
    for r in rounds:
        r.pop("values")
    steps = sum(r["operations"] for r in rounds)
    # The inner solves' all-reduces, from the code: per solve the norms of
    # b and of the first residual and the gate's three, per V-cycle one;
    # the rest are the Lanczos driver's (and the build's one maximum).
    driver_ar = stats["all_reduce"] - (5 * solves + cycles)
    emit(phase="multidevice_g160", g=G_MD, n=n, nnz=int(A.nnz), backend=mesh.backend,
         transport=mesh.transport, ranks=mesh.size, nconv=nconv, info=e.info().name,
         certified=e.certified(), prefix_captured=captured, max_err_vs_analytic=err,
         per_round=rounds, restarts=e.num_iterations(), operations=e.num_operations(),
         v_cycles=cycles, inner_solves=solves, build_v_cycles=build_cycles,
         build_inner_solves=build_solves, sharded_levels=len(smg.s_ops),
         tail_levels=len(smg.bottom.ops), level_dims=[list(dm) for dm in smg.dims_per_level],
         k1_launches=k1, expected_k1_launches=exp_k1, k2_launches=k2,
         k2_ext_launches=k2_ext, expected_k2_ext_launches=exp_ext,
         k2_entry_launches=dict(k2_entries), build_s=build_s,
         build_parts_s=si.build_s, solve_s=solve_s, collectives=stats,
         all_reduces_per_operation=stats["all_reduce"] / max(1, steps),
         driver_all_reduces_per_operation=driver_ar / max(1, steps),
         eigenvalues=vals.tolist())
    if nconv != 20 or not e.certified() or captured != 20 or err is None or err > 1e-9:
        raise RuntimeError(f"g={G_MD}: {nconv} converged, certified {e.certified()}, "
                           f"prefix {captured}, error {err}")
    if k1 != exp_k1 or k2 != k2_ext or k2_ext != exp_ext or k2_ext == 0:
        raise RuntimeError(f"g={G_MD}: K1 {k1} (expected {exp_k1}), K2 {k2}, "
                           f"_ext {k2_ext} (expected {exp_ext})")
    return dict(ext_t=ext_t, ext_err=ext_err, launches=k2_ext, k1_launches=k1,
                shape=f"d={d}, rows_per={rp}, halo {lo}+{hi}, f32 hi/lo planes "
                      f"(g={G_MD}, one rank, ShardedStencilHiLoMatProd)")


def solve_config2(torch, stt, op, v0):
    """Config #2's solver as ``run_main_path`` builds it, on ``op``:
    returns the solver, ``nconv`` and the wall (the caller sets the
    counters to 0 before)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    e = stt.ChebSymEigsSolver(
        op, nev=10, ncv=30, which="largest", degree=DEGREE, cut_fraction=0.005,
    )
    e.set_restart_chunk(3)
    e.init(v0)
    nconv = e.compute(maxit=60)
    torch.cuda.synchronize()
    return e, nconv, time.perf_counter() - t0


def run_multidevice_cheb(torch, stt, dmod, dsmod, pf, main, rates):
    """Config #2 on the row mesh: one rank on NCCL (the process group of
    ``multidevice_g160``), ``ChebSymEigsSolver`` over
    ``sharded_stencil_op`` of the g=1000 Laplacian at full width (n =
    10^6, d = 5; working set 7 x 8 x 10^6 bytes, under 120 MiB, so the f64
    class on K1), built and run as ``run_main_path`` runs it. Held to
    ``main_path_cheb_g1000`` of this run: the same restarts, filtered
    operations and K1 launches (31 + 120 per operation + 1), values
    within 1e-12 of it and 1e-9 of the analytic list. After the counted
    run K1 is held bitwise to its plain version on the halo-extended
    vector and on the Rayleigh quotients' 10-column block, and the
    sharded product (halo copy and K1) is timed beside its K1 launch, the
    bound, the plain version, the unsharded ``DiaMatrix.matvec`` and the
    CSR call. Returns the one-rank result and the kernel-line numbers."""
    from spectra_tpu_torch.ops import cheb_step
    from spectra_tpu_torch.parallel import ShardedStencilMatProd, row_mesh, sharded_stencil_op
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia
    from spectra_tpu_torch.util.rng import SimpleRandom

    bandwidth, f64_rate, _ = rates
    mesh = row_mesh()
    if mesh.backend != "nccl" or mesh.size != 1 or mesh.staged:
        raise RuntimeError(f"config #2 sharded runs {mesh.backend} on {mesh.size} ranks")
    A = laplacian_2d(G_FULL)
    n = A.shape[0]
    op = sharded_stencil_op(host_dia(A), mesh)
    if not isinstance(op, ShardedStencilMatProd):
        raise RuntimeError(f"auto-routing chose {type(op).__name__} for config #2")
    v0 = SimpleRandom(0).random_vec(n)
    torch.cuda.synchronize()
    dmod.LAUNCHES = dsmod.LAUNCHES = cheb_step.LAUNCHES = 0
    k1_entries = count_entries(dmod)
    mesh.reset_stats()
    e, nconv, wall = solve_config2(torch, stt, op, v0)
    launches, k2, entries = dmod.LAUNCHES, dsmod.LAUNCHES, dict(k1_entries)
    cheb_launches = cheb_step.LAUNCHES
    stats = dict(mesh.stats)
    vals = np.sort(e.eigenvalues())
    ops = e.num_operations()
    expected = 31 + ops * DEGREE + 1
    err = float(np.abs(vals - analytic_2d(G_FULL)[-len(vals):]).max())
    diff = (float(np.abs(vals - np.sort(main["values"])).max())
            if len(vals) == len(main["values"]) else None)

    checks = []
    x = torch.randn(n, dtype=torch.float64, device="cuda")
    X = torch.randn((n, 10), dtype=torch.float64, device="cuda")
    for label, v in (("vector", x), ("block_10", X)):
        rec = sharded_kernel_check(torch, dmod, dsmod, op, mesh, v)
        emit(phase="kernel_vs_plain", case=f"multidevice_cheb_g1000_one_rank_{label}", **rec)
        checks.append(rec)
    timer = Timer(torch)
    offs, d = op.offsets, len(op.offsets)
    lo, hi = max(0, -min(offs)), max(0, max(offs))
    x_ext = mesh.halo(x, lo, hi)
    shifted = tuple(o + lo for o in offs)
    csr = torch_csr(torch, A, np.float64)
    dia = pf.dia_from_scipy(A)
    k1_ext = timed_entry(
        timer, lambda: dmod.dia_spmv(op.data, shifted, x_ext, x_ext.shape[0]),
        lambda: dmod.dia_spmv_plain(op.data, shifted, x_ext, x_ext.shape[0]),
        lambda: csr @ x, (d + 1) * 8 * n + 8 * (n + lo + hi), 2 * A.nnz, f64_rate,
        bandwidth, back_to_back=True,
    )
    spmv = dict(sharded=timer.stats(lambda: op.perform_op(x)),
                sharded_back_to_back_ms=timer.back_to_back(lambda: op.perform_op(x)),
                unsharded_k1=timer.stats(lambda: dia.matvec(x)))
    del csr, x_ext, x, X
    # How far the counts move with rounding: the unsharded solve from v0
    # with 8 entries moved by one ulp (three seeds). Their span holds the
    # two-rank solve's counts (check_composed).
    ulp_runs = []
    for seed in (1, 2, 3):
        v = v0.copy()
        idx = np.random.default_rng(seed).choice(n, 8, replace=False)
        v[idx] = np.nextafter(v[idx], np.inf)
        ep, nc, w = solve_config2(torch, stt, stt.SparseSymMatProd(ell=dia), v)
        ulp_runs.append(dict(nconv=nc, restarts=ep.num_iterations(),
                             operations=ep.num_operations(), wall_s=w,
                             max_diff_vs_main_path=float(np.abs(
                                 np.sort(ep.eigenvalues()) - np.sort(main["values"])).max())))
    emit(phase="multidevice_cheb_g1000", g=G_FULL, n=n, d=d, op=type(op).__name__,
         backend=mesh.backend, ranks=mesh.size, nconv=nconv, info=e.info().name,
         restarts=e.num_iterations(), filtered_operations=ops,
         main_path_restarts=main["restarts"], main_path_operations=main["operations"],
         launches=launches, main_path_launches=main["launches"], expected_spmvs=expected,
         entry_launches=entries, k2_launches=k2, cheb_step_launches=cheb_launches,
         main_path_cheb_step_launches=main["cheb_step_launches"],
         wall_s=wall, main_path_wall_s=main["wall_s"],
         max_err_vs_analytic=err, max_diff_vs_main_path=diff, collectives=stats,
         all_reduces_per_operation=stats["all_reduce"] / max(1, ops),
         k1_halo_extended=k1_ext, halo=[lo, hi], one_ulp_start_runs=ulp_runs,
         history=e.convergence_history(), **spmv)
    if nconv != 10 or err > 1e-9 or diff is None or diff > 1e-12:
        raise RuntimeError(f"config #2 sharded: {nconv} converged, error {err}, "
                           f"difference from the main path {diff}")
    if (e.num_iterations(), ops, launches) != (main["restarts"], main["operations"],
                                              main["launches"]) or launches != expected:
        raise RuntimeError(f"config #2 sharded: restarts {e.num_iterations()}, operations "
                           f"{ops}, K1 {launches}; main path {main}")
    if cheb_launches != DEGREE * ops:
        raise RuntimeError(f"config #2 sharded: the recurrence kernel launched "
                           f"{cheb_launches} times, expected {DEGREE * ops}")
    if k2 != 0 or not all(rec["ok"] for rec in checks):
        raise RuntimeError(f"config #2 sharded: K2 {k2} launches, kernel checks {checks}")
    return dict(values=vals.tolist(), restarts=e.num_iterations(), operations=ops,
                launches=launches, cheb_step_launches=cheb_launches, wall_s=wall,
                k1_ext=k1_ext, checks=len(checks),
                ulp_counts=[[r["restarts"], r["operations"]] for r in ulp_runs])


def md_composed(torch, stt, dmod, dsmod, mesh, one, rank, checks):
    """The composed solvers of the two-rank world (``--md-worker``):
    config #2 at g=1000 on two ranks (500,000 rows a rank; its one-rank
    result is ``multidevice_cheb_g1000``'s), then on two ranks and on one
    (rank 0): ``PartialSVDSolver`` and ``svds`` over ``shard_operator``
    of config #4's operator at g=100 (the ``contrib`` phase's matrix),
    mixed precision over ``shard_problem`` of ``mixed_matrix(250_000)``
    and LOBPCG on the g=100 Laplacian's sharded stencil as the
    ``contrib`` phase runs it. Each run's values, counts, K1 launches
    (the counters set to 0 just before), wall and collectives; K1 held
    bitwise to its plain version on config #2's halo-extended vector and
    10-column block at two ranks and on the f32 twin's rows, after the
    counted runs (appended to ``checks``); so also on the partial SVD's
    DIA rows (a vector and ``matrix_U``'s 5-column block) and on
    LOBPCG's 10-column block, on each mesh."""
    from spectra_tpu_torch import distributed
    from spectra_tpu_torch.parallel import (
        ShardedStencilMatProd,
        shard_operator,
        shard_problem,
        sharded_stencil_op,
    )
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia
    from spectra_tpu_torch.solvers.mixed import cast_op_f32
    from spectra_tpu_torch.util.rng import SimpleRandom

    meshes = [("two", mesh), ("one", one)]
    out = dict(config2={}, partial_svd={}, mixed={}, lobpcg={})
    k1_entries = count_entries(dmod)

    def counted():
        torch.cuda.synchronize()
        dmod.LAUNCHES = 0
        k1_entries.clear()
        return dict(mesh.stats), time.perf_counter()

    def check(case, op, m, v):
        rec = sharded_kernel_check(torch, dmod, dsmod, op, m, v)
        checks.append(dict(case=f"{case}_rank{rank}", **rec))

    A = laplacian_2d(G_FULL)
    n = A.shape[0]
    op = sharded_stencil_op(host_dia(A), mesh)
    before, _ = counted()
    e, nconv, wall = solve_config2(torch, stt, op, SimpleRandom(0).random_vec(n))
    ops = e.num_operations()
    out["config2"] = dict(
        op=type(op).__name__, nconv=nconv, info=e.info().name,
        values=np.sort(e.eigenvalues()).tolist(), restarts=e.num_iterations(),
        operations=ops, launches=dmod.LAUNCHES, expected_launches=31 + ops * DEGREE + 1,
        entry_launches=dict(k1_entries), wall_s=wall,
        collectives={k: v - before[k] for k, v in mesh.stats.items()},
        history=e.convergence_history())
    rows = n // mesh.size
    check("config2_g1000_two_rank_vector", op, mesh,
          torch.randn(rows, dtype=torch.float64, device=mesh.device))
    check("config2_g1000_two_rank_block_10", op, mesh,
          torch.randn((rows, 10), dtype=torch.float64, device=mesh.device))
    del op, e

    S = config4_matrix(100)
    for label, m in meshes:
        if m is None:
            continue
        op = shard_operator(stt.SparseGenMatProd.create(S, device=m.device), m)
        _, t0 = counted()
        p = stt.PartialSVDSolver(op, ncomp=5, ncv=20)
        nconv = p.compute()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dmod.LAUNCHES
        s = p.singular_values()
        U = distributed.gather_rows(p.matrix_U(5), m).cpu().numpy()
        V = distributed.gather_rows(p.matrix_V(5), m).cpu().numpy()
        svds_s = stt.svds(op, k=5, ncv=20)[1][::-1]
        out["partial_svd"][label] = dict(
            local=type(op.local).__name__, nconv=nconv, info=p.info().name,
            singular_values=s.tolist(), restarts=p.num_iterations(),
            operations=p.num_operations(), launches=launches, wall_s=wall,
            residual_inf=float(np.abs(S @ V - U * s[None, :]).max()) if len(s) == 5 else None,
            svds_equal_class=bool(np.array_equal(svds_s, s)))
        rows = S.shape[1] // m.size
        check(f"partial_svd_g100_{label}_vector", op, m,
              torch.randn(rows, dtype=torch.float64, device=m.device))
        check(f"partial_svd_g100_{label}_block_5", op, m,
              torch.randn((rows, 5), dtype=torch.float64, device=m.device))
        del op, p

    M = mixed_matrix(250_000)
    v0 = SimpleRandom(0).random_vec(250_000)
    for label, m in meshes:
        if m is None:
            continue
        op_s, v0_s = shard_problem(stt.SparseSymMatProd.from_full(M, device=m.device), v0, m)
        sol = stt.SymEigsSolver(op_s, nev=10, ncv=30)
        sol.set_precision("mixed")
        sol.init(v0_s)
        _, t0 = counted()
        nconv = sol.compute(stt.SortRule.LargestAlge, maxit=500, tol=1e-6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        rep = sol.mixed_report()
        out["mixed"][label] = dict(
            local=type(op_s.local).__name__, nconv=nconv, info=sol.info().name,
            values=np.sort(sol.eigenvalues()).tolist(), twin_restarts=sol.num_iterations(),
            twin_operations=sol.num_operations() - 3 * nconv,
            refine_rounds=rep["refine_rounds"], entry_launches=dict(k1_entries),
            max_resid_f64=float(np.max(rep["resid_f64"])), wall_s=wall)
        twin = cast_op_f32(op_s)
        check(f"mixed_f32_twin_{label}", twin, m,
              torch.randn(250_000 // m.size, dtype=torch.float32, device=m.device))
        del op_s, sol, twin

    g = 100
    L = laplacian_2d(g)
    X0 = np.random.default_rng(0).normal(size=(g * g, 10))
    for label, m in meshes:
        if m is None:
            continue
        op = ShardedStencilMatProd.create(host_dia(L), m)
        _, t0 = counted()
        lo = stt.LOBPCGSolver(op, X0)
        nconv = lo.compute(maxit=500, tol_div_n=1e-10)
        torch.cuda.synchronize()
        out["lobpcg"][label] = dict(
            nconv=nconv, info=lo.info().name, values=np.sort(lo.eigenvalues()).tolist(),
            iterations=lo.num_iterations(), launches=dmod.LAUNCHES,
            max_residual=float(lo.residuals().max()), wall_s=time.perf_counter() - t0)
        check(f"lobpcg_g100_{label}_block_10", op, m,
              torch.randn((g * g // m.size, 10), dtype=torch.float64, device=m.device))
        del op, lo
    return out


def md_worker(argv):
    """One rank of ``run_multidevice_2rank``'s two-process gloo world on
    the one card: ``--md-worker RANK PORT OUT``. Every product is held to
    the one-rank product (a one-rank subgroup mesh, rank 0) within 1e-13
    relative; the solves to their analytic or dense values."""
    import torch
    import scipy.sparse as sps

    import spectra_tpu_torch as stt
    from spectra_tpu_torch import distributed
    from spectra_tpu_torch.ops import dia_ds as dsmod
    from spectra_tpu_torch.ops import dia_spmv as dmod
    from spectra_tpu_torch.parallel import (
        ShardedEllMatProd,
        ShardedStencilMatProd,
        row_mesh,
        shard_problem,
        sharded_stencil_op,
        sharded_stencil_shift_solve,
    )
    from spectra_tpu_torch.parallel.mg_sharded import ShardedMGState
    from spectra_tpu_torch.parallel.stencil_spmv import host_dia
    from spectra_tpu_torch.util.rng import SimpleRandom

    rank, port, out = int(argv[0]), argv[1], argv[2]
    distributed.initialize(init_method=f"tcp://127.0.0.1:{port}", num_processes=2,
                           process_id=rank, local_device_ids=0, backend="gloo")
    t_start = time.perf_counter()
    mesh, one = row_mesh(), row_mesh(1)
    res = dict(backend=mesh.backend, transport=mesh.transport, ranks=mesh.size,
               device=str(mesh.device), products={}, solves={})
    checks = []  # each path kernel against its plain version, this rank

    for g in (G_MD, G_FULL):
        A = md_laplacian(g)
        n = A.shape[0]
        rng = np.random.default_rng(g)
        x = torch.from_numpy(rng.normal(size=n))
        X = torch.from_numpy(rng.normal(size=(n, 10)))
        dia = host_dia(A)
        full = stt.SparseSymMatProd.from_full(A, device=mesh.device)  # DIA or hi/lo
        builders = dict(
            stencil_f64=lambda m: ShardedStencilMatProd.create(dia, m),
            stencil_hilo_forced=lambda m: sharded_stencil_op(dia, m, hilo=True),
            stencil_auto=lambda m: sharded_stencil_op(dia, m),
            ell_halo=lambda m: ShardedEllMatProd.create(A, m),
            row_sharded=lambda m: shard_problem(full, x, m)[0],
        )
        for name, build in builders.items():
            row = {}
            for label, m in (("two", mesh), ("one", one)):
                if m is None:
                    continue
                xs = {"vector": m.local_rows(x).to(m.device)}
                if name != "row_sharded" or g == G_FULL:
                    xs["block_10"] = m.local_rows(X).to(m.device).contiguous()
                t0 = time.perf_counter()
                op = build(m)
                t1 = time.perf_counter()
                ys = {k: op.perform_op(v) for k, v in xs.items()}
                torch.cuda.synchronize()
                row[label] = {k: distributed.gather_rows(v, m).cpu() for k, v in ys.items()}
                row[label + "_class"] = type(op).__name__
                row[label + "_build_s"] = t1 - t0
                row[label + "_product_s"] = time.perf_counter() - t1
                for k, v in xs.items():
                    rec = sharded_kernel_check(torch, dmod, dsmod, op, m, v)
                    if rec is not None:
                        checks.append(dict(case=f"g{g}_{name}_{label}_rank{rank}_{k}", **rec))
                del op, ys, xs
            if rank == 0:
                errs = {k: float((row["two"][k] - row["one"][k]).abs().max()
                                 / row["one"][k].abs().max()) for k in row["two"]}
                res["products"][f"g{g}_{name}"] = dict(
                    rel_err_vs_one_rank=errs, two_rank_class=row["two_class"],
                    build_s=row["two_build_s"], product_s=row["two_product_s"])
        del full, dia, A
        torch.cuda.empty_cache()

    # solves at small g, to the reference tests' tolerances
    g = G_MD_SOLVE
    A = laplacian_3d(g)
    si = sharded_stencil_shift_solve(A, 0.0, mesh)
    e = stt.SymEigsShiftSolver.from_factored(si, 6, 20, 0.0)
    e.init(SimpleRandom(0).random_vec(g**3))
    t0 = time.perf_counter()
    nconv = e.compute_locked(stt.SortRule.LargestMagn, maxit=60, tol=1e-10,
                             sorting=stt.SortRule.SmallestAlge,
                             want=stt.SortRule.SmallestAlge, max_rounds=3)
    vals = e.eigenvalues()
    lam = analytic_3d_smallest(g)
    res["solves"][f"shift_invert_locked_3d_g{g}"] = dict(
        nconv=nconv, certified=e.certified(), method=si.method,
        restarts=e.num_iterations(), operations=e.num_operations(),
        max_err_vs_analytic=float(np.abs(np.sort(vals) - lam[: len(vals)]).max()),
        wall_s=time.perf_counter() - t0,
        ok=bool(nconv == 6 and e.certified()
                and np.abs(np.sort(vals) - lam[:6]).max() < 1e-9))
    if isinstance(si.mg, ShardedMGState):
        for lv, o in enumerate(si.mg.s_ops):
            v = torch.randn(o.rows() // mesh.size, dtype=torch.float64, device=mesh.device)
            rec = sharded_kernel_check(torch, dmod, dsmod, o, mesh, v)
            checks.append(dict(case=f"shift_invert_g{g}_sharded_level{lv}_rank{rank}", **rec))
    rs = np.random.RandomState(3)
    B = sps.random(128, 128, density=0.08, random_state=rs, format="csr")
    B = (B + B.T).tocsr()
    t0 = time.perf_counter()
    e = stt.SymEigsSolver(ShardedEllMatProd.create(B, mesh), 4, 16)
    e.init(SimpleRandom(0).random_vec(128))
    nconv = e.compute(stt.SortRule.LargestMagn)
    want = np.linalg.eigvalsh(B.toarray())
    want = want[np.argsort(-np.abs(want))][:4]
    res["solves"]["ell_irlm_n128"] = dict(
        nconv=nconv, info=e.info().name, restarts=e.num_iterations(),
        operations=e.num_operations(), wall_s=time.perf_counter() - t0,
        max_err_vs_eigvalsh=float(np.abs(np.sort(e.eigenvalues()) - np.sort(want)).max()),
        ok=bool(nconv == 4
                and np.abs(np.sort(e.eigenvalues()) - np.sort(want)).max() < 1e-10))
    nd = 256
    D = (laplacian_2d(16) + sps.diags(np.arange(nd) * 0.05)).tocsr()
    t0 = time.perf_counter()
    dav = stt.DavidsonSymEigsSolver(ShardedEllMatProd.create(D, mesh), 3, 12)
    nconv = dav.compute(stt.SortRule.LargestAlge, maxit=100, tol=1e-9)
    want = np.sort(np.linalg.eigvalsh(D.toarray()))[-3:]
    err = float(np.abs(np.sort(dav.eigenvalues()) - want).max())
    res["solves"]["davidson_g16"] = dict(
        nconv=nconv, iterations=dav.num_iterations(), operations=dav.num_operations(),
        max_err_vs_eigvalsh=err, wall_s=time.perf_counter() - t0,
        ok=bool(nconv == 3 and err < 1e-7))
    res["wall_s"] = time.perf_counter() - t_start
    res["collectives"] = dict(mesh.stats)
    res["collective_share_of_wall"] = mesh.stats["seconds"] / res["wall_s"]
    res["exchange_share_of_wall"] = mesh.stats["exchange_s"] / res["wall_s"]
    res["exchange_us"] = mesh.stats["exchange_s"] / max(1, mesh.stats["exchange"]) * 1e6
    t0 = time.perf_counter()
    res["composed"] = md_composed(torch, stt, dmod, dsmod, mesh, one, rank, checks)
    res["composed_wall_s"] = time.perf_counter() - t0
    import torch.distributed as dist

    every = [None] * mesh.size
    dist.all_gather_object(every, checks)
    res["kernel_checks"] = [c for part in every for c in part]
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def check_composed(comp, cheb_one):
    """The composed solvers of the two-rank world against one rank:
    config #2 against ``multidevice_cheb_g1000`` (values within 1e-12
    relative and 1e-9 of the analytic list, K1 launches 31 + 120 per
    filtered operation + 1; its restarts and filtered operations, which
    rounding decides, must lie within the span of one rank's and of the
    one-rank solves from one-ulp moves of the start, measured in the
    same run, and whether they equal one rank's is reported), the
    partial SVD (singular values within 1e-12 relative, counts equal, K1
    launches equal to the products, ``svds`` equal to the class,
    residual under the ``contrib`` phase's 1e-7), mixed precision
    (values within 1e-9 max|lambda|, the mode's contract; K1 f32
    launches equal to the twin's operations and f64 block launches to
    two a round, on each mesh), and LOBPCG (10/10 within the ``contrib``
    phase's 1e-6 of the analytic values on each mesh, K1 launches equal
    to the iterations on each mesh, and the two meshes' values within
    1e-9 max|lambda| of each other: the readings were 1.5e-10, and the
    iteration count, which moves with the sums' order at LOBPCG's
    residual floor, is reported beside one rank's). Returns the record
    and the names of the failed cases."""

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return float(np.abs(a - b).max() / np.abs(b).max()) if a.shape == b.shape else None

    bad = []
    c2 = comp["config2"]
    rec = dict(config2=dict(
        rel_err_vs_one_rank=rel(c2["values"], cheb_one["values"]),
        max_err_vs_analytic=float(np.abs(np.asarray(c2["values"])
                                         - analytic_2d(G_FULL)[-10:]).max())
        if len(c2["values"]) == 10 else None,
        counts_two=[c2["restarts"], c2["operations"], c2["launches"]],
        counts_one=[cheb_one["restarts"], cheb_one["operations"], cheb_one["launches"]],
        one_ulp_start_counts=cheb_one["ulp_counts"], history_two=c2["history"],
        wall_two_s=c2["wall_s"], wall_one_s=cheb_one["wall_s"], op=c2["op"],
        collectives=c2["collectives"],
        exchange_us=c2["collectives"]["exchange_s"] / max(1, c2["collectives"]["exchange"])
        * 1e6, all_reduces_per_operation=c2["collectives"]["all_reduce"]
        / max(1, c2["operations"])))
    r = rec["config2"]
    r["counts_equal"] = r["counts_two"] == r["counts_one"]
    span = np.array([r["counts_one"][:2]] + cheb_one["ulp_counts"])
    r["count_span"] = [span.min(axis=0).tolist(), span.max(axis=0).tolist()]
    inside = bool(np.all((span.min(axis=0) <= r["counts_two"][:2])
                         & (r["counts_two"][:2] <= span.max(axis=0))))
    if (c2["nconv"] != 10 or r["rel_err_vs_one_rank"] is None
            or r["rel_err_vs_one_rank"] > 1e-12 or r["max_err_vs_analytic"] > 1e-9
            or c2["launches"] != c2["expected_launches"] or not inside):
        bad.append("config2")
    two, one = comp["partial_svd"]["two"], comp["partial_svd"]["one"]
    rec["partial_svd"] = dict(
        rel_err_vs_one_rank=rel(two["singular_values"], one["singular_values"]),
        counts_two=[two["restarts"], two["operations"], two["launches"]],
        counts_one=[one["restarts"], one["operations"], one["launches"]],
        residual_inf=[two["residual_inf"], one["residual_inf"]],
        wall_s=[two["wall_s"], one["wall_s"]], local=two["local"])
    r = rec["partial_svd"]
    if (two["nconv"] != 5 or one["nconv"] != 5 or r["rel_err_vs_one_rank"] > 1e-12
            or r["counts_two"] != r["counts_one"]
            or any(x["launches"] != x["operations"] for x in (two, one))
            or not (two["svds_equal_class"] and one["svds_equal_class"])
            or max(r["residual_inf"]) > 1e-7):
        bad.append("partial_svd")
    two, one = comp["mixed"]["two"], comp["mixed"]["one"]
    scale = float(np.abs(one["values"]).max()) if one["values"] else 1.0
    diff = (float(np.abs(np.asarray(two["values"]) - np.asarray(one["values"])).max())
            if len(two["values"]) == len(one["values"]) else None)
    rec["mixed"] = dict(
        max_diff_vs_one_rank=diff, max_abs_eigenvalue=scale,
        counts_two=[two["twin_restarts"], two["twin_operations"], two["refine_rounds"]],
        counts_one=[one["twin_restarts"], one["twin_operations"], one["refine_rounds"]],
        entry_launches=[two["entry_launches"], one["entry_launches"]],
        max_resid_f64=[two["max_resid_f64"], one["max_resid_f64"]],
        wall_s=[two["wall_s"], one["wall_s"]], local=two["local"])
    rec["mixed"]["counts_equal"] = rec["mixed"]["counts_two"] == rec["mixed"]["counts_one"]
    if (two["nconv"] != 10 or one["nconv"] != 10 or diff is None or diff > 1e-9 * scale
            or any(x["entry_launches"] != {"f32": x["twin_operations"],
                                           "f64_block": 2 * x["refine_rounds"]}
                   for x in (two, one))):
        bad.append("mixed")
    two, one = comp["lobpcg"]["two"], comp["lobpcg"]["one"]
    lam = analytic_2d(100)[:10]
    errs = [float(np.abs(np.asarray(x["values"]) - lam).max()) if len(x["values"]) == 10
            else None for x in (two, one)]
    rec["lobpcg"] = dict(
        max_err_vs_analytic=errs,
        max_diff_vs_one_rank=float(np.abs(np.asarray(two["values"])
                                          - np.asarray(one["values"])).max())
        if None not in errs else None, max_abs_eigenvalue=float(lam.max()),
        iterations=[two["iterations"], one["iterations"]],
        launches=[two["launches"], one["launches"]],
        max_residual=[two["max_residual"], one["max_residual"]],
        wall_s=[two["wall_s"], one["wall_s"]])
    if (None in errs or max(errs) > 1e-6
            or rec["lobpcg"]["max_diff_vs_one_rank"] > 1e-9 * float(lam.max())
            or any(x["nconv"] != 10 or x["info"] != "Successful"
                   or x["launches"] != x["iterations"] for x in (two, one))):
        bad.append("lobpcg")
    return rec, bad


def run_multidevice_2rank(torch, cheb_one):
    """Two processes on the one card, spawned here, each a rank of a
    gloo world (``backend="gloo"`` passed explicitly: NCCL refuses two
    ranks on one device). They move CUDA tensors through real halo
    exchanges, staged through pinned host buffers (gloo's transport).
    Products on g=160 and on config #3's 2-D g=1000 matrix (stencil f64,
    vector and 10-column block; hi/lo forced and auto; ELL halo, vector
    and block; ``RowShardedMatProd``) against the one-rank product; a
    shift-invert ``compute_locked`` at 3-D g=32, a ``ShardedEllMatProd``
    IRLM and a Davidson solve. Prints the wall and the share of it the
    ranks spent in collectives."""
    from spectra_tpu_torch.parallel.mesh import _free_port

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = os.path.join(CHECKPOINT_DIR, "multidevice_2rank.json")
    os.makedirs(CHECKPOINT_DIR, exist_ok=True)
    port = str(_free_port())
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([sys.executable, os.path.abspath(__file__), "--md-worker",
                          str(r), port, out], stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(2)
    ]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("a rank of the two-rank world failed:\n"
                           + "\n".join(log[-3000:] for log in logs))
    with open(out) as f:
        res = json.load(f)
    composed, composed_wall = res.pop("composed"), res.pop("composed_wall_s")
    checks = res.pop("kernel_checks")
    for rec in checks:
        emit(phase="kernel_vs_plain", **{k: v for k, v in rec.items() if k != "case"},
             case=f"multidevice_2rank_{rec['case']}")
    bad = [rec["case"] for rec in checks if not rec["ok"]]
    if bad or not checks:
        raise RuntimeError(f"two-rank path kernels not bitwise their plain versions: {bad}")
    worst = max(v for p in res["products"].values() for v in p["rel_err_vs_one_rank"].values())
    emit(phase="multidevice_2rank", phase_wall_s=wall, worst_rel_err_vs_one_rank=worst, **res)
    if worst > 1e-13 or not all(s["ok"] for s in res["solves"].values()):
        raise RuntimeError("the two-rank products or solves failed their checks")
    if res["backend"] != "gloo" or res["ranks"] != 2:
        raise RuntimeError(f"the two-rank world ran {res['backend']} on {res['ranks']} ranks")
    rec, bad = check_composed(composed, cheb_one)
    emit(phase="multidevice_2rank_composed", wall_s=composed_wall, **rec)
    if bad:
        raise RuntimeError(f"two-rank composed solvers failed their checks: {bad}")
    return dict(res, composed=composed)


#: The TSQR kernel's checks: (n, c, dtype, kind), Gaussian blocks unless
#: ``kind`` says otherwise; the first two are also timed.
TSQR_CASES = (
    (1_000_000, 10, "float64", "gauss"),
    (1_000_000, 20, "float64", "gauss"),
    (999_983, 7, "float64", "gauss"),
    (5000, 1, "float64", "gauss"),
    (100_000, 32, "float64", "gauss"),
    (5000, 10, "float32", "gauss"),
    (200_000, 10, "float64", "cond_1e12"),
    (200_000, 10, "float64", "zero_column"),
)


def phase_tsqr(torch, rates):
    """The TSQR kernel (``ops/tsqr.py``) against its plain version,
    ``torch.linalg.qr`` with the sign fix, at ``TSQR_CASES``:
    orthonormality, A = QR, R upper triangular with a non-negative
    diagonal, and on Gaussian blocks Q's distance from the library's
    (f64 limits 1e-13, 1e-14 and 1e-12; f32 1e-5), ``kernel_vs_plain``
    records; then timed cold at (10^6, 10) and (10^6, 20) f64 beside its
    bound (A read and Q written once) and ``torch.linalg.qr``. Returns
    the timings, the largest distance from the plain Q and the launches."""
    from spectra_tpu_torch.ops import tsqr

    bandwidth, f64_rate, _ = rates
    worst, out = 0.0, {}
    before = tsqr.LAUNCHES
    for n, c, dtype_name, kind in TSQR_CASES:
        dtype = getattr(torch, dtype_name)
        g = torch.Generator(device="cuda").manual_seed(n + c)
        A = torch.randn((n, c), dtype=dtype, device="cuda", generator=g)
        if kind == "cond_1e12":
            U, _ = torch.linalg.qr(A)
            V, _ = torch.linalg.qr(torch.randn((c, c), dtype=dtype, device="cuda", generator=g))
            A = ((U * torch.logspace(0, -12, c, dtype=dtype, device="cuda")[None, :]) @ V.mT)
            A = A.contiguous()
        elif kind == "zero_column":
            A[:, c // 2] = 0
        Q, R = tsqr.tsqr(A)
        torch.cuda.synchronize()
        eye = torch.eye(c, dtype=dtype, device="cuda")
        rec = dict(
            orthogonality=float((Q.mT @ Q - eye).abs().max()),
            residual=float(torch.linalg.norm(A - Q @ R) / torch.linalg.norm(A)),
            upper=bool(torch.equal(R, torch.triu(R))),
            diagonal_nonneg=bool((torch.diagonal(R) >= 0).all()),
        )
        f64 = dtype == torch.float64
        ok = (rec["orthogonality"] <= (1e-13 if f64 else 1e-5)
              and rec["residual"] <= (1e-14 if f64 else 1e-5)
              and rec["upper"] and rec["diagonal_nonneg"])
        if kind == "gauss":
            rec["max_abs_err"] = float((Q - tsqr.tsqr_plain(A)[0]).abs().max())
            ok = ok and rec["max_abs_err"] <= (1e-12 if f64 else 1e-5)
            worst = max(worst, rec["max_abs_err"])
        emit(phase="kernel_vs_plain", kernel="tsqr", case=f"{n}x{c}_{dtype_name}_{kind}",
             ok=ok, **rec)
        if not ok:
            raise RuntimeError(f"the TSQR kernel at ({n}, {c}) {dtype_name} {kind}: {rec}")
    launches = tsqr.LAUNCHES - before
    timer = Timer(torch)
    for n, c, _, _ in TSQR_CASES[:2]:
        A = torch.randn((n, c), dtype=torch.float64, device="cuda")
        t = timed_entry(timer, lambda: tsqr.tsqr(A), lambda: tsqr.tsqr_plain(A),
                        lambda: torch.linalg.qr(A), 2 * n * c * 8, 4 * n * c * c,
                        f64_rate, bandwidth)
        t.update(kernel="tsqr", n=n, c=c, dtype="float64", us=t["ms"] * 1e3,
                 bound_us=t["bound_ms"] * 1e3, library_us=t["library_ms"] * 1e3,
                 enqueue_us=enqueue_us(torch, lambda: tsqr.tsqr(A)))
        emit(phase="kernel_timing", **t)
        out[f"{n}x{c}"] = t
    return out, worst, launches


#: n of the recurrence kernel's bitwise checks: config #2's, and one
#: odd, so that the kernel's tail runs.
CHEB_STEP_NS = (1_000_000, 1_000_003)


def same_bits(torch, a):
    """``a``'s bits as integers (a complex tensor's real view)."""
    a = torch.view_as_real(a) if a.is_complex() else a
    return a.contiguous().view(torch.int64 if a.element_size() == 8 else torch.int32)


def phase_cheb_step(torch, rates):
    """The Chebyshev recurrence kernel (``ops/cheb_step.py``) bitwise
    against its plain version at ``CHEB_STEP_NS``, f64, f32, c128 and c64
    (complex as the real view), a vector and a 3-column block, the first step, a later one and one written
    over ``t_prev`` (``kernel_vs_plain`` records), with config #2's
    scalars; then at (10^6,) f64, a later step in place as the filter
    makes it, timed cold beside its bound (y, t and t_prev read and the
    result written once, 32 bytes an element) and the plain sequence,
    and each one's enqueue time. Returns the timing, the largest
    distance from the plain result (0: bitwise) and the launches."""
    from spectra_tpu_torch.ops import cheb_step as cs

    bandwidth, f64_rate, _ = rates
    c, h = 0.5 * (7.96 + -0.4), 0.5 * (7.96 - -0.4)  # config #2's interval
    before, worst = cs.LAUNCHES, 0.0
    for n in CHEB_STEP_NS:
        for dtype in (torch.float64, torch.float32, torch.complex128, torch.complex64):
            for shape in ((n,), (n, 3)):
                g = torch.Generator(device="cuda").manual_seed(n + len(shape))
                y, t, t_prev = (torch.randn(shape, dtype=dtype, device="cuda", generator=g)
                                for _ in range(3))
                for kind in ("first", "later", "in_place"):
                    prev = None if kind == "first" else t_prev.clone()
                    want = cs.cheb_step_plain(y, t, prev, c, h)
                    got = cs.cheb_step(y, t, prev, c, h, overwrite=kind == "in_place")
                    torch.cuda.synchronize()
                    err = float((got - want).abs().max())
                    ok = bool(torch.equal(same_bits(torch, got), same_bits(torch, want)))
                    worst = max(worst, err)
                    emit(phase="kernel_vs_plain", kernel="cheb_step",
                         case=f"{'x'.join(map(str, shape))}_{str(dtype)[6:]}_{kind}",
                         ok=ok, max_abs_err=err)
                    if not ok:
                        raise RuntimeError(f"the recurrence kernel at {shape} {dtype} "
                                           f"{kind} is not bitwise its plain version")
    launches = cs.LAUNCHES - before
    n = 1_000_000
    y, t, t_prev = (torch.randn(n, dtype=torch.float64, device="cuda") for _ in range(3))
    timer = Timer(torch)
    t_ = timed_entry(timer, lambda: cs.cheb_step(y, t, t_prev, c, h, overwrite=True),
                     lambda: cs.cheb_step_plain(y, t, t_prev, c, h), None,
                     4 * n * 8, 5 * n, f64_rate, bandwidth, back_to_back=True)
    t_.update(kernel="cheb_step", n=n, dtype="float64", us=t_["ms"] * 1e3,
              bound_us=t_["bound_ms"] * 1e3, plain_us=t_["plain_ms"] * 1e3,
              back_to_back_us=t_["back_to_back_ms"] * 1e3,
              enqueue_us=enqueue_us(
                  torch, lambda: cs.cheb_step(y, t, t_prev, c, h, overwrite=True)),
              plain_enqueue_us=enqueue_us(
                  torch, lambda: cs.cheb_step_plain(y, t, t_prev, c, h)))
    emit(phase="kernel_timing", **t_)
    return t_, worst, launches


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


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    parent = None
    if argv[:1] == ["--md-worker"] and len(argv) == 4:
        return md_worker(argv[1:])
    if argv[:1] == ["--k1-parent"] and len(argv) == 2:
        parent = argv[1]
    elif argv:
        print("usage: python3 chip_smoke.py [--k1-parent CHECKOUT]", file=sys.stderr)
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
    if parent is not None:
        phase("k1_parent_vs_change", compare_parent, torch, dmod, vmod, pf, rates, parent)
        emit(phase_walls=walls, total_s=sum(walls.values()))
        return 0
    stream_t = phase("stream_probe", phase_stream, torch, smod, rates[0])
    worst_k1 = phase("k1_vs_plain", check_kernel, torch, dmod, vmod, pf)
    k1_levels, k1_floor = phase("k1_levels", phase_k1_levels, torch, dmod, pf, rates)

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
    var_t, var_errs, var_launches = phase(
        "dia_variants", phase_dia_variants, torch, vmod, dmod, pf, rates
    )
    p5_t, p5_err, p5_launches = phase(
        "f32_ceiling", phase_f32_ceiling, torch, vmod, dmod, pf, A243, rates, ds_t
    )
    phase("irlm_g100", run_irlm, torch, stt, dmod)
    launches, op, v0, main = phase("config2_main_path", run_main_path, torch, stt, dmod)
    phase("config2_profile", profile_start, torch, stt, op, v0)
    del op, v0
    k1_config3, k1_config3_full = phase(
        "config3", run_config3, torch, stt, dmod, dsmod, pmg, pf
    )
    phase("config1_dense", run_config1, torch, stt)
    phase("dense_shift_invert", run_dense_shift_invert, torch, stt)
    phase("generalized_modes", run_generalized_modes, torch, stt)
    op5a, k1_config5a = phase(
        "config5a_generalized_1m", run_config5a, torch, stt, dmod, dsmod, pmg, pf
    )
    phase("config5a_profile", profile_inner_solves, torch, op5a,
          "profile_config5a_inner_solves")
    del op5a
    op4, v04, k1_config4, k1_config4_t = phase(
        "config4_gen_sparse_g500", run_config4, torch, stt, dmod, pf, rates, k1_floor
    )
    phase("config4_profile", profile_config4, torch, stt, op4, v04)
    del op4
    phase("gen_dense_n1000", run_gen_dense, torch, stt)
    phase("gen_shift_modes", run_gen_shift_modes, torch, stt, dmod)
    phase("hermitian", run_hermitian, torch, stt)
    op5b, k1_config5b, tsqr_config5b = phase(
        "config5b_davidson", run_config5b, torch, stt, dmod, pf
    )
    phase("config5b_profile", profile_config5b, torch, stt, op5b)
    del op5b
    phase("contrib", run_contrib, torch, stt, dmod)
    k1_blocks = phase("k1_block_timing", phase_k1_blocks, torch, dmod, pf, rates, k1_floor)
    tsqr_t, tsqr_err, tsqr_launches = phase("tsqr", phase_tsqr, torch, rates)
    cheb_t, cheb_err, cheb_launches = phase("cheb_step", phase_cheb_step, torch, rates)
    k1_frontends = phase("frontends", run_frontends, torch, stt, dmod, pmg, pf)
    k1_mixed = phase("mixed_precision", run_mixed_precision, torch, stt, dmod, pf)
    k1_nonfinite = phase("nonfinite", run_nonfinite, torch, stt, dmod, pf)
    ns_op, k1_ns, k2_ns, ns_cycles, ns_solves = phase(
        "north_star", run_north_star, torch, stt, dmod, dsmod, pmg, pf, A243,
        dia243, matrix_s,
    )
    del dia243
    level_t = phase(
        "north_star_levels", phase_north_star_levels, torch, dsmod, dmod, pf,
        ns_op.mg, (k1_ns, k2_ns, ns_cycles, ns_solves), rates,
    )
    phase("north_star_profile", profile_inner_solves, torch, ns_op,
          "profile_north_star_inner_solves")
    del ns_op
    torch.cuda.empty_cache()
    md = phase("multidevice_g160", run_multidevice_g160, torch, stt, dmod, dsmod, pmg,
               pf, rates)
    cheb_md = phase("multidevice_cheb_g1000", run_multidevice_cheb, torch, stt, dmod, dsmod,
                    pf, main, rates)
    md2 = phase("multidevice_2rank", run_multidevice_2rank, torch, cheb_md)
    emit(phase="multidevice_walls", g160_s=walls["multidevice_g160"],
         cheb_g1000_s=walls["multidevice_cheb_g1000"], two_rank_s=walls["multidevice_2rank"],
         total_s=walls["multidevice_g160"] + walls["multidevice_cheb_g1000"]
         + walls["multidevice_2rank"])
    for t in k1_levels:  # launches per north-star run, from its levels
        ns = next((r for r in level_t if r["n"] == t["n"] and r["d"] == t["d"]), None)
        if ns is None:
            raise RuntimeError(f"the north star has no K1 level of n={t['n']}, d={t['d']}")
        t.update(launches=ns["launches"], card_s_per_run=ns["launches"] * t["ms"] * 1e-3)
        emit(phase="k1_levels_launches", level=t["level"], n=t["n"],
             launches=t["launches"], card_s_per_run=t["card_s_per_run"])

    f64 = timing["float64"]
    c_mode = ds_t["g243"]["C_hilo_matvec_f64_entry"]
    emit(kernels=[
        kernel_entry(
            "dia_spmv", launches, worst_k1, f64,
            f"d={f64['d']}, n={f64['n']}, float64 (config #2)",
            max_err=worst_k1, float32=timing["float32"],
            launches_config2=launches, launches_config3=k1_config3,
            launches_config3_full_reorth=k1_config3_full,
            launches_config5a=k1_config5a,
            launches_config4=k1_config4, config4=k1_config4_t,
            launches_config5b=k1_config5b[1_000_000],
            launches_config5b_by_n={str(k): v for k, v in k1_config5b.items()},
            block_timings=k1_blocks,
            launches_frontends=k1_frontends,
            launches_mixed_by_n={str(k): v for k, v in k1_mixed.items()},
            launches_nonfinite=k1_nonfinite,
            launches_north_star=k1_ns, launches_multidevice_g160=md["k1_launches"],
            launches_multidevice_cheb_g1000=cheb_md["launches"],
            multidevice_cheb_g1000=cheb_md["k1_ext"],
            launches_multidevice_2rank_rank0={
                "config2": md2["composed"]["config2"]["launches"],
                "partial_svd": {k: v["launches"]
                                for k, v in md2["composed"]["partial_svd"].items()},
                "mixed": {k: v["entry_launches"] for k, v in md2["composed"]["mixed"].items()},
                "lobpcg": {k: v["launches"] for k, v in md2["composed"]["lobpcg"].items()}},
            north_star_levels=[t for t in level_t if t["kernel"] == "dia_spmv"],
            k1_levels=k1_levels, launch_floor=k1_floor,
            mode_a_g243=ds_t["g243"]["A_k1_f64"],
        ),
        kernel_entry(
            "dia_spmv_ds", k2_ns, worst_k2, c_mode,
            f"d=7, n={G_NORTH ** 3}, f32 hi/lo planes, f64 x and y "
            "(north-star operator, DiaHiLoMatrix.matvec)",
            modes=ds_t, launches_north_star=k2_ns, launches_config3=0,
            north_star_levels=[t for t in level_t if t["kernel"] == "dia_spmv_ds"],
        ),
        kernel_entry(
            "dia_spmv_ds_ext", md["launches"], md["ext_err"], md["ext_t"], md["shape"],
            launches_path="multidevice_g160: the sharded shift-invert solve "
                          "(ShardedStencilHiLoMatProd.perform_op)",
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
            k1_f32_ms=var_t["k1_f32_g1000"]["ms"],
            launches_path="the dia_variants phase (a probe, on no solver path)",
        ),
        kernel_entry(
            "dia_roll2d", var_launches["dia_roll2d"],
            max(v for k, v in var_errs.items() if k.startswith("dia_roll2d")),
            var_t["dia_roll2d_g1000_r32"],
            "d=5, n=10^6, float32, rows=32 (g=1000 2-D Laplacian); every rows "
            f"of {list(ROLL2D_ROWS)} and the 61^3 27-point f32 planes in the sweeps",
            rows_sweep={
                shape: {r: {k: var_t[f"dia_roll2d_{shape}_r{r}"][k]
                            for k in ("ms", "min_ms", "max_ms", "bound_ms",
                                      "library_ms", "plain_ms", "ctas", "plan")}
                        for r in ROLL2D_ROWS}
                for shape in ("g1000", f"g{K1_LEVELS[0][1]}")
            },
            k1_f32={shape: var_t[f"k1_f32_{shape}"]
                    for shape in ("g1000", f"g{K1_LEVELS[0][1]}")},
            launches_path="the dia_variants phase (a probe, on no solver path)",
        ),
        kernel_entry(
            "dia_spmv_f32", p5_launches, p5_err, p5_t,
            f"d=7, n={G_NORTH ** 3}, float32 (g=243 planes)",
            k2_mode_b_ms=p5_t["k2_mode_b_ms"],
            launches_path="the f32_ceiling phase (K1's f32 kernel as the probe)",
        ),
        kernel_entry(
            "tsqr", tsqr_config5b, tsqr_err, tsqr_t["1000000x10"],
            "n=10^6, c=10, float64 (config #5b's correction blocks)",
            c20=tsqr_t["1000000x20"], launches_check=tsqr_launches,
            launches_path="config5b_davidson at n=10^6: two a Davidson iteration that "
                          "extends the space; launches_check: the tsqr phase's checks",
        ),
        kernel_entry(
            "cheb_step", main["cheb_step_launches"], cheb_err, cheb_t,
            "n=10^6, float64, a later step in place (config #2's filter)",
            back_to_back_us=cheb_t["back_to_back_us"], enqueue_us=cheb_t["enqueue_us"],
            plain_enqueue_us=cheb_t["plain_enqueue_us"], launches_check=cheb_launches,
            launches_multidevice_cheb_g1000=cheb_md["cheb_step_launches"],
            launches_path="config2_main_path: one a degree step of each filtered "
                          "operation (so multidevice_cheb_g1000 on the row mesh); "
                          "launches_check: the cheb_step phase's checks",
        ),
    ])
    emit(phase_walls=walls, total_s=sum(walls.values()))
    import torch.distributed as tdist

    tdist.destroy_process_group()
    emit(ok=True, device=dict(
        platform="gpu", kind=name, count=torch.cuda.device_count()
    ))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
