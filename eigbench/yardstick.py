"""The benchmark's fixed arithmetic: peaks by card, K1's bytes and
operations.

Copied from ``chip_smoke.py`` (``CARDS``, ``card_rates``, the K1 byte
count of ``time_kernel``) and kept here, under
the benchmark's own files, so that a change to the program cannot move
the yardstick it is measured with.
"""

#: Peak rates of the cards (NVIDIA data sheets): device memory bytes/s,
#: and FP64 / FP32 non-tensor-core FLOP/s. An H100 SXM is "H100".
CARDS = {
    "H100 PCIe": (2.0e12, 25.6e12, 51.2e12),
    "H100 NVL": (3.9e12, 30.0e12, 60.0e12),
    "H100": (3.35e12, 33.5e12, 66.9e12),
    "H200": (4.8e12, 33.5e12, 66.9e12),
}

#: Substrings of K1's CUDA kernels (``csrc/dia_rows.cuh``: one vector;
#: ``csrc/dia_block.cuh``: a block of columns) in a profiler trace.
K1_KERNELS = ("dia_rows_kernel", "dia_block_kernel")


def card_rates(name: str):
    """(bytes/s, f64 FLOP/s, f32 FLOP/s) of the card called ``name``."""
    for key in ("H100 PCIe", "H100 NVL", "H100", "H200"):
        if key in name:
            return CARDS[key]
    raise KeyError(f"no peak rates known for {name!r}")


def is_k1(kernel_name: str) -> bool:
    return any(k in kernel_name for k in K1_KERNELS)


def k1_bytes(d: int, n_rows: int, n_cols: int, ncol: int, item: int) -> int:
    """Bytes one K1 launch must move: the d diagonals of data (d x
    n_rows), the d int64 offsets, x (n_cols x ncol) and y (n_rows x
    ncol), each once."""
    return item * (d * n_rows + n_cols * ncol + n_rows * ncol) + 8 * d


def k1_flops(d: int, n_rows: int, ncol: int) -> int:
    """A multiply and an add for each stored entry and column."""
    return 2 * d * n_rows * ncol


def k1_bound_s(d, n_rows, n_cols, ncol, item, rates) -> float:
    """The least time one launch can take on a card of ``rates``: the
    larger of its bytes over the bandwidth and its operations over the
    peak of its precision."""
    bandwidth, f64_rate, f32_rate = rates
    rate = f64_rate if item == 8 else f32_rate
    return max(k1_bytes(d, n_rows, n_cols, ncol, item) / bandwidth,
               k1_flops(d, n_rows, ncol) / rate)

