// DIA (diagonal-storage) sparse matrix-vector product for Hopper (sm_90a).
//
// Replaces spectra_tpu/ops/dia_pallas.py::dia_spmv_pallas, the TPU
// kernel behind DiaMatrix.matvec. It computes, for row-aligned DIA
// storage data[k, i] = A[i, i + off_k],
//
//     y[i] = sum_k data[k, i] * x[i + off_k],   0 <= i < n_rows,
//
// where x counts as zero outside [0, n_cols), summed in offset order
// from +0, as the plain PyTorch version computes it on its zero-padded
// x. One vector runs dia_rows.cuh, shared with the cost probe P3
// (dia_variants.cu); a block of columns X (n_cols, ncol), the matmat,
// runs dia_block.cuh (the block path, last paragraphs below).
//
// What bounds it: memory. Each output row does d multiply-adds against
// d + 2 values moved, so for d diagonals and n rows the function must
// move (d + 2) * n * sizeof(T) bytes (data once, x once, y once): 56 MB
// in f64 for the 5-point Laplacian at n = 10^6, 16.7 us at an H100
// SXM's 3.35 TB/s; 52.7 MB (15.7 us) at the north star's 61^3
// multigrid level (d = 27). At its 31^3 and 16^3 levels (6.9 and
// 0.95 MB) the bytes take 2.1 and 0.3 us, under one launch: there what
// bounds it is the latency of one trip to memory per row.
//
// What held the first version back: one thread per row walked the
// diagonals in a loop whose trip count was known only at run time, with
// a branch around each term, so each diagonal's two loads waited on the
// previous add: 27 dependent trips to memory per row at d = 27. And its
// 256-thread blocks gave the 4,096 rows of the 16^3 level 16 blocks, on
// 16 of the card's 132 SMs.
//
// What the design does about it (dia_rows.cuh): every term is added,
// with x zero outside [0, n_cols), so a row's loads depend on nothing but
// its index. Each thread issues all loads of its row (groups of eight
// for a count that is not unrolled; d = 5 for config #2, 9 on config
// #3's 2-D multigrid levels, 7 on the 3-D operator and 27 on the north
// star's levels 2-4 are) before the arithmetic. ptxas interleaves plain
// loads with the adds (32 registers at d = 27: a row still waits on a
// few trips in turn), so a small matrix stages its loads through
// shared memory with cp.async instead: all 54 values of a 27-diagonal
// row in flight at once. The wrapper chooses (ops/dia_spmv.py::
// launch_config): staged below 2^17 rows, registers above, where the
// warps of other rows hide the latency and staging costs time; and the
// largest block that still gives every SM two blocks, so the 4,096
// rows of the 16^3 level run on 128 SMs. One row a thread: two were no
// faster at 1M-14.3M rows. Offsets travel by value (at most 64). No
// shared-memory x window (the probe P4 showed one slower) and no TMA.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; chip_smoke.py
// --k1-parent, the first version and this one in turns in one run; cold
// medians, L2 flushed with clean lines): 16^3 17.0 -> 7.5 us (the CSR
// call 18.2, the launch floor 5.9); 31^3 17.9 -> 9.5; config #2 f64
// 24.0 -> 22.1, f32 18.0 -> 14.0; the g=243 operator 367.0 -> 345.5
// (bound 308.4). At 61^3 staging took 25.5 against 24.9 for the first
// version and 24.9 for this one in registers (bound 15.7, the floor
// alone 5.9): there the rows hide the latency either way.
//
// The block path. What bounds it: memory, (d * n_rows + n_cols * ncol
// + n_rows * ncol) * sizeof(T) bytes (data, X and Y once each): 360 MB
// in f64 for config #5b's d = 5 at n = 10^6 on 20 columns, 107.5 us at
// 3.35 TB/s. What held the first version back: one thread per (row,
// column) with the column on gridDim.y, so a warp's X loads and Y
// stores strode by ncol * 8 bytes (one 32-byte sector per value) and
// every diagonal's data was read ncol times, from separate grid planes.
// What the design does (dia_block.cuh): X and Y are flat row-major
// arrays, so each diagonal's X loads and the Y stores are contiguous
// 16-byte packs; a CTA takes a tile of rows with all its columns and
// stages the tile's data once in shared memory by cp.async; a thread's
// X loads go out before it waits for that copy; the plan
// (ops/dia_spmv.py::launch_config) gives a tile about 512 elements and
// each of the 132 SMs at least two CTAs. The far offsets' X is read
// from L2, not staged: the tiles it lies on are in flight too.
//
// On an NVIDIA H100 80GB HBM3 at 700 W (PERF.md; chip_smoke.py
// --k1-parent, the first version and this one in turns in one run; cold
// medians, f64, d = 5): config #5b's 250,000 x 10 / x 20 139.8 -> 21.7
// / 434.1 -> 36.2 us and 10^6 x 10 / x 20 581.5 -> 73.6 / 1,730.7 ->
// 133.3 (69-81 % of the bound; the CSR call 152.0 / 165.1 / 437.5 /
// 486.9); LOBPCG's 10^4 x 10 8.7 -> 6.3 (the launch floor 5.4).
//
// Numerics: every term is __dmul_rn/__fmul_rn then __dadd_rn/__fadd_rn,
// never contracted, so the result is bitwise the plain version's (and
// the library is built with -fmad=false as well).

#include "dia_block.cuh"

extern "C" {

// One vector: x (n_cols,), y (n_rows,).
int spectra_dia_spmv_f64(const double* data, const double* x, double* y,
                         int64_t n_rows, int64_t n_cols,
                         const int64_t* offsets, int count, int threads,
                         int staged, void* stream) {
  spectra_dia::Args<double> A{data, x, y, n_rows, n_cols, 0, 0};
  return spectra_dia::launch<double, true>(A, offsets, count, threads,
                                           staged, stream);
}

int spectra_dia_spmv_f32(const float* data, const float* x, float* y,
                         int64_t n_rows, int64_t n_cols,
                         const int64_t* offsets, int count, int threads,
                         int staged, void* stream) {
  spectra_dia::Args<float> A{data, x, y, n_rows, n_cols, 0, 0};
  return spectra_dia::launch<float, true>(A, offsets, count, threads,
                                          staged, stream);
}

// A block: X (n_cols, ncol), Y (n_rows, ncol), row-major.
int spectra_dia_block_f64(const double* data, const double* x, double* y,
                          int64_t n_rows, int64_t n_cols, int64_t ncol,
                          const int64_t* offsets, int count, int threads,
                          int tile_rows, void* stream) {
  spectra_dia::BlockArgs<double> A{data, x, y, n_rows, n_cols, ncol, 0,
                                   tile_rows, 0, 0, 0};
  return spectra_dia::launch_block<double>(A, offsets, count, threads, stream);
}

int spectra_dia_block_f32(const float* data, const float* x, float* y,
                          int64_t n_rows, int64_t n_cols, int64_t ncol,
                          const int64_t* offsets, int count, int threads,
                          int tile_rows, void* stream) {
  spectra_dia::BlockArgs<float> A{data, x, y, n_rows, n_cols, ncol, 0,
                                  tile_rows, 0, 0, 0};
  return spectra_dia::launch_block<float>(A, offsets, count, threads, stream);
}

}  // extern "C"
