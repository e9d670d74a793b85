// Batched row FFT of long rows for Hopper (sm_90a), K1b: out[r, :] =
// DFT_n(in[r, :]) for every row r of a (rows, n) matrix of interleaved
// complex64, forward or inverse (inverse scaled by 1/n), n a power of two,
// 2^19 <= n <= 2^28: the rows fft_rows.cu (K1, n <= 16384) cannot hold in
// one CTA's registers, nor fft_rows_cluster.cu (n = 32768 ... 2^18) in one
// cluster's shared memory.  The entry takes n >= 32768 as well; the
// launcher (kernels/fft/large.py) sends n <= 2^18 to the cluster kernel.
//
// Replaces the TPU kernel `fft_rows_pallas` (body `_fft_kernel`) of
// src/repro/kernels/fft/kernel.py at n > 16384, where that kernel holds a
// row in VMEM and an H100 CTA cannot.
//
// Algorithm: the four-step.  n = n1*n2 (n1, n2 powers of two in [128, 16384],
// the split of kernels/fft/large.py::large_split); row r viewed as
// A[j1][j2] = x[j1*n2 + j2] gives
//   X[k1 + n1*k2] = sum_j2 w_n2^(j2*k2) * w_n^(k1*j2) * sum_j1 w_n1^(j1*k1) * A[j1][j2].
// - Pass A (complex_columns_kernel, fourstep.cuh): the length-n1 DFT of
//   each column j2, times the twiddle w_n^(k1*j2), written as B[k1][j2] in
//   A's layout ([s][k1][j2]) to a scratch buffer; a CTA takes COLS adjacent
//   columns of one row (32 up to n1 = 512), 16 points a thread, the columns
//   fastest in a warp, regfft.cuh's passes with the columns interleaved in
//   shared memory, the twiddles from five base values a thread.
// - Pass B (rows_transpose_kernel, fourstep.cuh): the length-n2 DFT of each
//   row of B with the transposed store out[k1 + n1*k2]: K2's function
//   (fft_rows_transpose.cu) on each signal row's (n1, n2) matrix, with a
//   batch dimension, so one launch covers every signal row of the call.  Its
//   passes, CTA and swizzled buffer are K2's (regfft.cuh, tstore.cuh), its
//   store clusters wider (16 rows side by side or more); only the output
//   index carries the batch: row R = s*n1 + k1 of the launch goes to
//   out[s*n + k2*n1 + k1].
// - The inverse conjugates the twiddles (w^m split into two exact sincospif
//   arguments, fourstep.cuh) and scales by 1/n1 and 1/n2.
//
// Bound on this card: bytes.  The function must read rows*n*8 bytes and write
// as many; the four-step reads and writes the row twice (in -> scratch ->
// out), so it moves twice the function's bytes and can reach at best half its
// bound.  What the design does about it: each pass moves every element once
// each way (no separate transpose or twiddle pass: the twiddle rides on pass
// A's store and the transpose on pass B's), and both move whole sectors in
// long runs: pass A's warps load and store 256 contiguous bytes of a row of
// the view (32 columns side by side, n1 <= 512), where regfft's own column
// layout gave a warp one column of 32 rows and cost pass A three to four
// times a copy; pass B stores runs of 16 rows or more (128 bytes).  The
// scratch (a bounded number of rows, kernels/fft/large.py) stays in the 50
// MB L2 only at the smallest calls.  Where a row fits in a cluster's shared
// memory (n <= 2^18) the one-pass kernel of fourstep_cluster.cuh keeps pass
// A's output there instead.
//
// `rows_per_cta` and `threads` are pass B's launch shape, kernels/fft/
// kernel.py::complex_rows_plan(n2, rows*n1); pass A's follows from n1.

#include "fourstep.cuh"

// Launches pass A and then pass B on `stream` (two kernel launches) and does
// not synchronise.  Returns a CUDA error code (0 = both launched).  `in` and
// `out` are distinct (rows, n1*n2) complex64 buffers, `scratch` one of at
// least as many elements, distinct from both; n1 and n2 powers of two in
// [128, 16384]; `rows_per_cta` and `threads` pass B's shape,
// kernels/fft/kernel.py::complex_rows_plan(n2, rows*n1).
extern "C" int repro_fft_rows_large(const void* in, void* out, void* scratch, long long rows,
                                    int n1, int n2, int inverse, int rows_per_cta,
                                    int threads, void* stream) {
    if (rows <= 0) return 0;
    const int log2n1 = log2_of(n1), log2n2 = log2_of(n2);
    if (!factors_ok(log2n1, log2n2)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int err = inverse
        ? columns_for<true, kBatchMajor>(log2n1, in, scratch, rows, log2n2, 0, 0, s)
        : columns_for<false, kBatchMajor>(log2n1, in, scratch, rows, log2n2, 0, 0, s);
    if (err != 0) return err;
    const long long brows = rows << log2n1;
    return inverse ? rows_for<true, false>(log2n2, scratch, out, brows, log2n1, 0, 0, 0,
                                           rows_per_cta, threads, s)
                   : rows_for<false, false>(log2n2, scratch, out, brows, log2n1, 0, 0, 0,
                                            rows_per_cta, threads, s);
}
