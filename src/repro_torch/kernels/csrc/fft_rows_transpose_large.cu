// Fused row FFT -> transposed store of long rows for Hopper (sm_90a), K2b:
// out[k, r] = DFT_n(in[r, :])[k] for every row r of a (rows, n) matrix of
// interleaved complex64, out of shape (n, rows) (a column slice of a wider
// one: row stride `out_stride`); forward or inverse (scaled by 1/n), n a
// power of two, 32768 <= n <= 2^28: the rows fft_rows_transpose.cu (K2,
// n <= 16384) cannot hold in one CTA's registers.  At n = 32768 and 65536
// the launcher takes the one-pass fft_rows_transpose_cluster.cu instead,
// and these two passes the longer rows.
//
// Replaces the TPU kernel `fft_rows_transpose_pallas` (body `_fused_kernel`)
// of src/repro/kernels/fused/kernel.py at n > 65536.
//
// Algorithm: K1b's four-step (fft_rows_large.cu, fourstep.cuh) with two
// changes, so that the transposed result needs no pass of its own:
// - Pass A writes B[k1][j2] of row s to scratch in [k1][s][j2] order, the
//   rows of one k1 side by side with a stride of cap = the call's rows
//   rounded up to a power of two (rows beyond the call are masked in pass B).
// - Pass B, K2's kernel with its cluster store, takes row R = k1*cap + s and
//   stores bin k2 to out[(k1 + n1*k2)*out_stride + s].  The rows side by
//   side in a CTA (or a cluster) share k1 and are neighbouring s: the store
//   writes contiguous runs of an output row, as K2's does.  In K1b's
//   [s][k1][j2] order they would share s, and their outputs would lie `rows`
//   elements apart.
// With an odd out_stride output rows start off 32-byte boundaries, so a run
// covers one more sector than it would aligned.
//
// Bound on this card: bytes, as K1b's (rows*n*8 read and written once; the
// four-step moves twice that: in -> scratch -> out).  What the design does
// about it is K1b's: pass A's warps move 256 contiguous bytes of a row of
// the view, its store to [k1][s][j2] as its load; pass B's clusters put 16
// rows or more side by side, so that a store writes 128-byte runs of an
// output row wherever the chunk holds 16 rows or more.
//
// `rows_per_cta` and `threads` are pass B's launch shape, kernels/fft/
// kernel.py::complex_rows_plan(n2, cap*n1); pass A's follows from n1.

#include "fourstep.cuh"

// Launches pass A and then pass B on `stream` (two kernel launches) and does
// not synchronise.  Returns a CUDA error code (0 = both launched).  `in` is
// (rows, n1*n2) complex64; `out` the first of `rows` columns of an
// (n1*n2, out_stride) buffer; `scratch` holds cap*n1*n2 elements (cap the
// least power of two >= rows), distinct from both; n1 and n2 powers of two
// in [128, 16384].
extern "C" int repro_fft_rows_transpose_large(const void* in, void* out, void* scratch,
                                              long long rows, int n1, int n2, int inverse,
                                              long long out_stride, int rows_per_cta,
                                              int threads, void* stream) {
    if (rows <= 0) return 0;
    const int log2n1 = log2_of(n1), log2n2 = log2_of(n2);
    if (!factors_ok(log2n1, log2n2) || out_stride < rows) return (int)cudaErrorInvalidValue;
    int log2cap = 0;
    while ((1LL << log2cap) < rows) ++log2cap;
    cudaStream_t s = (cudaStream_t)stream;
    int err = inverse ? columns_for<true, kTransposedStore>(log2n1, in, scratch, rows, log2n2,
                                                            log2cap, 0, s)
                      : columns_for<false, kTransposedStore>(log2n1, in, scratch, rows,
                                                             log2n2, log2cap, 0, s);
    if (err != 0) return err;
    const long long brows = 1LL << (log2cap + log2n1);
    return inverse ? rows_for<true, true>(log2n2, scratch, out, brows, log2n1, log2cap, rows,
                                          out_stride, rows_per_cta, threads, s)
                   : rows_for<false, true>(log2n2, scratch, out, brows, log2n1, log2cap, rows,
                                           out_stride, rows_per_cta, threads, s);
}
