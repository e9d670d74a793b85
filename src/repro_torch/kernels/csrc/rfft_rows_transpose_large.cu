// Fused real row FFT -> transposed store of long rows for Hopper (sm_90a),
// K4b: out[k, r] = DFT_n(in[r, :])[k] for k < n/2 + 1 and every row r of a
// (rows, n) float32 matrix; out is (n/2 + 1, rows) interleaved complex64 (a
// column slice of a wider one: row stride `out_stride`), n a power of two,
// 32768 <= n <= 2^28, forward only: the rows rfft_rows_transpose.cu (K4,
// n <= 16384) cannot hold in one CTA's registers.
//
// Replaces the TPU kernel `rfft_rows_transpose_pallas` (body
// `_rfused_kernel`) of src/repro/kernels/fused/real.py at n > 16384.
//
// K3b (rfft_rows_large.cu) with pass C storing transposed (fourstep.cuh,
// split_kernel<true>): a CTA splits a tile of kTilePairs = 16 pairs x
// kTileBins = 32 bins into shared memory (a warp reads 32 consecutive bins
// of one pair, Z[k] and Z[(n-k) mod n], whole sectors both ways), then each
// warp writes the tile's 32 columns of one output row, 256 contiguous bytes.
// Passes A and B, and the second scratch buffer that holds Z between them
// and pass C, are K3b's.
//
// Bound on this card: bytes, as K3b's (rows*n*4 read, rows*(n/2+1)*8
// written); the kernel moves about four times that.
//
// `rows_per_cta` and `threads` are pass B's launch shape, kernels/fft/
// kernel.py::complex_rows_plan(n2, pairs*n1) for pairs = (rows + 1) / 2.

#include "fourstep.cuh"

// Launches passes A, B and C on `stream` (three kernel launches) and does
// not synchronise.  Returns a CUDA error code (0 = all launched).  `in` is
// (rows, n1*n2) float32; `out` the first of `rows` columns of an
// (n1*n2/2 + 1, out_stride) complex64 buffer; `scratch` and `zbuf` as for
// repro_rfft_rows_large.
extern "C" int repro_rfft_rows_transpose_large(const void* in, void* out, void* scratch,
                                               void* zbuf, long long rows, int n1, int n2,
                                               long long out_stride, int rows_per_cta,
                                               int threads, void* stream) {
    return real_rows_large<true>(in, out, scratch, zbuf, rows, n1, n2, out_stride,
                                 rows_per_cta, threads, stream);
}
