// Batched real row FFT of long rows for Hopper (sm_90a), K3b:
// out[r, k] = DFT_n(in[r, :])[k] for k < n/2 + 1 and every row r of a
// (rows, n) float32 matrix; out is (rows, n/2 + 1) interleaved complex64, n
// a power of two, 32768 <= n <= 2^28, forward only: the rows rfft_rows.cu
// (K3, n <= 16384) cannot hold in one CTA's registers.
//
// Replaces the TPU kernel `rfft_rows_pallas` (body `_rfft_kernel`) of
// src/repro/kernels/fft/real.py at n > 16384.  Same algorithm: two real rows
// a = in[2p], b = in[2p + 1] are packed as z = a + i*b, one complex DFT
// gives Z, and the conjugate split gives both half spectra.
//
// Three launches (fourstep.cuh): pass A is K1b's column pass with a packing
// load (two float32 rows, b = 0 for an unpaired last row); pass B is K1b's,
// unchanged, and writes Z in natural order to a second scratch buffer; pass
// C (split_kernel) reads Z[k] and Z[(n-k) mod n] from it, both contiguous
// runs, and writes rows 2p and 2p + 1 of the result, neighbouring threads on
// neighbouring bins.  Z does not stay on chip: the split pairs bin k1 + n1*k2
// with n1 - k1 + n1*(n2 - 1 - k2), a row of pass B that another CTA holds, so
// Z takes one more round trip through device memory (a later design may pair
// rows k1 and n1 - k1 in one cluster of pass B).
//
// Bound on this card: bytes.  The function must read rows*n*4 bytes and write
// rows*(n/2+1)*8; the kernel moves the packed pairs in -> scratch -> Z ->
// out, about four times that.  Pass A's float32 loads of 4 adjacent columns
// are half sectors.
//
// `rows_per_cta` and `threads` are pass B's launch shape, kernels/fft/
// kernel.py::complex_rows_plan(n2, pairs*n1) for pairs = (rows + 1) / 2.

#include "fourstep.cuh"

// Launches passes A, B and C on `stream` (three kernel launches) and does
// not synchronise.  Returns a CUDA error code (0 = all launched).  `in` is
// (rows, n1*n2) float32; `out` (rows, n1*n2/2 + 1) complex64 with row stride
// `out_stride`; `scratch` and `zbuf` hold (rows + 1) / 2 complex64 rows of
// n1*n2 each, distinct from each other and from `in` and `out`; n1 and n2
// powers of two in [128, 16384].
extern "C" int repro_rfft_rows_large(const void* in, void* out, void* scratch, void* zbuf,
                                     long long rows, int n1, int n2, long long out_stride,
                                     int rows_per_cta, int threads, void* stream) {
    return real_rows_large<false>(in, out, scratch, zbuf, rows, n1, n2, out_stride,
                                  rows_per_cta, threads, stream);
}
