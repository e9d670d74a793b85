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
// Two launches (fourstep.cuh): pass A is K1b's column pass with a packing
// load (two float32 rows, b = 0 for an unpaired last row), B stored as
// [p][k1][j2]; pass B (rows_split_kernel) runs the length-n2 DFTs of B's
// rows and splits in its epilogue.  The split pairs bin k1 + n1*k2 with
// n1 - k1 + n1*(n2 - 1 - k2), a bin of row n1 - k1, so a CTA (or a cluster
// of CTAs) holds both rows of W/2 slots (k1, n1 - k1) of one pair, the W/2
// neighbouring k1 and their W/2 partners, and stores A to row 2p and B to
// row 2p + 1 of the result, runs of W/2 elements (W = 32 at n = 32768: a
// CTA of 512 threads, twice regfft's rows, so the runs are 128 bytes).
// Z never goes to device memory.
//
// Bound on this card: bytes.  The function must read rows*n*4 bytes and write
// rows*(n/2+1)*8; the kernel moves the packed pairs in -> scratch -> out,
// about twice that.  Pass A's float32 loads of 4 adjacent columns are half
// sectors; the output rows are an odd number of float2 apart, so the runs
// of rows 2p and 2p + 1 cannot both start on a 32-byte boundary.
//
// `rows_per_cta` and `threads` are pass B's launch shape,
// kernels/fft/real_large.py::split_rows_plan(n2, pairs*n1) for pairs =
// (rows + 1) / 2.

#include "fourstep.cuh"

// Launches passes A and B on `stream` (two kernel launches) and does not
// synchronise.  Returns a CUDA error code (0 = both launched).  `in` is
// (rows, n1*n2) float32; `out` (rows, n1*n2/2 + 1) complex64 with row stride
// `out_stride`; `scratch` holds (rows + 1) / 2 complex64 rows of n1*n2,
// distinct from `in` and `out`; n1 and n2 powers of two in [128, 16384].
extern "C" int repro_rfft_rows_large(const void* in, void* out, void* scratch, long long rows,
                                     int n1, int n2, long long out_stride, int rows_per_cta,
                                     int threads, void* stream) {
    return real_rows_large<false>(in, out, scratch, rows, n1, n2, out_stride, rows_per_cta,
                                  threads, stream);
}
