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
// K3b (rfft_rows_large.cu) with K2b's scratch order (fourstep.cuh): pass A
// stores the packed pairs' B as [k1][p][j2], cap pairs a k1 (cap the least
// power of two >= the pairs of the call, pairs past them masked in pass B),
// so a pass-B CTA (or cluster) holds one slot (k1, n1 - k1) for W/2
// neighbouring pairs.  Its split of pair p goes to out[k][2p] and
// out[k][2p + 1]: the W/2 pairs side by side write 8*W contiguous bytes of
// each output row (256 at n = 32768), one float4 a pair where the row stride
// is even.  Two launches; Z never goes to device memory.
//
// Bound on this card: bytes, as K3b's (rows*n*4 read, rows*(n/2+1)*8
// written); the kernel moves about twice that.
//
// `rows_per_cta` and `threads` are pass B's launch shape,
// kernels/fft/real_large.py::split_rows_plan(n2, cap*n1).

#include "fourstep.cuh"

// Launches passes A and B on `stream` (two kernel launches) and does not
// synchronise.  Returns a CUDA error code (0 = both launched).  `in` is
// (rows, n1*n2) float32; `out` the first of `rows` columns of an
// (n1*n2/2 + 1, out_stride) complex64 buffer; `scratch` holds cap complex64
// rows of n1*n2 (cap the least power of two >= (rows + 1) / 2), distinct
// from both; n1 and n2 powers of two in [128, 16384].
extern "C" int repro_rfft_rows_transpose_large(const void* in, void* out, void* scratch,
                                               long long rows, int n1, int n2,
                                               long long out_stride, int rows_per_cta,
                                               int threads, void* stream) {
    return real_rows_large<true>(in, out, scratch, rows, n1, n2, out_stride, rows_per_cta,
                                 threads, stream);
}
