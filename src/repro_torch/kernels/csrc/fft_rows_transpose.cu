// Fused row FFT -> transposed write for Hopper (sm_90a):
// out[k, r] = DFT_n(in[r, :])[k] for a (rows, n) matrix of interleaved
// complex64, out of shape (n, rows); forward or inverse (scaled by 1/n), n a
// power of two, radix 2 or mixed radix 4/2.
//
// Replaces the TPU kernel `fft_rows_transpose_pallas` (body `_fused_kernel`)
// of src/repro/kernels/fused/kernel.py: the row-transformed matrix never goes
// through device memory between the transform and the transpose.
//
// Bound on this card: bytes (rows*n*8 read once, rows*n*8 written once; the
// flops are far below the compute line).  The read side is the row-FFT
// kernel's: the first Stockham pass (stockham.cuh) reads whole rows coalesced.
// The write side is the hard one: element k of row r goes to out[k*rows + r],
// so one row alone writes 8 bytes into each of n different 32-byte sectors.
// The design holds `rows_per_cta` rows in one CTA, keeps the last pass's
// result in shared memory (row stride n + 1 float2, so the column-direction
// reads below hit different banks), and stores with neighbouring threads on
// neighbouring rows: for a fixed k the CTA writes rows_per_cta * 8 contiguous
// bytes.  The launcher picks rows_per_cta as a multiple of 4 (whole 32-byte
// sectors) up to 16 where shared memory allows: two buffers of
// rows_per_cta * (n + 1) * 8 bytes must fit in the 227 KB a CTA can take.
// At n = 4096 that leaves 3 rows and at n = 8192 a single row, so the widest
// lengths still write part sectors; lifting that (in-place passes that need
// one buffer, or a cluster sharing the transposed tile) is the redesign the
// store pattern is left for.  The ragged last block stores only its rows.

#include "stockham.cuh"

namespace {

__global__ void __launch_bounds__(1024)
fft_rows_transpose_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                          long long rows, int log2n, int radix, int inverse,
                          int rows_per_cta) {
    extern __shared__ float2 smem[];
    const int n = 1 << log2n;
    const int buf_stride = n + 1;
    const long long row0 = (long long)blockIdx.x * rows_per_cta;
    const long long left = rows - row0;
    const int nrows = left < rows_per_cta ? (int)left : rows_per_cta;
    float2* buf0 = smem;
    float2* buf1 = smem + (size_t)rows_per_cta * buf_stride;
    const float2* res = repro::stockham_rows(in + row0 * n, n, buf0, buf1, buf_stride,
                                             nullptr, 0, nrows, log2n, radix, inverse);
    // Transposed store: thread index runs over (k, r) with r fastest.
    const int total = nrows << log2n;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int k = idx / nrows;
        const int r = idx - k * nrows;
        out[(long long)k * rows + row0 + r] = res[r * buf_stride + k];
    }
}

int configured_smem = 48 * 1024;

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` is (rows, n), `out` a distinct (n, rows) buffer.
extern "C" int repro_fft_rows_transpose(const void* in, void* out, long long rows, int n,
                                        int radix, int inverse, int rows_per_cta,
                                        int threads, void* stream) {
    if (rows <= 0) return 0;
    if (n < 2 || (n & (n - 1)) || (radix != 2 && radix != 4) || rows_per_cta < 1 ||
        threads < 32 || threads > 1024)
        return (int)cudaErrorInvalidValue;
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    const long long smem = 2LL * rows_per_cta * (n + 1) * (long long)sizeof(float2);
    if (smem > (1LL << 30)) return (int)cudaErrorInvalidValue;
    int err = repro::allow_dynamic_smem(fft_rows_transpose_kernel, &configured_smem, (int)smem);
    if (err != 0) return err;
    const long long blocks = (rows + rows_per_cta - 1) / rows_per_cta;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    fft_rows_transpose_kernel<<<(unsigned)blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(
        (const float2*)in, (float2*)out, rows, log2n, radix, inverse, rows_per_cta);
    return (int)cudaGetLastError();
}
