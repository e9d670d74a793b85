// Batched row FFT for Hopper (sm_90a): out[r, :] = DFT_n(in[r, :]) for every
// row r of a (rows, n) matrix of interleaved complex64, forward or inverse
// (inverse scaled by 1/n), n a power of two, radix 2 or mixed radix 4/2.
//
// Replaces the TPU kernel `fft_rows_pallas` (body `_fft_kernel`) of
// src/repro/kernels/fft/kernel.py.  That kernel carries two float planes
// because its target has no complex type; here a complex64 element is one
// float2, read and written as it lies in the tensor.
//
// Bound on this card: bytes.  The function must read rows*n*8 bytes and write
// as many; its 5*n*log2(n) flops per row are far below what the card does in
// the time those bytes take.  So the design moves each element through device
// memory exactly once each way: a CTA owns `rows_per_cta` whole rows, the
// first Stockham pass reads them from device memory with neighbouring threads
// on neighbouring float2 (coalesced), the middle passes ping-pong between two
// dynamic shared buffers (2 * rows_per_cta * n * 8 bytes, 128 KiB for one row
// of 8192, hence the opt-in above 48 KiB), and the last pass writes the result
// straight back, again coalesced.  Small n puts several rows in one CTA so the
// CTA has enough butterflies to fill its threads.  The last block is ragged:
// it transforms only the rows that exist, so the caller pads nothing.

#include "stockham.cuh"

namespace {

__global__ void __launch_bounds__(1024)
fft_rows_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                long long rows, int log2n, int radix, int inverse, int rows_per_cta) {
    extern __shared__ float2 smem[];
    const int n = 1 << log2n;
    const long long row0 = (long long)blockIdx.x * rows_per_cta;
    const long long left = rows - row0;
    const int nrows = left < rows_per_cta ? (int)left : rows_per_cta;
    float2* buf0 = smem;
    float2* buf1 = smem + (size_t)rows_per_cta * n;
    repro::stockham_rows(in + row0 * n, n, buf0, buf1, n,
                         out + row0 * n, n, nrows, log2n, radix, inverse);
}

int configured_smem = 48 * 1024;

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` and `out` are distinct (rows, n) complex64 buffers.
extern "C" int repro_fft_rows(const void* in, void* out, long long rows, int n,
                              int radix, int inverse, int rows_per_cta, int threads,
                              void* stream) {
    if (rows <= 0) return 0;
    if (n < 2 || (n & (n - 1)) || (radix != 2 && radix != 4) || rows_per_cta < 1 ||
        threads < 32 || threads > 1024)
        return (int)cudaErrorInvalidValue;
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    const long long smem = 2LL * rows_per_cta * n * (long long)sizeof(float2);
    if (smem > (1LL << 30)) return (int)cudaErrorInvalidValue;
    int err = repro::allow_dynamic_smem(fft_rows_kernel, &configured_smem, (int)smem);
    if (err != 0) return err;
    const long long blocks = (rows + rows_per_cta - 1) / rows_per_cta;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    fft_rows_kernel<<<(unsigned)blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(
        (const float2*)in, (float2*)out, rows, log2n, radix, inverse, rows_per_cta);
    return (int)cudaGetLastError();
}
