// Batched real row FFT for Hopper (sm_90a): out[r, k] = DFT_n(in[r, :])[k]
// for k < n/2 + 1 and every row r of a (rows, n) float32 matrix; out is
// (rows, n/2 + 1) interleaved complex64, n a power of two, radix 2 or mixed
// radix 4/2, forward only.
//
// Replaces the TPU kernel `rfft_rows_pallas` (body `_rfft_kernel`) of
// src/repro/kernels/fft/real.py.  Same algorithm: two real rows a = in[2p],
// b = in[2p + 1] are packed as z = a + i*b, one complex Stockham FFT gives Z,
// and the conjugate split A[k] = (Z[k] + conj Z[n-k]) / 2,
// B[k] = (Z[k] - conj Z[n-k]) / (2i) gives both spectra.  The TPU kernel
// wrote four full-width float planes for lane alignment and left the
// re-interleave and crop to the host; here the kernel writes the
// n/2 + 1 bins of each row straight to its place in the result.
//
// Bound on this card: bytes.  The function must read rows*n*4 bytes and write
// rows*(n/2+1)*8; its 5*(n/2)*log2(n) flops per row are far below what the
// card does in that time.  So each byte makes one trip: a CTA owns
// `rows_per_cta` row pairs, loads them with neighbouring threads on
// neighbouring floats (coalesced) into shared buffer 1, runs the stage loop
// of stockham.cuh with the result kept in shared memory (pass 0 reads
// buffer 1 and writes buffer 0, so the load must sit in buffer 1), and the
// split reads Z[k] and Z[n-k] from shared memory and stores A and B with
// neighbouring threads on neighbouring bins (coalesced).  An odd row count
// leaves the last pair without b: it is read as 0 and its spectrum is not
// stored, so the caller pads and crops nothing.

#include "stockham.cuh"

namespace {

__global__ void __launch_bounds__(1024)
rfft_rows_kernel(const float* __restrict__ in, float2* __restrict__ out,
                 long long rows, int log2n, int radix, int rows_per_cta) {
    extern __shared__ float2 smem[];
    const int n = 1 << log2n;
    const int nh = n / 2 + 1;
    const long long pairs = (rows + 1) / 2;
    const long long pair0 = (long long)blockIdx.x * rows_per_cta;
    const long long left = pairs - pair0;
    const int npairs = left < rows_per_cta ? (int)left : rows_per_cta;
    float2* buf0 = smem;
    float2* buf1 = smem + (size_t)rows_per_cta * n;

    for (int idx = threadIdx.x; idx < (npairs << log2n); idx += blockDim.x) {
        const int p = idx >> log2n;
        const int j = idx & (n - 1);
        const long long a = 2 * (pair0 + p);
        const float re = in[a * n + j];
        const float im = a + 1 < rows ? in[(a + 1) * n + j] : 0.0f;
        buf1[p * n + j] = make_float2(re, im);
    }
    __syncthreads();
    const float2* z = repro::stockham_rows(buf1, n, buf0, buf1, n, nullptr, 0,
                                           npairs, log2n, radix, 0);

    for (int idx = threadIdx.x; idx < npairs * nh; idx += blockDim.x) {
        const int p = idx / nh;
        const int k = idx - p * nh;
        const float2 zk = z[p * n + k];
        const float2 zr = z[p * n + ((n - k) & (n - 1))];
        const long long a = 2 * (pair0 + p);
        out[a * nh + k] = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
        if (a + 1 < rows)
            out[(a + 1) * nh + k] = make_float2(0.5f * (zk.y + zr.y), 0.5f * (zr.x - zk.x));
    }
}

int configured_smem = 48 * 1024;

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` is (rows, n) float32, `out` a distinct
// (rows, n/2 + 1) complex64 buffer; `rows_per_cta` counts row pairs.
extern "C" int repro_rfft_rows(const void* in, void* out, long long rows, int n,
                               int radix, int rows_per_cta, int threads, void* stream) {
    if (rows <= 0) return 0;
    if (n < 2 || (n & (n - 1)) || (radix != 2 && radix != 4) || rows_per_cta < 1 ||
        threads < 32 || threads > 1024)
        return (int)cudaErrorInvalidValue;
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    const long long smem = 2LL * rows_per_cta * n * (long long)sizeof(float2);
    if (smem > (1LL << 30)) return (int)cudaErrorInvalidValue;
    int err = repro::allow_dynamic_smem(rfft_rows_kernel, &configured_smem, (int)smem);
    if (err != 0) return err;
    const long long blocks = ((rows + 1) / 2 + rows_per_cta - 1) / rows_per_cta;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    rfft_rows_kernel<<<(unsigned)blocks, threads, (size_t)smem, (cudaStream_t)stream>>>(
        (const float*)in, (float2*)out, rows, log2n, radix, rows_per_cta);
    return (int)cudaGetLastError();
}
