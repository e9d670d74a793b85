// Fused real row FFT -> transposed write for Hopper (sm_90a):
// out[k, r] = DFT_n(in[r, :])[k] for k < n/2 + 1 and every row r of a
// (rows, n) float32 matrix; out is (n/2 + 1, rows) interleaved complex64, n a
// power of two, radix 2 or mixed radix 4/2, forward only.
//
// Replaces the TPU kernel `rfft_rows_transpose_pallas` (body `_rfused_kernel`)
// of src/repro/kernels/fused/real.py: phase 1 of the fused real 2-D DFT, with
// no half-spectrum matrix in device memory between the row transforms and
// the transpose.  Same packing and split as rfft_rows.cu.
//
// Bound on this card: bytes (rows*n*4 read once, rows*(n/2+1)*8 written once;
// the flops are far below the compute line).  The read side is rfft_rows.cu's:
// coalesced float loads of `rows_per_cta` row pairs into shared buffer 1,
// the stage loop of stockham.cuh with the result kept in shared memory (row
// stride n + 1 float2, so the column-direction reads below hit different
// banks).  The write side is the hard one: bin k of row r goes to
// out[k*rows + r].  One pair already gives two neighbouring elements, 16
// contiguous bytes per output row; the store runs with the pair index
// fastest across the CTA's pairs, so a CTA writes rows_per_cta * 16
// contiguous bytes per output row.  Two buffers of rows_per_cta * (n + 1) * 8
// bytes must fit in the 227 KB a CTA can take: up to 16 pairs for n <= 512,
// 12 at 1024, 4 at 2048, 3 at 4096 and 1 at 8192 (the launcher's choice), so
// the widest lengths still write part sectors.  An odd row count leaves the
// last pair without b: it is read as 0 and its column is not stored.

#include "stockham.cuh"

namespace {

__global__ void __launch_bounds__(1024)
rfft_rows_transpose_kernel(const float* __restrict__ in, float2* __restrict__ out,
                           long long rows, int log2n, int radix, int rows_per_cta) {
    extern __shared__ float2 smem[];
    const int n = 1 << log2n;
    const int nh = n / 2 + 1;
    const int buf_stride = n + 1;
    const long long pairs = (rows + 1) / 2;
    const long long pair0 = (long long)blockIdx.x * rows_per_cta;
    const long long left = pairs - pair0;
    const int npairs = left < rows_per_cta ? (int)left : rows_per_cta;
    float2* buf0 = smem;
    float2* buf1 = smem + (size_t)rows_per_cta * buf_stride;

    for (int idx = threadIdx.x; idx < (npairs << log2n); idx += blockDim.x) {
        const int p = idx >> log2n;
        const int j = idx & (n - 1);
        const long long a = 2 * (pair0 + p);
        const float re = in[a * n + j];
        const float im = a + 1 < rows ? in[(a + 1) * n + j] : 0.0f;
        buf1[p * buf_stride + j] = make_float2(re, im);
    }
    __syncthreads();
    const float2* z = repro::stockham_rows(buf1, buf_stride, buf0, buf1, buf_stride,
                                           nullptr, 0, npairs, log2n, radix, 0);

    // Transposed store: thread index runs over (k, p) with p fastest.
    for (int idx = threadIdx.x; idx < npairs * nh; idx += blockDim.x) {
        const int k = idx / npairs;
        const int p = idx - k * npairs;
        const float2 zk = z[p * buf_stride + k];
        const float2 zr = z[p * buf_stride + ((n - k) & (n - 1))];
        const long long a = 2 * (pair0 + p);
        float2* dst = out + (long long)k * rows + a;
        dst[0] = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
        if (a + 1 < rows)
            dst[1] = make_float2(0.5f * (zk.y + zr.y), 0.5f * (zr.x - zk.x));
    }
}

int configured_smem = 48 * 1024;

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` is (rows, n) float32, `out` a distinct
// (n/2 + 1, rows) complex64 buffer; `rows_per_cta` counts row pairs.
extern "C" int repro_rfft_rows_transpose(const void* in, void* out, long long rows, int n,
                                         int radix, int rows_per_cta, int threads,
                                         void* stream) {
    if (rows <= 0) return 0;
    if (n < 2 || (n & (n - 1)) || (radix != 2 && radix != 4) || rows_per_cta < 1 ||
        threads < 32 || threads > 1024)
        return (int)cudaErrorInvalidValue;
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    const long long smem = 2LL * rows_per_cta * (n + 1) * (long long)sizeof(float2);
    if (smem > (1LL << 30)) return (int)cudaErrorInvalidValue;
    int err = repro::allow_dynamic_smem(rfft_rows_transpose_kernel, &configured_smem,
                                        (int)smem);
    if (err != 0) return err;
    const long long blocks = ((rows + 1) / 2 + rows_per_cta - 1) / rows_per_cta;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    rfft_rows_transpose_kernel<<<(unsigned)blocks, threads, (size_t)smem,
                                 (cudaStream_t)stream>>>(
        (const float*)in, (float2*)out, rows, log2n, radix, rows_per_cta);
    return (int)cudaGetLastError();
}
