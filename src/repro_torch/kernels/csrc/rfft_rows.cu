// Batched real row FFT for Hopper (sm_90a): out[r, k] = DFT_n(in[r, :])[k]
// for k < n/2 + 1 and every row r of a (rows, n) float32 matrix; out is
// (rows, n/2 + 1) interleaved complex64, n a power of two, 2 <= n <= 8192,
// forward only.  At n = 16384, where a pair would take regfft's Plan<14>,
// 1024 threads and 136 KiB, a CTA an SM, K3 runs rfft_rows_16k.cu's
// persistent kernel instead.
//
// Replaces the TPU kernel `rfft_rows_pallas` (body `_rfft_kernel`) of
// src/repro/kernels/fft/real.py.  Same algorithm: two real rows a = in[2p],
// b = in[2p + 1] are packed as z = a + i*b, one complex FFT gives Z, and the
// conjugate split A[k] = (Z[k] + conj Z[n-k]) / 2,
// B[k] = (Z[k] - conj Z[n-k]) / (2i) gives both spectra.  The TPU kernel
// wrote four full-width float planes for lane alignment and left the
// re-interleave and crop to the host; here the kernel writes the n/2 + 1
// bins of each row straight to its place in the result.
//
// Bound on this card: bytes.  The function must read rows*n*4 bytes and write
// rows*(n/2+1)*8 (0.16 ms at 8192 x 8192 at 3.35 TB/s); its
// 5*(n/2)*log2(n) flops per row are a fifth of that time at the float32
// peak.  So the design keeps the SM's memory traffic going:
// - a pair lives in registers (regfft.cuh): n/16 threads hold 16 points each
//   and run the passes in place, shared memory only exchanges points between
//   passes (three exchanges at n = 8192, padded, conflict-free);
// - each thread issues all 32 of its float loads (16 of row a, 16 of row b,
//   neighbouring threads on neighbouring floats) before the first butterfly,
//   straight into registers;
// - at n = 8192 a CTA is 512 threads with 68 KiB of shared memory and at
//   most 64 registers a thread, so two CTAs share an SM and one's loads
//   overlap the other's passes; shorter rows put several pairs in a CTA of
//   up to 256 threads;
// - after the last pass Z is written once to the exchange buffer in natural
//   order, and the split reads Z[k] and Z[n-k] from it and stores A and B
//   with neighbouring threads on neighbouring bins (float2 stores: rows of
//   n/2 + 1 bins are only 8-byte aligned).
// An odd row count leaves the last pair without b: it is read as 0 and its
// spectrum is not stored, so the caller pads and crops nothing.  `radix` is
// validated (2 or 4, as in the reference) but the passes depend on n only.

#include "regfft.cuh"

namespace {

using repro::regfft::Plan;
using repro::regfft::pad;
using repro::regfft::point_index;

template <int LOG2N>
__global__ void __launch_bounds__(Plan<LOG2N>::MAX_THREADS, Plan<LOG2N>::MIN_BLOCKS)
rfft_rows_kernel(const float* __restrict__ in, float2* __restrict__ out, long long rows) {
    using P = Plan<LOG2N>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP, NH = N / 2 + 1;
    extern __shared__ float2 smem[];
    const int t = threadIdx.x % G;
    const int local = threadIdx.x / G;
    const long long a = 2 * ((long long)blockIdx.x * (blockDim.x / G) + local);
    const bool has_a = a < rows, has_b = a + 1 < rows;
    const float* xa = in + (has_a ? a : 0) * N + t;
    const float* xb = in + (has_b ? a + 1 : 0) * N + t;

    float re[R], im[R];
#pragma unroll
    for (int k = 0; k < R; ++k) re[k] = has_a ? xa[k * G] : 0.0f;
#pragma unroll
    for (int k = 0; k < R; ++k) im[k] = has_b ? xb[k * G] : 0.0f;
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = make_float2(re[k], im[k]);

    const int base = local * N;
    repro::regfft::fft_row<LOG2N, false>(v, smem, base, t);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int k = 0; k < R; ++k) smem[point_index<G>(base, t, k)] = v[k];
    __syncthreads();
    if (!has_a) return;

    float2* oa = out + a * NH;
    float2* ob = oa + NH;
#pragma unroll
    for (int c = 0; c < (NH + G - 1) / G; ++c) {
        const int k = t + c * G;
        if (k < NH) {
            const float2 zk = smem[point_index<G>(base, t, c)];
            const float2 zr = smem[pad(base + ((N - k) & (N - 1)))];
            oa[k] = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
            if (has_b) ob[k] = make_float2(0.5f * (zk.y + zr.y), 0.5f * (zr.x - zk.x));
        }
    }
}

// One instantiation: checks that the launcher's shape is this one's
// (pairs_per_cta a power of two up to MAX_ROWS, threads = pairs_per_cta *
// GROUP) and launches.
template <int LOG2N>
int launch(const void* in, void* out, long long rows, int pairs_per_cta, int threads,
           cudaStream_t stream) {
    using P = Plan<LOG2N>;
    if (pairs_per_cta < 1 || pairs_per_cta > P::MAX_ROWS ||
        (pairs_per_cta & (pairs_per_cta - 1)) || threads != pairs_per_cta * P::GROUP)
        return (int)cudaErrorInvalidValue;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(pairs_per_cta, P::N);
    int err = repro::allow_dynamic_smem(rfft_rows_kernel<LOG2N>, &configured_smem, (int)smem);
    if (err != 0) return err;
    const long long blocks = ((rows + 1) / 2 + pairs_per_cta - 1) / pairs_per_cta;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    rfft_rows_kernel<LOG2N><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        (const float*)in, (float2*)out, rows);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` is (rows, n) float32, `out` a distinct
// (rows, n/2 + 1) complex64 buffer; `rows_per_cta` counts row pairs and,
// with `threads`, must be the shape kernels/fft/kernel.py::complex_rows_plan
// gives for (rows + 1) / 2 pairs.
extern "C" int repro_rfft_rows(const void* in, void* out, long long rows, int n,
                               int radix, int rows_per_cta, int threads, void* stream) {
    if (rows <= 0) return 0;
    if (radix != 2 && radix != 4) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (n) {
        case 1 << 1: return launch<1>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 2: return launch<2>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 3: return launch<3>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 4: return launch<4>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 5: return launch<5>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 6: return launch<6>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 7: return launch<7>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 8: return launch<8>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 9: return launch<9>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 10: return launch<10>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 11: return launch<11>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 12: return launch<12>(in, out, rows, rows_per_cta, threads, s);
        case 1 << 13: return launch<13>(in, out, rows, rows_per_cta, threads, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
