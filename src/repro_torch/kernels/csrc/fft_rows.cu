// Batched row FFT for Hopper (sm_90a): out[r, :] = DFT_n(in[r, :]) for every
// row r of a (rows, n) matrix of interleaved complex64, forward or inverse
// (inverse scaled by 1/n), n a power of two, 2 <= n <= 16384 (longer rows go
// to the two-pass fft_rows_large.cu).
//
// Replaces the TPU kernel `fft_rows_pallas` (body `_fft_kernel`) of
// src/repro/kernels/fft/kernel.py.  That kernel carries two float planes
// because its target has no complex type; here a complex64 element is one
// float2, read and written as it lies in the tensor.
//
// Bound on this card: bytes.  The function must read rows*n*8 bytes and write
// as many (0.32 ms at 8192 x 8192 at 3.35 TB/s); its 5*n*log2(n) flops per
// row are a fifth of that time at the float32 peak.  So the design keeps the
// SM's memory traffic going and moves each element through device memory
// exactly once each way:
// - a row lives in registers (regfft.cuh): n/16 threads hold 16 points each
//   and run the passes in place, shared memory only exchanges points between
//   passes (radices 16.16.16.2 and three padded, conflict-free exchanges at
//   n = 8192);
// - each thread issues all 16 of its float2 loads x[t + k*n/16] before the
//   first butterfly, neighbouring threads on neighbouring float2, straight
//   into registers;
// - the last pass leaves X[t + k*n/16] in the thread's registers in natural
//   order, so the 16 stores go straight to device memory, coalesced like the
//   loads: no final exchange;
// - at n = 8192 a CTA is 512 threads with 68 KiB of shared memory and at
//   most 64 registers a thread, so two CTAs share an SM and one's loads
//   overlap the other's passes; shorter rows put several rows in a CTA of
//   up to 256 threads.  At n = 16384 (Plan<14>) a CTA is 1024 threads with
//   136 KiB and the same 64 registers, one row and one CTA an SM: no second
//   CTA hides its loads.
// The last CTA may be ragged: its threads without a row load zeros, take part
// in the exchanges and store nothing, so the caller pads nothing.  `radix` is
// validated (2 or 4, as in the reference) but the passes depend on n only.

#include "regfft.cuh"

namespace {

using repro::regfft::Plan;

template <int LOG2N, bool INV>
__global__ void __launch_bounds__(Plan<LOG2N>::MAX_THREADS, Plan<LOG2N>::MIN_BLOCKS)
fft_rows_kernel(const float2* __restrict__ in, float2* __restrict__ out, long long rows) {
    using P = Plan<LOG2N>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP;
    extern __shared__ float2 smem[];
    const int t = threadIdx.x % G;
    const int local = threadIdx.x / G;
    const long long row = (long long)blockIdx.x * (blockDim.x / G) + local;
    const bool has_row = row < rows;
    const float2* x = in + (has_row ? row : 0) * N + t;

    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = has_row ? x[k * G] : make_float2(0.0f, 0.0f);

    repro::regfft::fft_row<LOG2N, INV>(v, smem, local * N, t);
    if (!has_row) return;

    float2* y = out + row * N + t;
#pragma unroll
    for (int k = 0; k < R; ++k) y[k * G] = v[k];
}

// One instantiation: checks that the launcher's shape is this one's
// (rows_per_cta a power of two up to MAX_ROWS, threads = rows_per_cta *
// GROUP) and launches.
template <int LOG2N, bool INV>
int launch(const void* in, void* out, long long rows, int rows_per_cta, int threads,
           cudaStream_t stream) {
    using P = Plan<LOG2N>;
    if (rows_per_cta < 1 || rows_per_cta > P::MAX_ROWS ||
        (rows_per_cta & (rows_per_cta - 1)) || threads != rows_per_cta * P::GROUP)
        return (int)cudaErrorInvalidValue;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(rows_per_cta, P::N);
    int err = repro::allow_dynamic_smem(fft_rows_kernel<LOG2N, INV>, &configured_smem,
                                        (int)smem);
    if (err != 0) return err;
    const long long blocks = (rows + rows_per_cta - 1) / rows_per_cta;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    fft_rows_kernel<LOG2N, INV><<<(unsigned)blocks, threads, (size_t)smem, stream>>>(
        (const float2*)in, (float2*)out, rows);
    return (int)cudaGetLastError();
}

template <int LOG2N>
int launch_dir(const void* in, void* out, long long rows, int inverse, int rows_per_cta,
               int threads, cudaStream_t stream) {
    return inverse ? launch<LOG2N, true>(in, out, rows, rows_per_cta, threads, stream)
                   : launch<LOG2N, false>(in, out, rows, rows_per_cta, threads, stream);
}

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` and `out` are distinct (rows, n) complex64 buffers;
// `rows_per_cta` and `threads` must be the shape
// kernels/fft/kernel.py::complex_rows_plan gives.
extern "C" int repro_fft_rows(const void* in, void* out, long long rows, int n,
                              int radix, int inverse, int rows_per_cta, int threads,
                              void* stream) {
    if (rows <= 0) return 0;
    if (radix != 2 && radix != 4) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const int r = rows_per_cta, th = threads;
    switch (n) {
        case 1 << 1: return launch_dir<1>(in, out, rows, inverse, r, th, s);
        case 1 << 2: return launch_dir<2>(in, out, rows, inverse, r, th, s);
        case 1 << 3: return launch_dir<3>(in, out, rows, inverse, r, th, s);
        case 1 << 4: return launch_dir<4>(in, out, rows, inverse, r, th, s);
        case 1 << 5: return launch_dir<5>(in, out, rows, inverse, r, th, s);
        case 1 << 6: return launch_dir<6>(in, out, rows, inverse, r, th, s);
        case 1 << 7: return launch_dir<7>(in, out, rows, inverse, r, th, s);
        case 1 << 8: return launch_dir<8>(in, out, rows, inverse, r, th, s);
        case 1 << 9: return launch_dir<9>(in, out, rows, inverse, r, th, s);
        case 1 << 10: return launch_dir<10>(in, out, rows, inverse, r, th, s);
        case 1 << 11: return launch_dir<11>(in, out, rows, inverse, r, th, s);
        case 1 << 12: return launch_dir<12>(in, out, rows, inverse, r, th, s);
        case 1 << 13: return launch_dir<13>(in, out, rows, inverse, r, th, s);
        case 1 << 14: return launch_dir<14>(in, out, rows, inverse, r, th, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
