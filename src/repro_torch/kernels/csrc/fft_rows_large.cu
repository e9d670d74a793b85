// Batched row FFT of long rows for Hopper (sm_90a), K1b: out[r, :] =
// DFT_n(in[r, :]) for every row r of a (rows, n) matrix of interleaved
// complex64, forward or inverse (inverse scaled by 1/n), n a power of two,
// 32768 <= n <= 2^28: the rows fft_rows.cu (K1, n <= 16384) cannot hold in
// one CTA's registers.
//
// Replaces the TPU kernel `fft_rows_pallas` (body `_fft_kernel`) of
// src/repro/kernels/fft/kernel.py at n > 16384, where that kernel holds a
// row in VMEM and an H100 CTA cannot.
//
// Algorithm: the four-step.  n = n1*n2 (n1, n2 powers of two in [128, 16384],
// the split of kernels/fft/large.py::large_split); row r viewed as
// A[j1][j2] = x[j1*n2 + j2] gives
//   X[k1 + n1*k2] = sum_j2 w_n2^(j2*k2) * w_n^(k1*j2) * sum_j1 w_n1^(j1*k1) * A[j1][j2].
// - Pass A (columns_kernel): the length-n1 DFT of each column j2, times the
//   twiddle w_n^(k1*j2), written as B[k1][j2] in A's layout to a scratch
//   buffer.  A CTA takes COLS adjacent columns of one row (at least 4 where
//   they fit, so the CTA reads whole 32-byte sectors of every row of the
//   view), column c by the GROUP threads of regfft.cuh's plan for n1, each
//   holding 16 points in registers; the passes and exchanges are regfft.cuh's.
// - Pass B (rows_transpose_kernel): the length-n2 DFT of each row of B with
//   the transposed store out[k1 + n1*k2]: K2's function (fft_rows_transpose.cu)
//   on each signal row's (n1, n2) matrix, with a batch dimension, so one
//   launch covers every signal row of the call.  Its passes, launch shape,
//   swizzled buffer and cluster store are K2's (regfft.cuh, tstore.cuh); only
//   the output index carries the batch: row R = s*n1 + k1 of the launch goes
//   to out[s*n + k2*n1 + k1].
// - The inverse conjugates the twiddles; fft_row<.., true> scales by 1/n1 in
//   pass A and 1/n2 in pass B, powers of two whose product is 1/n exactly.
//
// Twiddle: m = k1*j2 < n is an exact integer, but 2m/n is exact in float only
// while n <= 2^24.  So m = mh*2^14 + ml and w^m = w^(mh*2^14) * w^ml, two
// sincospif of the exact arguments mh*2^15/n and 2*ml/n (mh, ml < 2^14, n a
// power of two), each good to about an ulp.  No __sincosf, no table and no
// -use_fast_math, for regfft.cuh's reasons.
//
// Bound on this card: bytes.  The function must read rows*n*8 bytes and write
// as many; the four-step reads and writes the row twice (in -> scratch ->
// out), so it moves twice the function's bytes and can reach at best half its
// bound.  What the design does about it: each pass moves every element once
// each way (no separate transpose or twiddle pass: the twiddle rides on pass
// A's store and the transpose on pass B's), pass A's CTAs take whole sectors,
// and pass B stores 32-byte runs of each output row as K2 does.  The scratch
// (a bounded number of rows, kernels/fft/large.py) stays in the 50 MB L2 only
// at the smallest calls.  A simple first port: a later one may keep pass A's
// output in shared memory across a cluster, or overlap the passes.
//
// `rows_per_cta` and `threads` are pass B's launch shape, kernels/fft/
// kernel.py::complex_rows_plan(n2, rows*n1); pass A's follows from n1.

#include <cooperative_groups.h>

#include "tstore.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::cmul;
using repro::regfft::Plan;
using repro::tstore::Swizzle;

constexpr int kMinLog2 = 7;    // n1, n2 >= 128
constexpr int kMaxLog2 = 14;   // n1, n2 <= 16384

// Pass A's CTA: COLS adjacent columns of one row, as many as make
// kCtaThreads threads and at least 4, but no more than 1024 threads hold
// (2 at n1 = 8192, 1 at 16384).
template <int LOG2N1>
struct ColPlan {
    static constexpr int G = Plan<LOG2N1>::GROUP;
    static constexpr int WANT = repro::regfft::kCtaThreads / G > 4
                                    ? repro::regfft::kCtaThreads / G : 4;
    static constexpr int COLS = WANT * G > 1024 ? 1024 / G : WANT;
    static constexpr int LOG2COLS = COLS >= 32 ? 5 : COLS == 16 ? 4 : COLS == 8 ? 3
                                  : COLS == 4 ? 2 : COLS == 2 ? 1 : 0;
    static constexpr int THREADS = COLS * G;
    static constexpr int MIN_BLOCKS = 65536 / (THREADS * 64);
    static_assert(COLS == 1 << LOG2COLS, "a power-of-two column count");
};

// 2^e as a float, exact for -126 <= e <= 127.
__device__ __forceinline__ float exp2i(int e) { return __int_as_float((127 + e) << 23); }

// w_n^m = exp(sign*2*pi*i*m/n), n = 2^log2n <= 2^28, 0 <= m < n.
template <bool INV>
__device__ __forceinline__ float2 twiddle(long long m, int log2n) {
    constexpr float sign = INV ? 1.0f : -1.0f;
    const int mh = (int)(m >> 14), ml = (int)(m & 16383);
    float sh, ch, sl, cl;
    sincospif((float)mh * exp2i(15 - log2n), &sh, &ch);
    sincospif((float)ml * exp2i(1 - log2n), &sl, &cl);
    return cmul(make_float2(ch, sign * sh), make_float2(cl, sign * sl));
}

// Pass A.  blockIdx.x = s * (n2 / COLS) + g: columns g*COLS ... g*COLS +
// COLS - 1 of signal row s; thread t of column c (threadIdx.x = c*G + t)
// holds A[t + k*G][j2], k < 16.
template <int LOG2N1, bool INV>
__global__ void __launch_bounds__(ColPlan<LOG2N1>::THREADS, ColPlan<LOG2N1>::MIN_BLOCKS)
columns_kernel(const float2* __restrict__ in, float2* __restrict__ scratch, int log2n2) {
    using P = Plan<LOG2N1>;
    using CP = ColPlan<LOG2N1>;
    constexpr int N1 = P::N, R = P::POINTS, G = P::GROUP;
    extern __shared__ float2 smem[];
    const int t = threadIdx.x % G;
    const int c = threadIdx.x / G;
    const int log2n = LOG2N1 + log2n2;
    const int log2groups = log2n2 - CP::LOG2COLS;
    const long long s = (long long)blockIdx.x >> log2groups;
    const long long j2 = (((long long)blockIdx.x & ((1LL << log2groups) - 1)) << CP::LOG2COLS) + c;
    const long long first = (s << log2n) + ((long long)t << log2n2) + j2;

    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = in[first + ((long long)(k * G) << log2n2)];

    repro::regfft::fft_row<LOG2N1, INV>(v, smem, c * N1, t);

    // v[k] = Y[k1][j2], k1 = t + k*G: times w_n^(k1*j2), stored as B[k1][j2].
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const long long k1 = t + k * G;
        scratch[first + ((long long)(k * G) << log2n2)] =
            cmul(v[k], twiddle<INV>(k1 * j2, log2n));
    }
}

// Pass B: K2's kernel (fft_rows_transpose.cu) over the rows*n1 rows of B,
// each of length n2, with the batched transposed store: row R = s*n1 + k1
// and bin k2 go to out[s*n + k2*n1 + k1].
template <int LOG2N2, bool INV>
__global__ void __launch_bounds__(Plan<LOG2N2>::MAX_THREADS, Plan<LOG2N2>::MIN_BLOCKS)
rows_transpose_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                      long long rows, int log2_rows, int log2n1) {
    using P = Plan<LOG2N2>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP;
    constexpr int C = repro::tstore::store_cluster<LOG2N2, 8>(4);
    constexpr int LOG2C = C == 4 ? 2 : C == 2 ? 1 : 0;
    static_assert(C == 1 << LOG2C, "a cluster of 1, 2 or 4 CTAs");
    constexpr int S = N / C;
    extern __shared__ float2 smem[];
    const int t = threadIdx.x % G;
    const int local = threadIdx.x / G;
    const long long row = ((long long)blockIdx.x << log2_rows) + local;
    const bool has_row = row < rows;
    const float2* x = in + (has_row ? row : 0) * N + t;

    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = has_row ? x[k * G] : make_float2(0.0f, 0.0f);

    repro::regfft::fft_row<LOG2N2, INV>(v, smem, local * N, t);
    const Swizzle<LOG2N2> slot(log2_rows);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int c = 0; c < R; ++c) smem[slot(((t + c * G) << log2_rows) + local)] = v[c];

    const int log2w = log2_rows + LOG2C;
    const int qmask = (1 << log2w) - 1, pmask = (1 << log2_rows) - 1;
    int rank = 0;
    if constexpr (C == 1) {
        __syncthreads();
    } else {
        cg::this_cluster().sync();  // every CTA's rows are in its buffer
        rank = (int)cg::this_cluster().block_rank();
    }
    const long long row0 = ((long long)blockIdx.x - rank) << log2_rows;
    float2 z[R];
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int idx = threadIdx.x + c * blockDim.x;
        const int q = idx & qmask;
        const int k = rank * S + (idx >> log2w);
        const float2* buf = smem;
        if constexpr (C > 1) buf = cg::this_cluster().map_shared_rank(smem, q >> log2_rows);
        z[c] = buf[slot((k << log2_rows) + (q & pmask))];
    }
    const long long n1mask = (1LL << log2n1) - 1;
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int idx = threadIdx.x + c * blockDim.x;
        const long long r = row0 + (idx & qmask);
        const long long k = rank * S + (idx >> log2w);
        if (r < rows)
            out[((r >> log2n1) << (log2n1 + LOG2N2)) + (k << log2n1) + (r & n1mask)] = z[c];
    }
    if constexpr (C > 1) {
        cg::this_cluster().sync();  // no CTA leaves while another still reads its buffer
    }
}

template <int LOG2N1, bool INV>
int launch_columns(const void* in, void* scratch, long long rows, int log2n2,
                   cudaStream_t stream) {
    using CP = ColPlan<LOG2N1>;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(CP::COLS, 1 << LOG2N1);
    int err = repro::allow_dynamic_smem(columns_kernel<LOG2N1, INV>, &configured_smem,
                                        (int)smem);
    if (err != 0) return err;
    const long long blocks = rows << (log2n2 - CP::LOG2COLS);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    columns_kernel<LOG2N1, INV><<<(unsigned)blocks, CP::THREADS, (size_t)smem, stream>>>(
        (const float2*)in, (float2*)scratch, log2n2);
    return (int)cudaGetLastError();
}

template <int LOG2N2, bool INV>
int launch_rows(const void* scratch, void* out, long long rows, int log2n1,
                int rows_per_cta, int threads, cudaStream_t stream) {
    using P = Plan<LOG2N2>;
    if (rows_per_cta < 1 || rows_per_cta > P::MAX_ROWS ||
        (rows_per_cta & (rows_per_cta - 1)) || threads != rows_per_cta * P::GROUP)
        return (int)cudaErrorInvalidValue;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(rows_per_cta, P::N);
    int err = repro::allow_dynamic_smem(rows_transpose_kernel<LOG2N2, INV>,
                                        &configured_smem, (int)smem);
    if (err != 0) return err;
    int log2_rows = 0;
    while ((1 << log2_rows) < rows_per_cta) ++log2_rows;
    static int active_clusters = 0;
    const long long brows = rows << log2n1;
    const long long ctas = (brows + rows_per_cta - 1) / rows_per_cta;
    return repro::tstore::launch<repro::tstore::store_cluster<LOG2N2, 8>(4)>(
        rows_transpose_kernel<LOG2N2, INV>, ctas, threads, smem, stream,
        &active_clusters, (const float2*)scratch, (float2*)out, brows, log2_rows, log2n1);
}

// The instantiation for one (log2 n1 | log2 n2) in one direction: E is
// the log2 of the factor, dispatched at run time from kMinLog2 to kMaxLog2.
template <bool INV, int E = kMinLog2>
int columns_for(int log2n1, const void* in, void* scratch, long long rows, int log2n2,
                cudaStream_t stream) {
    if (log2n1 == E) return launch_columns<E, INV>(in, scratch, rows, log2n2, stream);
    if constexpr (E < kMaxLog2)
        return columns_for<INV, E + 1>(log2n1, in, scratch, rows, log2n2, stream);
    return (int)cudaErrorInvalidValue;
}

template <bool INV, int E = kMinLog2>
int rows_for(int log2n2, const void* scratch, void* out, long long rows, int log2n1,
             int rows_per_cta, int threads, cudaStream_t stream) {
    if (log2n2 == E)
        return launch_rows<E, INV>(scratch, out, rows, log2n1, rows_per_cta, threads, stream);
    if constexpr (E < kMaxLog2)
        return rows_for<INV, E + 1>(log2n2, scratch, out, rows, log2n1, rows_per_cta,
                                    threads, stream);
    return (int)cudaErrorInvalidValue;
}

int log2_of(int n) {
    int e = 0;
    while ((1 << e) < n) ++e;
    return (1 << e) == n ? e : -1;
}

}  // namespace

// Launches pass A and then pass B on `stream` (two kernel launches) and does
// not synchronise.  Returns a CUDA error code (0 = both launched).  `in` and
// `out` are distinct (rows, n1*n2) complex64 buffers, `scratch` one of at
// least as many elements, distinct from both; n1 and n2 powers of two in
// [128, 16384]; `rows_per_cta` and `threads` pass B's shape,
// kernels/fft/kernel.py::complex_rows_plan(n2, rows*n1).
extern "C" int repro_fft_rows_large(const void* in, void* out, void* scratch, long long rows,
                                    int n1, int n2, int inverse, int rows_per_cta,
                                    int threads, void* stream) {
    if (rows <= 0) return 0;
    const int log2n1 = log2_of(n1), log2n2 = log2_of(n2);
    if (log2n1 < kMinLog2 || log2n1 > kMaxLog2 || log2n2 < kMinLog2 || log2n2 > kMaxLog2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    int err = inverse ? columns_for<true>(log2n1, in, scratch, rows, log2n2, s)
                      : columns_for<false>(log2n1, in, scratch, rows, log2n2, s);
    if (err != 0) return err;
    return inverse ? rows_for<true>(log2n2, scratch, out, rows, log2n1, rows_per_cta,
                                    threads, s)
                   : rows_for<false>(log2n2, scratch, out, rows, log2n1, rows_per_cta,
                                     threads, s);
}
