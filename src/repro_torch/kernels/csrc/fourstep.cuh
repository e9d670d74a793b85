// The passes of the four-step row kernels for Hopper (sm_90a), rows of
// power-of-two length n = n1*n2, 32768 <= n <= 2^28, too long for one CTA's
// registers: K1b (fft_rows_large.cu), K2b (fft_rows_transpose_large.cu), K3b
// (rfft_rows_large.cu) and K4b (rfft_rows_transpose_large.cu).
//
// Signal row s viewed as A[j1][j2] = x[j1*n2 + j2] (n1, n2 powers of two in
// [128, 16384], the split of kernels/fft/large.py::large_split) gives
//   X[k1 + n1*k2] = sum_j2 w_n2^(j2*k2) * w_n^(k1*j2) * sum_j1 w_n1^(j1*k1) * A[j1][j2].
// - Pass A (columns_kernel): the length-n1 DFT of each column j2, times the
//   twiddle w_n^(k1*j2), written as B[k1][j2] of row s to a scratch buffer in
//   [s][k1][j2] order, where it was loaded (kBatchMajor: K1b), or in
//   [k1][s][j2] order with cap rows a k1, cap a power of two >= the rows of
//   the call (kTransposedStore: K2b).  A CTA takes COLS adjacent columns of
//   one row (at least 4 where they fit, so the CTA reads whole 32-byte
//   sectors of every row of the view), column c by the GROUP threads of
//   regfft.cuh's plan for n1, each holding 16 points in registers.  kPacked
//   (K3b, K4b) reads two float32 rows 2s and 2s + 1 as z = a + i*b instead
//   of a complex64 row (b = 0 for an unpaired last row) and stores as
//   kBatchMajor; its loads of 4 adjacent columns are half sectors.
// - Pass B (rows_transpose_kernel): the length-n2 DFT of each row of B, K2's
//   function (fft_rows_transpose.cu) with its launch shape, swizzled buffer
//   and cluster store (regfft.cuh, tstore.cuh), over every row of the call at
//   once.  Only the output index differs.  Batch-major (K1b, K3b, K4b): row
//   R = s*n1 + k1 and bin k2 go to out[s*n + k2*n1 + k1].  TRANSPOSED (K2b):
//   R = k1*cap + s goes to out[(k1 + n1*k2)*out_stride + s], so the rows
//   side by side in a store are neighbouring output columns, as in K2; rows
//   with s >= the call's rows are masked.
// - Pass C (split_kernel, K3b and K4b): the conjugate split of each packed
//   pair's Z, A[k] = (Z[k] + conj Z[(n-k) mod n]) / 2 and
//   B[k] = (Z[k] - conj Z[(n-k) mod n]) / (2i), k <= n/2, read from a second
//   scratch buffer in which pass B left Z in natural order (Z[k] and
//   Z[(n-k) mod n] are both contiguous runs, one reversed).  Stored as rows
//   2p and 2p + 1 of (rows, n/2 + 1), or TRANSPOSED (K4b) as columns of
//   (n/2 + 1, rows) through a shared-memory tile of kTilePairs pairs x
//   kTileBins bins, so that each warp writes 256 contiguous bytes of one
//   output row.
// - The inverse conjugates the twiddles; fft_row<.., true> scales by 1/n1 in
//   pass A and 1/n2 in pass B, powers of two whose product is 1/n exactly.
//
// Twiddle: m = k1*j2 < n is an exact integer, but 2m/n is exact in float only
// while n <= 2^24.  So m = mh*2^14 + ml and w^m = w^(mh*2^14) * w^ml, two
// sincospif of the exact arguments mh*2^15/n and 2*ml/n (mh, ml < 2^14, n a
// power of two), each good to about an ulp.  No __sincosf, no table and no
// -use_fast_math, for regfft.cuh's reasons.
//
// Everything here has internal linkage: each kernel source that includes it
// gets its own instantiations (the library is built without -rdc).

#pragma once

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

// Pass A's load and store (MODE).
constexpr int kBatchMajor = 0;        // complex64 rows; B stored as [s][k1][j2]
constexpr int kTransposedStore = 1;   // complex64 rows; B stored as [k1][s][j2]
constexpr int kPacked = 2;            // float32 row pairs; B stored as [s][k1][j2]

// Pass A.  blockIdx.x = s * (n2 / COLS) + g: columns g*COLS ... g*COLS +
// COLS - 1 of signal row s (kPacked: real rows 2s and 2s + 1 of
// `real_rows`); thread t of column c (threadIdx.x = c*G + t) holds
// A[t + k*G][j2], k < 16.  kTransposedStore keeps 2^log2cap rows a k1.
template <int LOG2N1, bool INV, int MODE>
__global__ void __launch_bounds__(ColPlan<LOG2N1>::THREADS, ColPlan<LOG2N1>::MIN_BLOCKS)
columns_kernel(const void* __restrict__ in, float2* __restrict__ scratch, int log2n2,
               int log2cap, long long real_rows) {
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
    const long long at = ((long long)t << log2n2) + j2;   // A[t][j2] within a row

    float2 v[R];
    if constexpr (MODE == kPacked) {
        const float* a = static_cast<const float*>(in) + (2 * s << log2n) + at;
        const float* b = a + (1LL << log2n);
        const bool has_b = 2 * s + 1 < real_rows;
        float re[R], im[R];
#pragma unroll
        for (int k = 0; k < R; ++k) re[k] = a[(long long)(k * G) << log2n2];
#pragma unroll
        for (int k = 0; k < R; ++k) im[k] = has_b ? b[(long long)(k * G) << log2n2] : 0.0f;
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = make_float2(re[k], im[k]);
    } else {
        const float2* x = static_cast<const float2*>(in) + (s << log2n) + at;
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = x[(long long)(k * G) << log2n2];
    }

    repro::regfft::fft_row<LOG2N1, INV>(v, smem, c * N1, t);

    // v[k] = Y[k1][j2], k1 = t + k*G: times w_n^(k1*j2), stored as B[k1][j2]
    // of row s: where A[k1][j2] was, or at (k1*cap + s)*n2 + j2.
    const int log2k = MODE == kTransposedStore ? log2cap + log2n2 : log2n2;
    float2* dst = MODE == kTransposedStore
        ? scratch + (s << log2n2) + ((long long)t << log2k) + j2
        : scratch + (s << log2n) + at;
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const long long k1 = t + k * G;
        dst[(long long)(k * G) << log2k] = cmul(v[k], twiddle<INV>(k1 * j2, log2n));
    }
}

// Pass B: K2's kernel (fft_rows_transpose.cu) over the `rows` rows of B,
// each of length n2.  Batch-major (T false): row R = s*n1 + k1 and bin k2
// go to out[s*n + k2*n1 + k1].  TRANSPOSED: R = k1*cap + s (cap =
// 2^log2cap) goes to out[(k1 + n1*k2)*out_stride + s] where s < valid, and
// rows with s >= valid load zeros and store nothing.
template <int LOG2N2, bool INV, bool T>
__global__ void __launch_bounds__(Plan<LOG2N2>::MAX_THREADS, Plan<LOG2N2>::MIN_BLOCKS)
rows_transpose_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                      long long rows, int log2_rows, int log2n1, int log2cap,
                      long long valid, long long out_stride) {
    using P = Plan<LOG2N2>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP;
    constexpr int C = repro::tstore::store_cluster<LOG2N2, 8>(4);
    constexpr int LOG2C = C == 4 ? 2 : C == 2 ? 1 : 0;
    static_assert(C == 1 << LOG2C, "a cluster of 1, 2 or 4 CTAs");
    constexpr int S = N / C;
    extern __shared__ float2 smem[];
    const long long capmask = (1LL << log2cap) - 1;
    const int t = threadIdx.x % G;
    const int local = threadIdx.x / G;
    const long long row = ((long long)blockIdx.x << log2_rows) + local;
    const bool has_row = row < rows && (!T || (row & capmask) < valid);
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
        if constexpr (T) {
            if (r < rows && (r & capmask) < valid)
                out[((r >> log2cap) + (k << log2n1)) * out_stride + (r & capmask)] = z[c];
        } else {
            if (r < rows)
                out[((r >> log2n1) << (log2n1 + LOG2N2)) + (k << log2n1) + (r & n1mask)] = z[c];
        }
    }
    if constexpr (C > 1) {
        cg::this_cluster().sync();  // no CTA leaves while another still reads its buffer
    }
}

// Pass C's CTA, and the tile of its transposed store.
constexpr int kSplitThreads = 256;
constexpr int kTilePairs = 16;                 // 32 output columns: 256 bytes a row
constexpr int kTileBins = 32;
constexpr int kTileStride = 2 * kTilePairs + 1;  // float2 a tile row, padded

// The split of bin k from zk = Z[k] and zr = Z[(n-k) mod n].
__device__ __forceinline__ float2 split_a(float2 zk, float2 zr) {
    return make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
}
__device__ __forceinline__ float2 split_b(float2 zk, float2 zr) {
    return make_float2(0.5f * (zk.y + zr.y), 0.5f * (zr.x - zk.x));
}

// Pass C over the (rows + 1) / 2 pairs of Z (pair p at z + p*n).  Row-major
// (T false): blockIdx.x = p * ceil(nh / 256) + tile, thread k - tile*256
// stores out[2p*out_stride + k] and out[(2p + 1)*out_stride + k].
// TRANSPOSED: blockIdx.x = pt * ceil(nh / kTileBins) + kt, the tile of pairs
// pt*kTilePairs ... and bins kt*kTileBins ...: each thread splits two
// (pair, bin) points into the tile (a warp reads 32 consecutive bins of one
// pair, both ways), then stores four of its elements, a warp one tile row:
// out[k*out_stride + c] for real rows c of the tile.
template <bool T>
__global__ void __launch_bounds__(kSplitThreads)
split_kernel(const float2* __restrict__ z, float2* __restrict__ out, long long rows,
             int log2n, long long out_stride) {
    const long long n = 1LL << log2n, nh = n / 2 + 1;
    if constexpr (!T) {
        const long long tiles = (nh + kSplitThreads - 1) / kSplitThreads;
        const long long p = blockIdx.x / tiles;
        const long long k = (blockIdx.x % tiles) * kSplitThreads + threadIdx.x;
        if (k >= nh) return;
        const float2* zp = z + (p << log2n);
        const float2 zk = zp[k], zr = zp[(n - k) & (n - 1)];
        out[2 * p * out_stride + k] = split_a(zk, zr);
        if (2 * p + 1 < rows) out[(2 * p + 1) * out_stride + k] = split_b(zk, zr);
    } else {
        __shared__ float2 tile[kTileBins * kTileStride];
        const long long tiles = (nh + kTileBins - 1) / kTileBins;
        const long long p0 = blockIdx.x / tiles * kTilePairs;
        const long long k0 = blockIdx.x % tiles * kTileBins;
#pragma unroll
        for (int j = 0; j < kTilePairs * kTileBins / kSplitThreads; ++j) {
            const int i = threadIdx.x + j * kSplitThreads;
            const int pp = i / kTileBins, kk = i % kTileBins;
            const long long p = p0 + pp, k = k0 + kk;
            if (2 * p < rows && k < nh) {
                const float2* zp = z + (p << log2n);
                const float2 zk = zp[k], zr = zp[(n - k) & (n - 1)];
                tile[kk * kTileStride + 2 * pp] = split_a(zk, zr);
                tile[kk * kTileStride + 2 * pp + 1] = split_b(zk, zr);
            }
        }
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 2 * kTilePairs * kTileBins / kSplitThreads; ++j) {
            const int i = threadIdx.x + j * kSplitThreads;
            const int kk = i / (2 * kTilePairs), col = i % (2 * kTilePairs);
            const long long k = k0 + kk, c = 2 * p0 + col;
            if (k < nh && c < rows) out[k * out_stride + c] = tile[kk * kTileStride + col];
        }
    }
}

template <int LOG2N1, bool INV, int MODE>
int launch_columns(const void* in, void* scratch, long long rows, int log2n2, int log2cap,
                   long long real_rows, cudaStream_t stream) {
    using CP = ColPlan<LOG2N1>;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(CP::COLS, 1 << LOG2N1);
    int err = repro::allow_dynamic_smem(columns_kernel<LOG2N1, INV, MODE>,
                                        &configured_smem, (int)smem);
    if (err != 0) return err;
    const long long blocks = rows << (log2n2 - CP::LOG2COLS);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    columns_kernel<LOG2N1, INV, MODE><<<(unsigned)blocks, CP::THREADS, (size_t)smem, stream>>>(
        in, (float2*)scratch, log2n2, log2cap, real_rows);
    return (int)cudaGetLastError();
}

template <int LOG2N2, bool INV, bool T>
int launch_rows(const void* scratch, void* out, long long rows, int log2n1, int log2cap,
                long long valid, long long out_stride, int rows_per_cta, int threads,
                cudaStream_t stream) {
    using P = Plan<LOG2N2>;
    if (rows_per_cta < 1 || rows_per_cta > P::MAX_ROWS ||
        (rows_per_cta & (rows_per_cta - 1)) || threads != rows_per_cta * P::GROUP)
        return (int)cudaErrorInvalidValue;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(rows_per_cta, P::N);
    int err = repro::allow_dynamic_smem(rows_transpose_kernel<LOG2N2, INV, T>,
                                        &configured_smem, (int)smem);
    if (err != 0) return err;
    int log2_rows = 0;
    while ((1 << log2_rows) < rows_per_cta) ++log2_rows;
    static int active_clusters = 0;
    const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
    return repro::tstore::launch<repro::tstore::store_cluster<LOG2N2, 8>(4)>(
        rows_transpose_kernel<LOG2N2, INV, T>, ctas, threads, smem, stream,
        &active_clusters, (const float2*)scratch, (float2*)out, rows, log2_rows, log2n1,
        log2cap, valid, out_stride);
}

// The instantiation for one (log2 n1 | log2 n2): E is the log2 of the factor,
// dispatched at run time from kMinLog2 to kMaxLog2.
template <bool INV, int MODE, int E = kMinLog2>
int columns_for(int log2n1, const void* in, void* scratch, long long rows, int log2n2,
                int log2cap, long long real_rows, cudaStream_t stream) {
    if (log2n1 == E)
        return launch_columns<E, INV, MODE>(in, scratch, rows, log2n2, log2cap, real_rows,
                                            stream);
    if constexpr (E < kMaxLog2)
        return columns_for<INV, MODE, E + 1>(log2n1, in, scratch, rows, log2n2, log2cap,
                                             real_rows, stream);
    return (int)cudaErrorInvalidValue;
}

template <bool INV, bool T, int E = kMinLog2>
int rows_for(int log2n2, const void* scratch, void* out, long long rows, int log2n1,
             int log2cap, long long valid, long long out_stride, int rows_per_cta,
             int threads, cudaStream_t stream) {
    if (log2n2 == E)
        return launch_rows<E, INV, T>(scratch, out, rows, log2n1, log2cap, valid, out_stride,
                                      rows_per_cta, threads, stream);
    if constexpr (E < kMaxLog2)
        return rows_for<INV, T, E + 1>(log2n2, scratch, out, rows, log2n1, log2cap, valid,
                                       out_stride, rows_per_cta, threads, stream);
    return (int)cudaErrorInvalidValue;
}

template <bool T>
int launch_split(const void* z, void* out, long long rows, int log2n, long long out_stride,
                 cudaStream_t stream) {
    const long long nh = (1LL << log2n) / 2 + 1;
    const long long pairs = (rows + 1) / 2;
    const long long blocks = T ? (pairs + kTilePairs - 1) / kTilePairs *
                                     ((nh + kTileBins - 1) / kTileBins)
                               : pairs * ((nh + kSplitThreads - 1) / kSplitThreads);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    split_kernel<T><<<(unsigned)blocks, kSplitThreads, 0, stream>>>(
        (const float2*)z, (float2*)out, rows, log2n, out_stride);
    return (int)cudaGetLastError();
}

int log2_of(long long n) {
    int e = 0;
    while ((1LL << e) < n) ++e;
    return (1LL << e) == n ? e : -1;
}

// Both factors in [kMinLog2, kMaxLog2]: their log2s, else -1.
bool factors_ok(int log2n1, int log2n2) {
    return log2n1 >= kMinLog2 && log2n1 <= kMaxLog2 && log2n2 >= kMinLog2 &&
           log2n2 <= kMaxLog2;
}

// Passes A, B and C of the packed real kernels (K3b: T false, K4b: T true)
// on `stream`: three launches.  `rows` real rows of n1*n2 float32 in `in`;
// `scratch` and `zbuf` hold (rows + 1) / 2 complex rows each; pass B's
// shape is kernels/fft/kernel.py::complex_rows_plan(n2, pairs*n1).
template <bool T>
int real_rows_large(const void* in, void* out, void* scratch, void* zbuf, long long rows,
                    int n1, int n2, long long out_stride, int rows_per_cta, int threads,
                    void* stream) {
    if (rows <= 0) return 0;
    const int log2n1 = log2_of(n1), log2n2 = log2_of(n2);
    if (!factors_ok(log2n1, log2n2)) return (int)cudaErrorInvalidValue;
    const long long pairs = (rows + 1) / 2;
    cudaStream_t s = (cudaStream_t)stream;
    int err = columns_for<false, kPacked>(log2n1, in, scratch, pairs, log2n2, 0, rows, s);
    if (err != 0) return err;
    err = rows_for<false, false>(log2n2, scratch, zbuf, pairs << log2n1, log2n1, 0, 0, 0,
                                 rows_per_cta, threads, s);
    if (err != 0) return err;
    return launch_split<T>(zbuf, out, rows, log2n1 + log2n2, out_stride, s);
}

}  // namespace
