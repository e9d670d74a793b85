// The passes of the four-step row kernels for Hopper (sm_90a), rows of
// power-of-two length n = n1*n2, 32768 <= n <= 2^28, too long for one CTA's
// registers: K1b (fft_rows_large.cu, n >= 2^19: below, fft_rows_cluster.cu
// runs it in one pass), K2b (fft_rows_transpose_large.cu), K3b
// (rfft_rows_large.cu) and K4b (rfft_rows_transpose_large.cu).
//
// Signal row s viewed as A[j1][j2] = x[j1*n2 + j2] (n1, n2 powers of two in
// [128, 16384], the split of kernels/fft/large.py::large_split) gives
//   X[k1 + n1*k2] = sum_j2 w_n2^(j2*k2) * w_n^(k1*j2) * sum_j1 w_n1^(j1*k1) * A[j1][j2].
// - Pass A: the length-n1 DFT of each column j2, times the twiddle
//   w_n^(k1*j2), written as B[k1][j2] of row s to a scratch buffer in
//   [s][k1][j2] order, where it was loaded (kBatchMajor: K1b), or in
//   [k1][s][j2] order with cap rows a k1, cap a power of two >= the rows of
//   the call (kTransposedStore: K2b).  complex_columns_kernel (K1b, K2b): a
//   CTA takes COLS adjacent columns of one row (ColPlan: 32 up to n1 = 512,
//   as many as 1024 threads hold above), n1/16 threads a column with 16
//   points each, the columns fastest (thread t*COLS + c), so a warp loads and
//   stores COLS adjacent j2 of 32/COLS rows of the view: 256 contiguous
//   bytes at COLS = 32, whole sectors down to COLS = 4 (n1 <= 4096).  The
//   column DFTs run regfft's passes with the columns interleaved in the
//   exchange buffer (column_fft, shared with fourstep_cluster.cuh), the
//   twiddles come from five base values a thread and running products
//   (column_twiddles).  columns_kernel (K3b: kPacked, K4b:
//   kPackedTransposed) reads two float32 rows 2s and 2s + 1 as z = a + i*b
//   instead of a complex64 row (b = 0 for an unpaired last row), column c
//   by the n1/16 threads c*G ... (the rows of a column fastest,
//   PackedColPlan: at least 4 columns a CTA), a twiddle<INV> a point, and
//   stores as kBatchMajor and kTransposedStore; its loads of 4 adjacent
//   columns are half sectors.
// - Pass B (rows_transpose_kernel, K1b and K2b): the length-n2 DFT of each
//   row of B, K2's function (fft_rows_transpose.cu) with its CTA, swizzled
//   buffer and cluster store (regfft.cuh, tstore.cuh), over every row of the
//   call at once, in wider CTAs, so that a store puts at least kStoreRows =
//   16 rows side by side (RowsPlan: 16 rows a CTA up to n2 = 1024, 32 at
//   128, and clusters of 2 ... 16 CTAs at n2 = 2048 ... 16384, where 1024
//   threads hold fewer).  Only the output index differs from K2's.  Batch-major (K1b): row R =
//   s*n1 + k1 and bin k2 go to out[s*n + k2*n1 + k1], runs of 16 k1 or more
//   (128 bytes).  TRANSPOSED (K2b): R = k1*cap + s goes to out[(k1 +
//   n1*k2)*out_stride + s], so the rows side by side in a store are
//   neighbouring output columns, as in K2; rows with s >= the call's rows
//   are masked.
// - Pass B of the packed real kernels (rows_split_kernel, K3b and K4b): the
//   same DFTs over the rows of the packed pairs' B, Z[p][k1 + n1*k2] in
//   row k1, bin k2, and in its epilogue the conjugate split of each pair,
//   A[k] = (Z[k] + conj Z[(n-k) mod n]) / 2 and B[k] = (Z[k] - conj
//   Z[(n-k) mod n]) / (2i) for k <= n/2, stored straight to the output.
//   The index facts it rests on (tests/_torch_parity.py::real_pass_b_model
//   checks them in float64):
//   * k1 != 0: (n - k) mod n = (n1 - k1) + n1*(n2 - 1 - k2), row n1 - k1,
//     bin n2 - 1 - k2.  k1 = 0: row 0 itself, bin (n2 - k2) mod n2.  Row
//     n1/2 is its own partner too, at bin n2 - 1 - k2.
//   * The half spectrum k <= n/2 is bins k2 < n2/2 of every row, plus bin
//     n2/2 of row 0 (k = n/2, its own partner).
//   * So rows (sigma, n1 - sigma) form slot sigma = 1 ... n1/2 - 1, and rows
//     0 and n1/2 share slot 0, each split against itself: n1/2 slots of two
//     rows.  From its two rows a slot writes A and B for the first half of
//     both rows' bins, each output element once; the second halves are read
//     only as partners.
//   A cluster of C CTAs (C = 1: a CTA alone) holds W = rows_per_cta*C rows
//   (SplitPlan: up to 32 rows a CTA where n2 <= 1024, C = 1; one or two a
//   CTA in clusters of 4 or 2 above),
//   W/2 slot units: unit u is (pair p, slot sigma), u = p*(n1/2) + sigma in
//   K3b (its [p][k1][j2] scratch gives consecutive sigma of one pair) and
//   u = sigma*cap + p in K4b (its [k1][p][j2] scratch gives consecutive
//   pairs of one slot).  Cluster row q < W/2 is the left row of unit
//   u0 + q, q >= W/2 the right row of unit u0 + q - W/2; q's partner row is
//   q ^ (W/2), or q itself in slot 0.  Where a CTA holds one row (n2 >=
//   4096, one CTA of 1024 threads at n2 = 16384) the partner sits in another
//   CTA of the cluster and is read through distributed shared memory
//   (map_shared_rank).  The store: item (q, k2), k2 < n2/2, q fastest,
//   writes A to out[2p][k] and B to out[2p + 1][k] (K3b: W/2 neighbouring
//   k1 of one row side by side, the left ones rising, the right ones
//   falling), or out[k][2p] and out[k][2p + 1] (K4b: W/2 neighbouring pairs
//   side by side, a float4 each where the output allows); B is not stored
//   for an unpaired last row.
// - The inverse conjugates the twiddles; fft_row<.., true> scales by 1/n1 in
//   pass A and 1/n2 in pass B, powers of two whose product is 1/n exactly.
//
// Bytes.  K1b and K2b move each row twice (in -> scratch -> out), each
// pass near the speed of a copy at n1 <= 1024 and n2 <= 512, the splits
// kernels/fft/large.py::two_pass_split takes up to 2^20; pass A's column
// reads were the cost before its columns went fastest (regfft's column
// layout: a warp one column of 32 rows, 8 bytes of each of 32 sectors).  The
// packed real kernels read rows*n*4 bytes, write pairs*n*8 of scratch, read
// them back and write rows*(n/2 + 1)*8: two passes over the data, about
// twice what the function must move (at 2048 x 32768: 1 GiB against 512
// MiB).  K3b's output rows are n/2 + 1 complex64 apart, an odd stride in
// float2, so rows 2p and 2p + 1 never start on the same offset in a 32-byte
// sector: the runs of W/2 elements of one store cannot all be whole sectors,
// whatever k1 a run starts at, and only longer runs (more rows a CTA) make
// the partial sectors at their ends a smaller share (0.84 of the sectors
// full at W = 32, 0.73 at 16; tests/test_torch_fused_large.py).  K4b's runs
// are whole sectors where the output's row stride is even.
//
// Twiddle: m = k1*j2 < n is an exact integer, but 2m/n is exact in float only
// while n <= 2^24.  So m = mh*2^14 + ml and w^m = w^(mh*2^14) * w^ml, two
// sincospif of the exact arguments mh*2^15/n and 2*ml/n (mh, ml < 2^14, n a
// power of two), each good to about an ulp (twiddle<INV>).  Pass A of the
// complex modes takes it for five base values a thread and multiplies the
// rest out (column_twiddles<INV, true>: 10 sincospif for 16 points, within
// 10 ulps); the packed pass A takes it for every point.  No __sincosf, no
// table and no -use_fast_math, for regfft.cuh's reasons.
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

// Pass A's CTA in the packed modes (K3b, K4b): COLS adjacent columns of one
// row, as many as make kCtaThreads threads and at least 4, but no more than
// 1024 threads hold (2 at n1 = 8192, 1 at 16384).
template <int LOG2N1>
struct PackedColPlan {
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

// Pass A's CTA in the complex modes (K1b, K2b): COLS = kColumns adjacent
// columns of one row where kColumns * n1/16 threads fit in 1024 (n1 <= 512),
// else as many as 1024 threads hold (16 at n1 = 1024 ... 1 at 16384).  With
// the columns fastest in the CTA a warp loads and stores 32 adjacent j2 of
// one row of the view, 256 contiguous bytes, where COLS = 32.
constexpr int kColumns = 32;
template <int LOG2N1>
struct ColPlan {
    static constexpr int G = Plan<LOG2N1>::GROUP;
    static constexpr int COLS = kColumns * G <= 1024 ? kColumns : 1024 / G;
    static constexpr int LOG2COLS = COLS >= 32 ? 5 : COLS == 16 ? 4 : COLS == 8 ? 3
                                  : COLS == 4 ? 2 : COLS == 2 ? 1 : 0;
    static constexpr int THREADS = COLS * G;
    static constexpr int MIN_BLOCKS = 65536 / (THREADS * 64);
    static_assert(COLS == 1 << LOG2COLS && COLS <= 32, "a power-of-two column count");
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

// Slot of element x = f*COLS + c of column_fft's buffer (element f of column
// c): x itself where a half-warp is 16 columns of one element (COLS >= 16),
// else x plus COLS slots of padding a block of 16*COLS, so that the 16/COLS
// elements a half-warp spans, 16*COLS slots apart in the first pass's
// writes, fall on distinct banks (t*COLS banks apart).  The padding is
// linear in the block: slot(a + d) = slot(a) + slot(d) where d is a
// multiple of 16*COLS or a + d stays in a's block, so the exchanges compute
// one slot a thread and add constants.  The buffer holds
// exchange_elems(COLS, N1) float2 either way.
template <int COLS>
__host__ __device__ constexpr int column_slot(int x) {
    if constexpr (COLS >= 16) {
        return x;
    } else {
        constexpr int LOG2COLS = COLS == 8 ? 3 : COLS == 4 ? 2 : COLS == 2 ? 1 : 0;
        return x + ((x >> (4 + LOG2COLS)) << LOG2COLS);
    }
}

// The length-N1 DFT down column c of COLS columns, regfft.cuh's
// radix16_passes and fft_row with the columns interleaved in the buffer:
// element f of column c at column_slot(f*COLS + c), so that a half-warp (16
// consecutive c of one t, or 16/COLS t of COLS columns each) reads and
// writes 16 consecutive slots, or 16 distinct banks.  (regfft's layout, rows
// side by side with a float2 of padding per 16, puts those 16 columns
// n1*17/16 slots apart: on 4, 2 or 1 of the 16 banks at n1 = 64, 128, 256.)
// In: v[k] = A[t + k*G][c].  Out: v[k] = Y[t + k*G][c], scaled by 1/N1 when
// INV.  The buffer holds exchange_elems(COLS, N1) float2.
template <int LOG2N1, int COLS, bool INV>
__device__ __forceinline__ void column_fft(float2 (&v)[16], float2* buf, int c, int t) {
    using P = Plan<LOG2N1>;
    constexpr int G = P::GROUP;
    static_assert(COLS >= 16 || G % 16 == 0, "the padded slots' reads: G*COLS whole blocks");
#pragma unroll
    for (int pass = 0; pass < P::RADIX16_PASSES; ++pass) {
        repro::regfft::dft16<INV>(v);
        if (pass == P::RADIX16_PASSES - 1 && P::TAIL_LOG2 == 0) break;
        const int log2s = 4 * pass;
        const int j = t >> log2s;
        const int q = t & ((1 << log2s) - 1);
        repro::regfft::twiddle16<INV>(v, j, LOG2N1 - log2s);
        // Slot u goes to element f0 + u*s: u*s*COLS stays in f0's block at
        // s = 1 and is a multiple of 16*COLS at s >= 16.
        const int p0 = column_slot<COLS>((((j << 4) << log2s) + q) * COLS + c);
        __syncthreads();  // the previous exchange's reads are done
#pragma unroll
        for (int u = 0; u < 16; ++u) buf[p0 + column_slot<COLS>((u << log2s) * COLS)] = v[u];
        __syncthreads();
        const int r0 = column_slot<COLS>(t * COLS + c);   // G*COLS: a multiple of 16*COLS
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = buf[r0 + column_slot<COLS>(k * G * COLS)];
    }
    if constexpr (P::TAIL_LOG2 > 0) {
        constexpr int r = 1 << P::TAIL_LOG2;
        constexpr int B = 16 / r;
#pragma unroll
        for (int b = 0; b < B; ++b) {
            float2 w[r];
#pragma unroll
            for (int u = 0; u < r; ++u) w[u] = v[b + u * B];
            repro::regfft::dft<r, INV>(w);
#pragma unroll
            for (int u = 0; u < r; ++u) v[b + u * B] = w[u];
        }
    }
    if constexpr (INV) {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = repro::cscale(v[k], 1.0f / (float)P::N);
    }
}

// v[k] *= w_n^(k1*j2), k1 = t + k*g, n = 2^log2n.  With k = 4*kh + kl:
// w^(k1*j2) = h_kh * b^kl, h_kh = w^((t + 4*kh*g)*j2) and b = w^(g*j2), five
// base values a thread, b^kl by running products: good to a few ulps, where
// twiddle<INV> would take two sincospif a point.  The base exponents are
// integers below n (t + 4*kh*g < n1, j2 < n2).  SPLIT: each base value is
// twiddle<INV>'s exact split (two sincospif), for n up to 2^28; else one
// sincospif of the argument 2m/n, exact in float only while n <= 2^24 (the
// cluster kernel's lengths).
template <bool INV, bool SPLIT = false>
__device__ __forceinline__ void column_twiddles(float2 (&v)[16], int t, int g, int j2,
                                                int log2n) {
    const float step = (INV ? 1.0f : -1.0f) * exp2i(1 - log2n);   // sign * 2/n
    auto base = [&](int m) {
        if constexpr (SPLIT) {
            return twiddle<INV>(m, log2n);
        } else {
            float sn, cs;
            sincospif((float)m * step, &sn, &cs);
            return make_float2(cs, sn);
        }
    };
    const float2 b = base(g * j2);
#pragma unroll
    for (int kh = 0; kh < 4; ++kh) {
        float2 w = base((t + 4 * kh * g) * j2);
#pragma unroll
        for (int kl = 0; kl < 4; ++kl) {
            v[4 * kh + kl] = cmul(v[4 * kh + kl], w);
            if (kl < 3) w = cmul(w, b);
        }
    }
}

// Pass A's load and store (MODE).
constexpr int kBatchMajor = 0;        // complex64 rows; B stored as [s][k1][j2]
constexpr int kTransposedStore = 1;   // complex64 rows; B stored as [k1][s][j2]
constexpr int kPacked = 2;            // float32 row pairs; B stored as [s][k1][j2]
constexpr int kPackedTransposed = 3;  // float32 row pairs; B stored as [k1][s][j2]

__host__ __device__ constexpr bool packed_load(int mode) {
    return mode == kPacked || mode == kPackedTransposed;
}
__host__ __device__ constexpr bool transposed_store(int mode) {
    return mode == kTransposedStore || mode == kPackedTransposed;
}

// Pass A of K1b (TS false: B stored as [s][k1][j2]) and K2b (TS: as
// [k1][s][j2], 2^log2cap rows a k1) on one tile b = s * (n2 / COLS) + g:
// columns j2 = g*COLS + c, c < COLS, of signal row s; thread t*COLS + c
// holds A[t + k*G][j2], k < 16, so a warp's load of step k is 32/COLS rows
// of the view, COLS adjacent j2 each (256 contiguous bytes at COLS = 32).
// The column DFTs in the interleaved buffer (column_fft), the twiddles from
// five base values a thread (column_twiddles, split), and the store as the
// load: COLS adjacent j2 of one row of B a warp, j2 fastest.  Offsets
// within a row of A (or the scratch of a chunk, at most 2^28 elements) are
// 32-bit; only the row's base is 64-bit.
template <int LOG2N1, bool INV, bool TS>
__device__ __forceinline__ void complex_columns_tile(const float2* __restrict__ in,
                                                     float2* __restrict__ scratch,
                                                     long long tile, int c, int t, int log2n2,
                                                     int log2cap, float2* smem) {
    using CP = ColPlan<LOG2N1>;
    constexpr int G = CP::G, COLS = CP::COLS;
    const int log2n = LOG2N1 + log2n2;
    const int log2groups = log2n2 - CP::LOG2COLS;
    const long long s = tile >> log2groups;
    const int j2 = (((int)tile & ((1 << log2groups) - 1)) << CP::LOG2COLS) + c;
    const float2* x = in + (s << log2n) + (t << log2n2) + j2;
    const int step = G << log2n2;
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = x[k * step];

    column_fft<LOG2N1, COLS, INV>(v, smem, c, t);
    column_twiddles<INV, true>(v, t, G, j2, log2n);

    // v[k] = B[k1][j2], k1 = t + k*G: to (s*n1 + k1)*n2 + j2, or to
    // (k1*cap + s)*n2 + j2.
    const int log2k = TS ? log2cap + log2n2 : log2n2;
    float2* dst = (TS ? scratch + (s << log2n2) : scratch + (s << log2n)) + (t << log2k) + j2;
    const int dstep = G << log2k;
#pragma unroll
    for (int k = 0; k < 16; ++k) dst[k * dstep] = v[k];
}

// Pass A's CTAs in the complex modes: one a tile (the rule), or, with
// kPersistentColumns, as many as the card holds at once walking the tiles
// with a stride, each prefetching its next tile into L2
// (cp.async.bulk.prefetch.L2) before transforming the current one (the
// Hopper form timed against the rule: examples/kernel_check_torch.py).
constexpr bool kPersistentColumns = false;

template <int LOG2N1, bool INV, bool TS>
__global__ void __launch_bounds__(ColPlan<LOG2N1>::THREADS, ColPlan<LOG2N1>::MIN_BLOCKS)
complex_columns_kernel(const float2* __restrict__ in, float2* __restrict__ scratch,
                       long long tiles, int log2n2, int log2cap) {
    using CP = ColPlan<LOG2N1>;
    constexpr int N1 = 1 << LOG2N1, COLS = CP::COLS;
    extern __shared__ float2 smem[];
    const int c = threadIdx.x & (COLS - 1);
    const int t = threadIdx.x >> CP::LOG2COLS;
    if constexpr (!kPersistentColumns) {
        complex_columns_tile<LOG2N1, INV, TS>(in, scratch, blockIdx.x, c, t, log2n2, log2cap,
                                              smem);
    } else {
        const int log2groups = log2n2 - CP::LOG2COLS;
        const int gmask = (1 << log2groups) - 1;
        for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const long long next = tile + gridDim.x;
            if (COLS * 8 % 16 == 0 && next < tiles && threadIdx.x < N1) {
                const float2* row = in + ((next >> log2groups) << (LOG2N1 + log2n2)) +
                                    ((long long)threadIdx.x << log2n2) +
                                    (((int)next & gmask) << CP::LOG2COLS);
                if ((reinterpret_cast<unsigned long long>(row) & 15) == 0)
                    asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                                 :: "l"(row), "r"(COLS * 8) : "memory");
            }
            complex_columns_tile<LOG2N1, INV, TS>(in, scratch, tile, c, t, log2n2, log2cap,
                                                  smem);
        }
    }
}

// Pass A of the packed real kernels (K3b: MODE kPacked, K4b:
// kPackedTransposed).  blockIdx.x = s * (n2 / COLS) + g: columns g*COLS ...
// g*COLS + COLS - 1 of real rows 2s and 2s + 1 of `real_rows`, read as z =
// a + i*b; thread t of column c (threadIdx.x = c*G + t) holds A[t + k*G][j2],
// k < 16.  B is stored as K1b's (kPacked) or K2b's (kPackedTransposed,
// 2^log2cap rows a k1) pass A stores it.
template <int LOG2N1, bool INV, int MODE>
__global__ void __launch_bounds__(PackedColPlan<LOG2N1>::THREADS,
                                  PackedColPlan<LOG2N1>::MIN_BLOCKS)
columns_kernel(const void* __restrict__ in, float2* __restrict__ scratch, int log2n2,
               int log2cap, long long real_rows) {
    using P = Plan<LOG2N1>;
    using CP = PackedColPlan<LOG2N1>;
    constexpr int N1 = P::N, R = P::POINTS, G = P::GROUP;
    static_assert(packed_load(MODE), "the complex modes run complex_columns_kernel");
    extern __shared__ float2 smem[];
    const int t = threadIdx.x % G;
    const int c = threadIdx.x / G;
    const int log2n = LOG2N1 + log2n2;
    const int log2groups = log2n2 - CP::LOG2COLS;
    const long long s = (long long)blockIdx.x >> log2groups;
    const long long j2 = (((long long)blockIdx.x & ((1LL << log2groups) - 1)) << CP::LOG2COLS) + c;
    const long long at = ((long long)t << log2n2) + j2;   // A[t][j2] within a row

    float2 v[R];
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

    repro::regfft::fft_row<LOG2N1, INV>(v, smem, c * N1, t);

    // v[k] = Y[k1][j2], k1 = t + k*G: times w_n^(k1*j2), stored as B[k1][j2]
    // of row s: where A[k1][j2] was, or at (k1*cap + s)*n2 + j2.
    constexpr bool TS = transposed_store(MODE);
    const int log2k = TS ? log2cap + log2n2 : log2n2;
    float2* dst = TS
        ? scratch + (s << log2n2) + ((long long)t << log2k) + j2
        : scratch + (s << log2n) + at;
#pragma unroll
    for (int k = 0; k < R; ++k) {
        const long long k1 = t + k * G;
        dst[(long long)(k * G) << log2k] = cmul(v[k], twiddle<INV>(k1 * j2, log2n));
    }
}

// Pass B's CTA in the complex modes (rows_transpose_kernel): as many rows
// of B as make kStoreRows (16: runs of 128 bytes) within kRowsThreads
// threads, and at least K1's CTA (Plan<LOG2N2>::MAX_ROWS: 32 rows at n2 =
// 128); where fewer than kStoreRows fit (n2 >= 2048), C = kStoreRows /
// MAX_ROWS CTAs of a cluster (up to 16, non-portable) store their rows side
// by side, reading each other's buffers (tstore.cuh's cluster store).
constexpr int kStoreRows = 16;
constexpr int kRowsThreads = 1024;
template <int LOG2N2>
struct RowsPlan {
    using P = Plan<LOG2N2>;
    static constexpr int G = P::GROUP;
    static constexpr int FIT = kRowsThreads / G >= 1 ? kRowsThreads / G : 1;
    static constexpr int WIDE = kStoreRows < FIT ? kStoreRows : FIT;
    static constexpr int MAX_ROWS = P::MAX_ROWS > WIDE ? P::MAX_ROWS : WIDE;
    static constexpr int MAX_THREADS = MAX_ROWS * G;
    static constexpr int MIN_BLOCKS = 65536 / (MAX_THREADS * 64);
    static constexpr int C = MAX_ROWS >= kStoreRows ? 1
                           : kStoreRows / MAX_ROWS > 16 ? 16 : kStoreRows / MAX_ROWS;
    static constexpr int LOG2C = C == 16 ? 4 : C == 8 ? 3 : C == 4 ? 2 : C == 2 ? 1 : 0;
    static_assert(C == 1 << LOG2C && MAX_THREADS <= 1024, "a cluster of 1 to 16 CTAs");
};

// Pass B of K1b and K2b: K2's kernel (fft_rows_transpose.cu) over the
// `rows` rows of B, each of length n2, in RowsPlan's wider CTAs.
// Batch-major (T false): row R = s*n1 + k1 and bin k2 go to out[s*n + k2*n1
// + k1].  TRANSPOSED: R = k1*cap + s (cap = 2^log2cap) goes to out[(k1 +
// n1*k2)*out_stride + s] where s < valid, and rows with s >= valid load
// zeros and store nothing.  The W = C*rows_per_cta rows of a cluster (a CTA
// where C = 1) are stored side by side: a warp's store is 32/W runs of W*8
// bytes, or one of 256.
template <int LOG2N2, bool INV, bool T>
__global__ void __launch_bounds__(RowsPlan<LOG2N2>::MAX_THREADS, RowsPlan<LOG2N2>::MIN_BLOCKS)
rows_transpose_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                      long long rows, int log2_rows, int log2n1, int log2cap,
                      long long valid, long long out_stride) {
    using P = Plan<LOG2N2>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP;
    constexpr int C = RowsPlan<LOG2N2>::C, LOG2C = RowsPlan<LOG2N2>::LOG2C;
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

// Pass B's CTA in the real kernels: twice regfft's rows (at most 32, the
// lanes of a warp) where a CTA holds 4 rows or more (n2 <= 1024), so that a
// store writes runs of up to 16 elements; regfft's rows elsewhere, where the
// cluster gives the width.
template <int LOG2N2>
struct SplitPlan {
    using P = Plan<LOG2N2>;
    static constexpr int MAX_ROWS =
        P::MAX_ROWS >= 4 ? (2 * P::MAX_ROWS < 32 ? 2 * P::MAX_ROWS : 32) : P::MAX_ROWS;
    static constexpr int MAX_THREADS = MAX_ROWS * P::GROUP;
    static constexpr int MIN_BLOCKS = 65536 / (MAX_THREADS * 64);
};

// The split of bin k from zk = Z[k] and zr = Z[(n-k) mod n].
__device__ __forceinline__ float2 split_a(float2 zk, float2 zr) {
    return make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
}
__device__ __forceinline__ float2 split_b(float2 zk, float2 zr) {
    return make_float2(0.5f * (zk.y + zr.y), 0.5f * (zr.x - zk.x));
}

// A row of a slot unit u: its pair p, its slot sigma and its row k1 of pass
// B (left: k1 = sigma; right: the partner row n1 - sigma, or n1/2 in slot
// 0).  K3b's units (T false) run sigma fastest, u = p*(n1/2) + sigma; K4b's
// run p fastest, u = sigma*cap + p.
struct SlotRow {
    long long p;
    int sigma;
    int k1;
};

template <bool T>
__device__ __forceinline__ SlotRow slot_row(long long u, bool right, int log2n1,
                                            int log2cap) {
    SlotRow r;
    if constexpr (T) {
        r.sigma = (int)(u >> log2cap);
        r.p = u & ((1LL << log2cap) - 1);
    } else {
        r.sigma = (int)(u & ((1LL << (log2n1 - 1)) - 1));
        r.p = u >> (log2n1 - 1);
    }
    r.k1 = !right ? r.sigma : r.sigma == 0 ? 1 << (log2n1 - 1) : (1 << log2n1) - r.sigma;
    return r;
}

// Stores A and B of output bin k of pair p: K3b to rows 2p and 2p + 1 of a
// (rows, n/2 + 1) output, K4b to columns 2p and 2p + 1 of an (n/2 + 1,
// out_stride) one, as one float4 where `vec`; B not where 2p + 1 = rows.
template <bool T>
__device__ __forceinline__ void store_split(float2* out, long long p, long long k, float2 a,
                                            float2 b, long long rows, long long out_stride,
                                            bool vec) {
    const bool has_b = 2 * p + 1 < rows;
    if constexpr (T) {
        float2* o = out + k * out_stride + 2 * p;
        if (vec && has_b) {
            *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
        } else {
            o[0] = a;
            if (has_b) o[1] = b;
        }
    } else {
        out[2 * p * out_stride + k] = a;
        if (has_b) out[(2 * p + 1) * out_stride + k] = b;
    }
}

// Pass B of K3b (T false) and K4b (T true) with the slot split: cluster
// blockIdx.x >> LOG2C holds units u0 ... u0 + W/2 - 1 (W = 2^log2_rows * C
// rows); local row `local` of cluster rank r is cluster row q = r*2^log2_rows
// + local, loaded from scratch row p*n1 + k1 (K3b) or k1*cap + p (K4b), zeros
// where p >= pairs.  After the DFTs every row is in its CTA's swizzled
// buffer, bin k2 of row q at slot(k2*2^log2_rows + q % 2^log2_rows); rank r
// then splits and stores items (q, k2) for k2 in [r*HB, (r + 1)*HB), HB =
// n2/(2C), idx = (k2 - r*HB)*W + q, reading the partner row from whichever
// CTA of the cluster holds it.
template <int LOG2N2, bool T>
__global__ void __launch_bounds__(SplitPlan<LOG2N2>::MAX_THREADS, SplitPlan<LOG2N2>::MIN_BLOCKS)
rows_split_kernel(const float2* __restrict__ in, float2* __restrict__ out, long long pairs,
                  long long rows, int log2_rows, int log2n1, int log2cap,
                  long long out_stride) {
    using P = Plan<LOG2N2>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP;
    constexpr int C = repro::tstore::store_cluster<LOG2N2, 8>(4);
    constexpr int LOG2C = C == 4 ? 2 : C == 2 ? 1 : 0;
    static_assert(C == 1 << LOG2C, "a cluster of 1, 2 or 4 CTAs");
    constexpr int HB = N / 2 / C;
    constexpr int ITEMS = R / 2;
    // Items split and stored per batch: all 8, but 4 in K4b's one-row CTAs,
    // which spill at 8 within their 64 registers.
    constexpr int BATCH = T && C == 4 ? ITEMS / 2 : ITEMS;
    extern __shared__ float2 smem[];
    const int t = threadIdx.x % G;
    const int local = threadIdx.x / G;
    int rank = 0;
    if constexpr (C > 1) rank = (int)cg::this_cluster().block_rank();
    const int log2w = log2_rows + LOG2C;
    const int half = 1 << (log2w - 1);
    const long long u0 = ((long long)blockIdx.x >> LOG2C) << (log2w - 1);

    const int q = (rank << log2_rows) + local;
    const SlotRow mine = slot_row<T>(u0 + (q & (half - 1)), q >= half, log2n1, log2cap);
    const bool has_row = mine.p < pairs;
    const long long row = T ? ((long long)mine.k1 << log2cap) + mine.p
                            : (mine.p << log2n1) + mine.k1;
    const float2* x = in + (has_row ? row : 0) * N + t;
    float2 v[R];
#pragma unroll
    for (int k = 0; k < R; ++k) v[k] = has_row ? x[k * G] : make_float2(0.0f, 0.0f);

    repro::regfft::fft_row<LOG2N2, false>(v, smem, local * N, t);
    const Swizzle<LOG2N2> slot(log2_rows);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int c = 0; c < R; ++c) smem[slot(((t + c * G) << log2_rows) + local)] = v[c];
    if constexpr (C == 1) {
        __syncthreads();
    } else {
        cg::this_cluster().sync();  // every CTA's rows are in its buffer
    }

    const int qmask = (1 << log2w) - 1, pmask = (1 << log2_rows) - 1;
    // Bin k of cluster row qq, from the buffer of the CTA that holds it.
    auto z_at = [&](int qq, int k) {
        const float2* buf = smem;
        if constexpr (C > 1) buf = cg::this_cluster().map_shared_rank(smem, qq >> log2_rows);
        return buf[slot((k << log2_rows) + (qq & pmask))];
    };
    const bool vec = T && (out_stride & 1) == 0 &&
                     (reinterpret_cast<unsigned long long>(out) & 15) == 0;
#pragma unroll
    for (int first = 0; first < ITEMS; first += BATCH) {
        float2 zk[BATCH], zr[BATCH];
#pragma unroll
        for (int c = 0; c < BATCH; ++c) {
            const int idx = threadIdx.x + (first + c) * blockDim.x;
            const int qq = idx & qmask;
            const int k2 = rank * HB + (idx >> log2w);
            const bool right = qq >= half;
            const SlotRow s = slot_row<T>(u0 + (qq & (half - 1)), right, log2n1, log2cap);
            const int pq = s.sigma == 0 ? qq : qq ^ half;
            const int pk = s.sigma == 0 && !right ? (N - k2) & (N - 1) : N - 1 - k2;
            zk[c] = z_at(qq, k2);
            zr[c] = z_at(pq, pk);
        }
#pragma unroll
        for (int c = 0; c < BATCH; ++c) {
            const int idx = threadIdx.x + (first + c) * blockDim.x;
            const int qq = idx & qmask;
            const long long k2 = rank * HB + (idx >> log2w);
            const SlotRow s = slot_row<T>(u0 + (qq & (half - 1)), qq >= half, log2n1, log2cap);
            if (s.p < pairs)
                store_split<T>(out, s.p, s.k1 + (k2 << log2n1), split_a(zk[c], zr[c]),
                               split_b(zk[c], zr[c]), rows, out_stride, vec);
        }
    }
    // Bin n/2 (row 0's bin n2/2, its own partner), by the thread of item
    // (row 0, bin 0): idx = threadIdx.x < W on rank 0.
    if (rank == 0 && threadIdx.x < half) {
        const SlotRow s = slot_row<T>(u0 + threadIdx.x, false, log2n1, log2cap);
        if (s.sigma == 0 && s.p < pairs) {
            const float2 z = z_at(threadIdx.x, N / 2);
            store_split<T>(out, s.p, (long long)(N / 2) << log2n1, split_a(z, z),
                           split_b(z, z), rows, out_stride, vec);
        }
    }
    if constexpr (C > 1) {
        cg::this_cluster().sync();  // no CTA leaves while another still reads its buffer
    }
}

template <int LOG2N1, bool INV, int MODE>
int launch_columns(const void* in, void* scratch, long long rows, int log2n2, int log2cap,
                   long long real_rows, cudaStream_t stream) {
    static int configured_smem = 48 * 1024;
    if constexpr (packed_load(MODE)) {
        using CP = PackedColPlan<LOG2N1>;
        const long long smem = (long long)sizeof(float2) *
                               repro::regfft::exchange_elems(CP::COLS, 1 << LOG2N1);
        int err = repro::allow_dynamic_smem(columns_kernel<LOG2N1, INV, MODE>,
                                            &configured_smem, (int)smem);
        if (err != 0) return err;
        const long long blocks = rows << (log2n2 - CP::LOG2COLS);
        if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
        columns_kernel<LOG2N1, INV, MODE><<<(unsigned)blocks, CP::THREADS, (size_t)smem,
                                            stream>>>(in, (float2*)scratch, log2n2, log2cap,
                                                      real_rows);
    } else {
        using CP = ColPlan<LOG2N1>;
        constexpr bool TS = transposed_store(MODE);
        const long long smem = (long long)sizeof(float2) *
                               repro::regfft::exchange_elems(CP::COLS, 1 << LOG2N1);
        int err = repro::allow_dynamic_smem(complex_columns_kernel<LOG2N1, INV, TS>,
                                            &configured_smem, (int)smem);
        if (err != 0) return err;
        const long long tiles = rows << (log2n2 - CP::LOG2COLS);
        long long blocks = tiles;
        if constexpr (kPersistentColumns) {
            static int resident = 0;
            if (resident == 0) {
                int device = 0, sms = 0, per_sm = 0;
                cudaError_t e = cudaGetDevice(&device);
                if (e == cudaSuccess)
                    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
                if (e == cudaSuccess)
                    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per_sm, complex_columns_kernel<LOG2N1, INV, TS>, CP::THREADS,
                        (size_t)smem);
                if (e != cudaSuccess) return (int)e;
                resident = sms * per_sm;
            }
            if (resident > 0 && blocks > resident) blocks = resident;
        }
        if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
        complex_columns_kernel<LOG2N1, INV, TS><<<(unsigned)blocks, CP::THREADS, (size_t)smem,
                                                  stream>>>((const float2*)in,
                                                            (float2*)scratch, tiles, log2n2,
                                                            log2cap);
    }
    return (int)cudaGetLastError();
}

template <int LOG2N2, bool INV, bool T>
int launch_rows(const void* scratch, void* out, long long rows, int log2n1, int log2cap,
                long long valid, long long out_stride, int rows_per_cta, int threads,
                cudaStream_t stream) {
    using P = Plan<LOG2N2>;
    if (rows_per_cta < 1 || rows_per_cta > RowsPlan<LOG2N2>::MAX_ROWS ||
        (rows_per_cta & (rows_per_cta - 1)) || threads != rows_per_cta * P::GROUP)
        return (int)cudaErrorInvalidValue;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(rows_per_cta, P::N);
    int err = repro::allow_dynamic_smem(rows_transpose_kernel<LOG2N2, INV, T>,
                                        &configured_smem, (int)smem);
    if (err != 0) return err;
    constexpr int C = RowsPlan<LOG2N2>::C;
    if constexpr (C > 8) {
        static bool nonportable = false;
        if (!nonportable) {
            err = (int)cudaFuncSetAttribute(rows_transpose_kernel<LOG2N2, INV, T>,
                                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != 0) return err;
            nonportable = true;
        }
    }
    int log2_rows = 0;
    while ((1 << log2_rows) < rows_per_cta) ++log2_rows;
    static int active_clusters = 0;
    const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
    return repro::tstore::launch<C>(
        rows_transpose_kernel<LOG2N2, INV, T>, ctas, threads, smem, stream,
        &active_clusters, (const float2*)scratch, (float2*)out, rows, log2_rows, log2n1,
        log2cap, valid, out_stride);
}

template <int LOG2N2, bool T>
int launch_split_rows(const void* scratch, void* out, long long pairs, long long rows,
                      long long units, int log2n1, int log2cap, long long out_stride,
                      int rows_per_cta, int threads, cudaStream_t stream) {
    using P = Plan<LOG2N2>;
    constexpr int C = repro::tstore::store_cluster<LOG2N2, 8>(4);
    if (rows_per_cta < 1 || rows_per_cta > SplitPlan<LOG2N2>::MAX_ROWS ||
        (rows_per_cta & (rows_per_cta - 1)) || threads != rows_per_cta * P::GROUP ||
        rows_per_cta * C < 2 || units % (rows_per_cta * C / 2) != 0)
        return (int)cudaErrorInvalidValue;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) *
                           repro::regfft::exchange_elems(rows_per_cta, P::N);
    int err = repro::allow_dynamic_smem(rows_split_kernel<LOG2N2, T>, &configured_smem,
                                        (int)smem);
    if (err != 0) return err;
    int log2_rows = 0;
    while ((1 << log2_rows) < rows_per_cta) ++log2_rows;
    static int active_clusters = 0;
    return repro::tstore::launch<C>(
        rows_split_kernel<LOG2N2, T>, 2 * units / rows_per_cta, threads, smem, stream,
        &active_clusters, (const float2*)scratch, (float2*)out, pairs, rows, log2_rows, log2n1,
        log2cap, out_stride);
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

template <bool T, int E = kMinLog2>
int split_rows_for(int log2n2, const void* scratch, void* out, long long pairs, long long rows,
                   long long units, int log2n1, int log2cap, long long out_stride,
                   int rows_per_cta, int threads, cudaStream_t stream) {
    if (log2n2 == E)
        return launch_split_rows<E, T>(scratch, out, pairs, rows, units, log2n1, log2cap,
                                       out_stride, rows_per_cta, threads, stream);
    if constexpr (E < kMaxLog2)
        return split_rows_for<T, E + 1>(log2n2, scratch, out, pairs, rows, units, log2n1,
                                        log2cap, out_stride, rows_per_cta, threads, stream);
    return (int)cudaErrorInvalidValue;
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

// Passes A and B of the packed real kernels (K3b: T false, K4b: T true) on
// `stream`: two launches.  `rows` real rows of n1*n2 float32 in `in`; K3b's
// `scratch` holds (rows + 1) / 2 complex rows, K4b's cap of them (cap the
// least power of two >= (rows + 1) / 2).  Pass B's shape is
// kernels/fft/real_large.py::split_rows_plan(n2, units*2): rows_per_cta a
// CTA, at least 2 rows (a slot) a cluster.
template <bool T>
int real_rows_large(const void* in, void* out, void* scratch, long long rows, int n1, int n2,
                    long long out_stride, int rows_per_cta, int threads, void* stream) {
    if (rows <= 0) return 0;
    const int log2n1 = log2_of(n1), log2n2 = log2_of(n2);
    if (!factors_ok(log2n1, log2n2) || (T && out_stride < rows))
        return (int)cudaErrorInvalidValue;
    const long long pairs = (rows + 1) / 2;
    int log2cap = 0;
    if (T) {
        while ((1LL << log2cap) < pairs) ++log2cap;
    }
    cudaStream_t s = (cudaStream_t)stream;
    int err;
    if constexpr (T) {
        err = columns_for<false, kPackedTransposed>(log2n1, in, scratch, pairs, log2n2, log2cap,
                                                    rows, s);
    } else {
        err = columns_for<false, kPacked>(log2n1, in, scratch, pairs, log2n2, 0, rows, s);
    }
    if (err != 0) return err;
    const long long units = T ? 1LL << (log2n1 - 1 + log2cap) : pairs << (log2n1 - 1);
    return split_rows_for<T>(log2n2, scratch, out, pairs, rows, units, log2n1, log2cap,
                             out_stride, rows_per_cta, threads, s);
}

}  // namespace
