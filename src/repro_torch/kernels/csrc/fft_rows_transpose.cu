// Fused row FFT -> transposed store for Hopper (sm_90a):
// out[k, r] = DFT_n(in[r, :])[k] for every row r of a (rows, n) matrix of
// interleaved complex64, out of shape (n, rows); forward or inverse (scaled
// by 1/n), n a power of two, 2 <= n <= 8192.  At n = 16384, where a row
// would take regfft's Plan<14>, 1024 threads and 136 KiB, a CTA an SM, K2
// runs fft_rows_transpose_cluster.cu's one-pass cluster kernel instead.
//
// Replaces the TPU kernel `fft_rows_transpose_pallas` (body `_fused_kernel`)
// of src/repro/kernels/fused/kernel.py: the row-transformed matrix never goes
// through device memory between the transform and the transpose.
//
// Bound on this card: bytes (rows*n*8 read once and rows*n*8 written once,
// 0.32 ms at 8192 x 8192 at 3.35 TB/s; the flops are a fifth of that).  The
// read side and the passes are fft_rows.cu's: a row lives in registers
// (regfft.cuh, launch shape kernels/fft/kernel.py::complex_rows_plan), each
// thread issues its 16 float2 loads before the first butterfly, and at
// n = 8192 a CTA of 512 threads and 68 KiB lets two CTAs share an SM.  The
// store is the hard part: bin k of row r goes to out[k*rows + r], so a row
// alone gives 8 bytes of each output row.  After the last pass the thread
// writes the bins it holds once to the exchange buffer, bin k of the CTA's
// row p at a swizzled slot of f = k*P + p (tstore.cuh, Swizzle: the writes
// and the store's reads are conflict-free), and the store runs idx over
// (k, p) with the row fastest, so a CTA of P rows writes 8*P contiguous
// bytes per output row: 32 at n = 1024, 64 at 512, up to a warp's 256.
//
// Where a whole CTA's rows make less than a 32-byte sector (n >= 2048: two
// rows a CTA at 2048, one from 4096 up) the CTAs run in thread-block
// clusters of C (tstore.cuh, store_cluster: kStoreCluster rows' worth of
// CTAs, so C = 4 at n >= 4096 and 2 at 2048).  After a cluster barrier CTA
// rank r stores bins r*S ... r*S + S - 1 (S = n / C) of the C*P rows of the
// cluster, reading row q from the buffer of CTA q / P through
// map_shared_rank, the row fastest: a whole 32-byte sector per output row.
// A second barrier keeps each CTA until the others have read its buffer.
// The grid is padded to a multiple of C.  Pieces of 8 and 16 bytes took
// 2.0 and 1.6 ms at 8192 x 8192 on an H100, against 0.58 for 32 bytes;
// clusters of 8 and 16 CTAs (64 and 128 bytes) took 0.68 and 0.98
// (PERF.md).
//
// A CTA of the ragged last grid step (or cluster) loads zeros for the rows
// it lacks, runs the passes (the exchanges and the cluster barriers
// synchronise every thread) and stores nothing for them: the caller pads
// nothing.  `radix` is validated (2 or 4, as in the reference) but the
// passes depend on n only.

#include <cooperative_groups.h>

#include "tstore.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::regfft::Plan;
using repro::tstore::Swizzle;

// CTAs of a cluster at the lengths where a CTA holds one row (8 bytes per
// output row, n >= 4096): the store then writes 8 * kStoreCluster = 32
// contiguous bytes per output row.  At n = 2048 (two rows a CTA) half as
// many; below, no cluster.
constexpr int kStoreCluster = 4;

template <int LOG2N>
__host__ __device__ constexpr int store_cluster() {
    return repro::tstore::store_cluster<LOG2N, 8>(kStoreCluster);
}

template <int LOG2N, bool INV>
__global__ void __launch_bounds__(Plan<LOG2N>::MAX_THREADS, Plan<LOG2N>::MIN_BLOCKS)
fft_rows_transpose_kernel(const float2* __restrict__ in, float2* __restrict__ out,
                          long long rows, int log2_rows) {
    using P = Plan<LOG2N>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP;
    constexpr int C = store_cluster<LOG2N>();
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

    repro::regfft::fft_row<LOG2N, INV>(v, smem, local * N, t);
    const Swizzle<LOG2N> slot(log2_rows);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int c = 0; c < R; ++c) smem[slot(((t + c * G) << log2_rows) + local)] = v[c];

    // CTA rank r of the cluster (C = 1: the CTA alone, r = 0) stores bins
    // r*S ... r*S + S - 1 of the W = C*P rows from row0 on: idx =
    // (k - r*S)*W + q, row q fastest, read from CTA q / P's buffer.
    // blockDim.x = P*G, so R steps cover the S*W = N*P of them.  Every read
    // is in bounds (all C CTAs exist), so they are issued before any store.
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
#pragma unroll
    for (int c = 0; c < R; ++c) {
        const int idx = threadIdx.x + c * blockDim.x;
        const long long r = row0 + (idx & qmask);
        const int k = rank * S + (idx >> log2w);
        if (r < rows) out[(long long)k * rows + r] = z[c];
    }
    if constexpr (C > 1) {
        cg::this_cluster().sync();  // no CTA leaves while another still reads its buffer
    }
}

// One instantiation: checks that the launcher's shape is this one's
// (rows_per_cta a power of two up to MAX_ROWS, threads = rows_per_cta *
// GROUP) and launches, in clusters of store_cluster<LOG2N>() CTAs over a
// grid padded to a multiple of them (tstore.cuh).
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
    int err = repro::allow_dynamic_smem(fft_rows_transpose_kernel<LOG2N, INV>,
                                        &configured_smem, (int)smem);
    if (err != 0) return err;
    int log2_rows = 0;
    while ((1 << log2_rows) < rows_per_cta) ++log2_rows;
    static int active_clusters = 0;
    const long long ctas = (rows + rows_per_cta - 1) / rows_per_cta;
    return repro::tstore::launch<store_cluster<LOG2N>()>(
        fft_rows_transpose_kernel<LOG2N, INV>, ctas, threads, smem, stream,
        &active_clusters, (const float2*)in, (float2*)out, rows, log2_rows);
}

template <int LOG2N>
int launch_dir(const void* in, void* out, long long rows, int inverse, int rows_per_cta,
               int threads, cudaStream_t stream) {
    return inverse ? launch<LOG2N, true>(in, out, rows, rows_per_cta, threads, stream)
                   : launch<LOG2N, false>(in, out, rows, rows_per_cta, threads, stream);
}

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` is (rows, n) complex64, `out` a distinct (n, rows)
// buffer; `rows_per_cta` and `threads` must be the shape
// kernels/fused/kernel.py::fft_rows_transpose_plan gives (that of
// complex_rows_plan); the cluster follows from n.
extern "C" int repro_fft_rows_transpose(const void* in, void* out, long long rows, int n,
                                        int radix, int inverse, int rows_per_cta,
                                        int threads, void* stream) {
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
        default: return (int)cudaErrorInvalidValue;
    }
}
