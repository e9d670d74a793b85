// Fused real row FFT -> transposed store for Hopper (sm_90a):
// out[k, r] = DFT_n(in[r, :])[k] for k < n/2 + 1 and every row r of a
// (rows, n) float32 matrix; out is (n/2 + 1, rows) interleaved complex64, n a
// power of two, 2 <= n <= 8192, forward only.  At n = 16384, where a pair
// would take regfft's Plan<14> (1024 threads and 136 KiB, one CTA an SM, no
// load in flight through its passes and cluster store), the op launches
// rfft_rows_transpose_16k.cu instead: the pair split over a cluster.
//
// Replaces the TPU kernel `rfft_rows_transpose_pallas` (body `_rfused_kernel`)
// of src/repro/kernels/fused/real.py: phase 1 of the fused real 2-D DFT, with
// no half-spectrum matrix in device memory between the row transforms and
// the transpose.  Same packing and split as rfft_rows.cu: a = in[2p] and
// b = in[2p + 1] are packed as z = a + i*b, one complex FFT gives Z, and
// A[k] = (Z[k] + conj Z[n-k]) / 2, B[k] = (Z[k] - conj Z[n-k]) / (2i).
//
// Bound on this card: bytes, as for rfft_rows.cu (rows*n*4 read once,
// rows*(n/2+1)*8 written once; 0.16 ms at 8192 x 8192 at 3.35 TB/s).  The
// read side and the passes are rfft_rows.cu's: a pair lives in registers
// (regfft.cuh, launch shape kernels/fft/kernel.py::complex_rows_plan with a
// pair in the place of a row), each thread issues its 32 float loads before
// the first butterfly, and at n = 8192 a CTA of 512 threads and 68 KiB lets
// two CTAs share an SM.  The store is the hard part: bin k of row r goes to
// out[k*rows + r], so a pair gives two neighbouring elements, 16 contiguous
// bytes, of each output row.  After the last pass Z goes once to the
// exchange buffer, and the store runs idx over (k, p) with the pair p
// fastest: lane idx reads Z_p[k] and Z_p[(n-k) mod n] and writes A and B as
// one aligned 16-byte store (two 8-byte stores when `rows` is odd, where
// k*rows + 2p is odd for odd k).  A CTA of P pairs so writes 16*P contiguous
// bytes per output row: on a full grid 32 at n = 2048, 64 at 1024, and so on
// up to a warp's 512 at n <= 128.
//
// At n = 4096 and 8192 a CTA holds one pair, and 16-byte pieces took 0.77
// ms at 8192 x 8192 against 0.30 for the store below (H100 SXM, PERF.md).
// There the CTAs run in clusters of kStoreCluster = 4 (distributed shared
// memory): after a cluster barrier, CTA rank r stores its quarter of the
// bins for the four pairs, reading the others' Z through map_shared_rank,
// the pair fastest, so 64 contiguous bytes per output row; a second barrier
// keeps each CTA until the others have read its buffer.  The grid is padded
// to a multiple of 4, and a CTA without a pair loads zeros, passes both
// barriers and stores nothing.
//
// The buffer holds bin k of pair p at slot f ^ h(f >> 4), f = k*P + p
// (tstore.cuh, Swizzle, shared with fft_rows_transpose.cu): the writes from
// registers and the store's reads are conflict-free at every plan
// (tests/_torch_parity.py::k4_store_model checks it on the CPU).  The
// cluster size rule and the launch in clusters are tstore.cuh's too.
//
// An odd row count leaves the last pair without b: it is read as 0 and its
// column is not stored.  A CTA of the ragged last grid step loads zeros for
// the pairs it lacks, runs the passes (the exchanges synchronise the CTA)
// and stores nothing for them.  `radix` is validated (2 or 4, as in the
// reference) but the passes depend on n only.

#include <cooperative_groups.h>

#include "tstore.cuh"

namespace {

namespace cg = cooperative_groups;
using repro::regfft::Plan;
using repro::tstore::Swizzle;

// CTAs of a cluster whose store covers the pairs of all of them, at the
// lengths where a CTA holds one pair (n >= 4096: 16 bytes of a pair per
// output row, half a sector); 1 (no cluster) elsewhere.  2 and 8 were
// slower than 4 at 8192 x 8192 on an H100 (PERF.md).
constexpr int kStoreCluster = 4;

template <int LOG2N>
__host__ __device__ constexpr int store_cluster() {
    return repro::tstore::store_cluster<LOG2N, 16>(kStoreCluster);
}

// The split of bin k of pair pa/2 from Z[k] and Z[(n-k) mod n], stored at
// out[k*rows + pa] (A) and out[k*rows + pa + 1] (B, unless pa + 1 = rows).
__device__ __forceinline__ void store_split(float2* __restrict__ out, long long rows,
                                            long long pa, int k, float2 zk, float2 zr,
                                            bool even) {
    const float2 sa = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
    const float2 sb = make_float2(0.5f * (zk.y + zr.y), 0.5f * (zr.x - zk.x));
    float2* dst = out + (long long)k * rows + pa;
    if (even) {
        *reinterpret_cast<float4*>(dst) = make_float4(sa.x, sa.y, sb.x, sb.y);
    } else {
        dst[0] = sa;
        if (pa + 1 < rows) dst[1] = sb;
    }
}

template <int LOG2N>
__global__ void __launch_bounds__(Plan<LOG2N>::MAX_THREADS, Plan<LOG2N>::MIN_BLOCKS)
rfft_rows_transpose_kernel(const float* __restrict__ in, float2* __restrict__ out,
                           long long rows, int log2_pairs) {
    using P = Plan<LOG2N>;
    constexpr int N = P::N, R = P::POINTS, G = P::GROUP, NH = N / 2 + 1;
    extern __shared__ float2 smem[];
    const int t = threadIdx.x % G;
    const int local = threadIdx.x / G;
    const long long pair0 = (long long)blockIdx.x << log2_pairs;
    const long long a = 2 * (pair0 + local);
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

    repro::regfft::fft_row<LOG2N, false>(v, smem, local * N, t);
    const Swizzle<LOG2N> slot(log2_pairs);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int c = 0; c < R; ++c) smem[slot(((t + c * G) << log2_pairs) + local)] = v[c];

    const bool even = (rows & 1) == 0;
    constexpr int C = store_cluster<LOG2N>();
    if constexpr (C == 1) {
        __syncthreads();
        // idx = k*P + p: lane idx stores bin k of pair p.  blockDim.x = P*G,
        // so (NH + G - 1) / G steps cover the NH*P of them.
        const int total = NH << log2_pairs;
        const int pmask = (1 << log2_pairs) - 1;
#pragma unroll
        for (int c = 0; c < (NH + G - 1) / G; ++c) {
            const int idx = threadIdx.x + c * blockDim.x;
            const int p = idx & pmask;
            const long long pa = 2 * (pair0 + p);
            if (idx >= total || pa >= rows) continue;
            const int k = idx >> log2_pairs;
            store_split(out, rows, pa, k, smem[slot(idx)],
                        smem[slot((((N - k) & (N - 1)) << log2_pairs) + p)], even);
        }
    } else {
        // One pair a CTA (slot() is the identity).  CTA rank r of the cluster
        // stores bins r*S ... r*S + S - 1 of the C pairs, idx = (k - r*S)*C + q
        // with the pair q fastest, reading Z_q from CTA q's buffer.
        constexpr int S = (NH + C - 1) / C;
        constexpr int LOG2C = C == 2 ? 1 : C == 4 ? 2 : 3;
        cg::cluster_group cluster = cg::this_cluster();
        cluster.sync();  // every CTA's Z is in its buffer
        const int rank = (int)cluster.block_rank();
        const long long first = (long long)blockIdx.x - rank;
#pragma unroll
        for (int c = 0; c < (S * C + G - 1) / G; ++c) {
            const int idx = threadIdx.x + c * G;
            const int q = idx & (C - 1);
            const int k = rank * S + (idx >> LOG2C);
            const long long pa = 2 * (first + q);
            if (idx >= S * C || k >= NH || pa >= rows) continue;
            const float2* z = cluster.map_shared_rank(smem, q);
            store_split(out, rows, pa, k, z[k], z[(N - k) & (N - 1)], even);
        }
        cluster.sync();  // no CTA leaves while another still reads its buffer
    }
}

// One instantiation: checks that the launcher's shape is this one's
// (pairs_per_cta a power of two up to MAX_ROWS, threads = pairs_per_cta *
// GROUP) and launches, in clusters of store_cluster<LOG2N>() CTAs over a
// grid padded to a multiple of them (tstore.cuh).
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
    int err = repro::allow_dynamic_smem(rfft_rows_transpose_kernel<LOG2N>,
                                        &configured_smem, (int)smem);
    if (err != 0) return err;
    int log2_pairs = 0;
    while ((1 << log2_pairs) < pairs_per_cta) ++log2_pairs;
    static int active_clusters = 0;
    const long long ctas = ((rows + 1) / 2 + pairs_per_cta - 1) / pairs_per_cta;
    return repro::tstore::launch<store_cluster<LOG2N>()>(
        rfft_rows_transpose_kernel<LOG2N>, ctas, threads, smem, stream, &active_clusters,
        (const float*)in, (float2*)out, rows, log2_pairs);
}

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` is (rows, n) float32, `out` a distinct
// (n/2 + 1, rows) complex64 buffer; `rows_per_cta` counts row pairs and,
// with `threads`, must be the shape kernels/fft/kernel.py::complex_rows_plan
// gives for (rows + 1) / 2 pairs.
extern "C" int repro_rfft_rows_transpose(const void* in, void* out, long long rows, int n,
                                         int radix, int rows_per_cta, int threads,
                                         void* stream) {
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
