// The one-pass four-step row FFT over a thread-block cluster for Hopper
// (sm_90a): K1b (fft_rows_cluster.cu, n = 32768 ... 2^18) and K2b, its
// transposed sibling (fft_rows_transpose_cluster.cu, n = 16384 ... 65536),
// where a whole row of n complex64 (up to 2 MiB) fits in the distributed
// shared memory of a cluster of C CTAs (8, or 16 where more is needed).  It computes the four-step of fourstep.cuh,
//   X[k1 + n1*k2] = sum_j2 w_n2^(j2*k2) * w_n^(k1*j2) * sum_j1 w_n1^(j1*k1) * A[j1][j2],
// with A[j1][j2] = x[j1*n2 + j2], in one launch: B never leaves the chip.
//
// Cluster q holds the R signal rows s = q*R + g, g < R (R = 1 for K1b, 4 for
// K2b); rank r of it runs T = n/(16C) threads a row, thread g*T + rt
// working on row g in its own part of the CTA's buffer (one a row):
// - Column phase: loads columns j2 in [r*COLS, (r + 1)*COLS), COLS = n2/C,
//   thread t*COLS + c holding A[t + k*G1][j2 = r*COLS + c], k < 16 (G1 =
//   n1/16 threads a column).  With the columns fastest a warp loads 32
//   adjacent elements of one row of the view: 256 contiguous bytes (COLS >=
//   32).  It runs the length-n1 DFT down each column with regfft.cuh's
//   passes, the columns interleaved in the exchange buffer (element f of
//   column c at f*COLS + c: a half-warp touches 16 consecutive slots), and
//   multiplies by the twiddle w_n^(k1*j2) (column_fft and column_twiddles
//   of fourstep.cuh, which the two passes' pass A shares).
// - Exchange: B[k1][j2] goes to rank k1 / W (W = n1/C rows of B a rank),
//   local row rho = k1 % W, slot rho*n2 + j2 of row g's part, by a store
//   through distributed shared memory (map_shared_rank).  k1 = t + k*G1 and
//   W = (16/C)*G1 make the owner k / (16/C), the same for every thread at
//   step k: each thread sends 16/C points to each rank, and a warp's store
//   is 256 contiguous bytes of one row of the owner's slab.
// - Row phase: after the cluster barrier, rank r loads its W rows of B from
//   its own slab and runs regfft's length-n2 DFT on each, thread rho*G2 + t2
//   holding B[rho][t2 + k*G2] (G2 = n2/16 >= 16: a half-warp loads 16
//   consecutive slots), the exchanges in the same buffer (every load
//   precedes the passes' first barrier).
// - Store: bin k2 of local row rho of row g is element f = (k2*W + rho)*R +
//   g of a staging area in tstore.cuh's swizzled layout (P = W*R rows of
//   n2), read back with f consecutive.  K1b (R = 1) writes it to
//   out[s*n + k2*n1 + r*W + rho]: for each k2 a run of W consecutive
//   elements, a warp 32/W such runs or one run of 256 bytes (whole sectors:
//   W >= 4; R*W >= 4 for the transposed store, whose runs are the R rows).  K2b (TRANSPOSED) writes it to out[(k1 + n1*k2)*out_stride +
//   s], k1 = r*W + rho: for each (k1, k2) a run of the R rows' s, 32 bytes
//   at R = 4, a whole sector where out_stride is a multiple of 4; rows of a
//   last group past the call's are loaded as zeros and not stored.
//
// One buffer a CTA, a part a row, serves the column exchange, the slab, the
// row exchange and, all parts together, the store's staging: R*(n/C)*17/16
// float2.  Two cluster barriers order it: the first after the column phase
// (every rank is done with its column exchange, and every CTA of the
// cluster has started, before any remote store), the second after the
// exchange (every slab is whole).  After it no CTA touches another's
// memory, so none waits for the others at the end.
// tests/_torch_parity.py::k1b_cluster_model and k2b_cluster_model check every
// index above (each element loaded, sent, read and stored once; whole
// sectors; no bank conflict) at the shapes fft_rows_cluster.cu and
// fft_rows_transpose_cluster.cu launch.
//
// Bound on this card: bytes, the function's own: each element is read once
// from device memory and written once.  What the design does about the
// rest: the column and row exchanges and the staging stay in shared memory,
// (C - 1)/C of the points cross the SM-to-SM network once, in 256-byte runs
// (32-byte runs, regfft's own column layout, cost a measurable share of the
// time), and the twiddles take five sincospif a thread (two a point cost
// more than a whole regfft pass).
//
// Everything here has internal linkage (the library is built without -rdc).

#pragma once

#include "fourstep.cuh"

namespace {

// The launch shape of the one-pass kernel for n = 2^LOG2N1 * 2^LOG2N2 over a
// cluster of 2^LOG2C CTAs holding 2^LOG2R signal rows (mirrored by
// kernels/fft/large.py::cluster_plan and kernels/fused/large.py::
// transpose_cluster_plan).  Clusters of more than 8 CTAs are non-portable.
template <int LOG2N1, int LOG2N2, int LOG2C, int LOG2R = 0>
struct ClusterPlan {
    static constexpr int N1 = 1 << LOG2N1, N2 = 1 << LOG2N2, C = 1 << LOG2C;
    static constexpr int R = 1 << LOG2R;              // signal rows a cluster
    static constexpr int G1 = Plan<LOG2N1>::GROUP;    // threads a column
    static constexpr int G2 = Plan<LOG2N2>::GROUP;    // threads a row
    static constexpr int COLS = N2 / C;               // columns a rank loads
    static constexpr int LOG2W = LOG2N1 - LOG2C;
    static constexpr int W = 1 << LOG2W;              // rows of B a rank owns
    static constexpr int PER_RANK = 16 / C;           // points a thread sends a rank
    static constexpr int ROW_THREADS = COLS * G1;     // threads a signal row
    static constexpr int THREADS = ROW_THREADS * R;
    static constexpr int MIN_BLOCKS = 65536 / (THREADS * 64);
    static constexpr long long ROW_ELEMS = repro::regfft::exchange_elems(W, N2);
    static constexpr long long ELEMS = ROW_ELEMS * R;
    static_assert(Plan<LOG2N1>::POINTS == 16 && Plan<LOG2N2>::POINTS == 16,
                  "16 points a thread in both phases");
    static_assert(ROW_THREADS == W * G2 && THREADS <= 1024,
                  "one thread count for both phases");
    static_assert(C >= 2 && C <= 16, "a cluster of 2 to 16 CTAs");
    static_assert(COLS >= 32 && W >= 4 / R,
                  "a warp's loads and remote stores 256 contiguous bytes; its stores whole "
                  "sectors (runs of W rows of B, or of R signal rows side by side)");
    static_assert(G2 >= 16, "the row phase's loads: 16 consecutive j2 a half-warp");
};

// blockIdx.x = q*C + r: rank r of the cluster of signal rows q*R ... q*R +
// R - 1 (rows past `rows` are masked).  TRANSPOSED stores bin k of row s to
// out[k*out_stride + s], else to out[s*n + k].
template <int LOG2N1, int LOG2N2, int LOG2C, bool INV, int LOG2R = 0, bool TRANSPOSED = false>
__global__ void __launch_bounds__(ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>::THREADS,
                                  ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>::MIN_BLOCKS)
cluster_kernel(const float2* __restrict__ in, float2* __restrict__ out, long long rows,
               long long out_stride) {
    using CP = ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>;
    constexpr int LOG2N = LOG2N1 + LOG2N2;
    constexpr int N1 = CP::N1, N2 = CP::N2, G1 = CP::G1, G2 = CP::G2, W = CP::W;
    constexpr int COLS = CP::COLS, LOG2P = CP::LOG2W + LOG2R;
    extern __shared__ float2 smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int g = CP::R == 1 ? 0 : threadIdx.x / CP::ROW_THREADS;
    const int rt = CP::R == 1 ? threadIdx.x : threadIdx.x % CP::ROW_THREADS;
    const long long s0 = ((long long)blockIdx.x >> LOG2C) << LOG2R;
    const long long s = s0 + g;
    const bool live = CP::R == 1 || s < rows;
    float2* buf = smem + g * CP::ROW_ELEMS;    // row g's part

    // Column phase: thread t*COLS + c holds A[t + k*G1][j2], j2 = rank*COLS + c.
    const int c = rt % COLS, t = rt / COLS;
    const int j2 = rank * COLS + c;
    const float2* x = in + (s << LOG2N) + t * N2 + j2;
    float2 v[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = live ? x[k * G1 * N2] : make_float2(0.0f, 0.0f);
    column_fft<LOG2N1, COLS, INV>(v, buf, c, t);
    column_twiddles<INV>(v, t, G1, j2, LOG2N);
    cluster.sync();  // column exchanges done, every CTA of the cluster running

    // Exchange: point k, B[t + k*G1][j2], to rank k / PER_RANK, its row
    // t + (k % PER_RANK)*G1 at offset row*N2 + j2 of row g's part: a warp
    // stores 32 consecutive j2 of one row.
#pragma unroll
    for (int o = 0; o < CP::C; ++o) {
        float2* slab = cluster.map_shared_rank(buf, o);
#pragma unroll
        for (int i = 0; i < CP::PER_RANK; ++i)
            slab[(t + i * G1) * N2 + j2] = v[o * CP::PER_RANK + i];
    }
    cluster.sync();  // every slab whole

    // Row phase: local row rho is k1 = rank*W + rho.
    const int rho = rt / G2, t2 = rt % G2;
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = buf[rho * N2 + t2 + k * G2];
    repro::regfft::fft_row<LOG2N2, INV>(v, buf, rho * N2, t2);

    // Store: bin k2 of row rho of row g staged at f = (k2*W + rho)*R + g, so
    // that the store runs over rho (K1b) or over g (K2b).
    const Swizzle<LOG2N2> slot(LOG2P);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int k = 0; k < 16; ++k)
        smem[slot(((((t2 + k * G2) << CP::LOG2W) + rho) << LOG2R) + g)] = v[k];
    __syncthreads();
    float2* o = TRANSPOSED ? out : out + (s << LOG2N) + rank * W;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int idx = threadIdx.x + k * CP::THREADS;
        const int q = idx & ((1 << LOG2P) - 1), k2 = idx >> LOG2P;
        if constexpr (TRANSPOSED) {
            const int gq = q & (CP::R - 1);
            const long long bin = rank * W + (q >> LOG2R) + (long long)N1 * k2;
            if (s0 + gq < rows) o[bin * out_stride + s0 + gq] = smem[slot(idx)];
        } else {
            o[k2 * N1 + q] = smem[slot(idx)];
        }
    }
}

// Clusters of this shape the card can hold at once: set by the first launch
// (tstore::launch), 0 before.
template <int LOG2N1, int LOG2N2, int LOG2C, bool INV, int LOG2R = 0, bool TRANSPOSED = false>
int& cluster_occupancy() {
    static int active = 0;
    return active;
}

// One launch over ceil(rows / R) clusters; out_stride is the transposed
// store's row stride.  Returns a CUDA error code (0 = launched).
template <int LOG2N1, int LOG2N2, int LOG2C, bool INV, int LOG2R = 0, bool TRANSPOSED = false>
int launch_cluster(const void* in, void* out, long long rows, cudaStream_t stream,
                   long long out_stride = 0) {
    using CP = ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>;
    auto kernel = cluster_kernel<LOG2N1, LOG2N2, LOG2C, INV, LOG2R, TRANSPOSED>;
    static int configured_smem = 48 * 1024;
    const long long smem = (long long)sizeof(float2) * CP::ELEMS;
    int err = repro::allow_dynamic_smem(kernel, &configured_smem, (int)smem);
    if (err != 0) return err;
    if constexpr (CP::C > 8) {
        static bool nonportable = false;
        if (!nonportable) {
            err = (int)cudaFuncSetAttribute(kernel,
                                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
            if (err != 0) return err;
            nonportable = true;
        }
    }
    return repro::tstore::launch<CP::C>(
        kernel, ((rows + CP::R - 1) >> LOG2R) << LOG2C, CP::THREADS, smem, stream,
        &cluster_occupancy<LOG2N1, LOG2N2, LOG2C, INV, LOG2R, TRANSPOSED>(),
        (const float2*)in, (float2*)out, rows, out_stride);
}

}  // namespace
