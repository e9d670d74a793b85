// The packed real row FFT of rows of n = 16384 split over a thread-block
// cluster, for Hopper (sm_90a): a pair of float32 rows in one launch over
// clusters, out of which two kernels store:
// - packed_transpose_kernel, K4 at n = 16384 (rfft_rows_transpose_16k.cu,
//   the library's): out[k, r] = DFT_n(in[r, :])[k], out (n/2 + 1, rows),
//   the cluster's pairs side by side in each output row.
// - packed_cluster_kernel, K3's first design there: out[r, k], out (rows, n/2
//   + 1).  It lost to the persistent kernel of rfft_rows_16k.cu (PERF.md:
//   14-17 % slower at 4096 and 16384 rows, 3 % behind rfft_rows.cu), so the
//   library does not instantiate it: examples/kernel_check_torch.py builds
//   it out of the library as a variant (RFFT_16K_VARIANTS) and times it.
//
// The TPU kernels they replace (K4) or would replace (K3), at n = 16384:
// `rfft_rows_transpose_pallas` of src/repro/kernels/fused/real.py and
// `rfft_rows_pallas` (body `_rfft_kernel`) of src/repro/kernels/fft/real.py.
// Same algorithm: rows a = in[2p], b = in[2p + 1] packed as z = a + i*b, one
// complex FFT Z, and the conjugate split A[k] = (Z[k] + conj Z[n-k]) / 2,
// B[k] = (Z[k] - conj Z[n-k]) / (2i).
//
// Bound on this card: bytes (rows*n*4 read, rows*(n/2 + 1)*8 written).  The
// design: where rfft_rows.cu gives a pair regfft's Plan<14>, 1024 threads
// and 136 KiB, one CTA an SM, here a pair is split over the CTAs of a
// cluster as K2b's one-pass four-step (fourstep_cluster.cuh) splits a
// complex row, n = n1 * n2, Z[k1 + n1*k2] = bin k2 of the length-n2 DFT of
// row k1 of B:
// - Column phase: rank r loads columns j2 in [r*COLS, (r + 1)*COLS) of the R
//   pairs of its cluster, a warp 32 adjacent floats (128 bytes) of row a and
//   of row b, then column_fft and column_twiddles as in cluster_kernel.
// - Exchange, with the mirror slots of fourstep.cuh's rows_split_kernel:
//   Z[(n - k) mod n] of bin k2 of row k1 != 0 is bin n2 - 1 - k2 of row
//   n1 - k1, and of row 0 bin (n2 - k2) mod n2 of row 0 (row n1/2 is its own
//   partner too, at n2 - 1 - k2).  Slot sigma < n1/2 is rows sigma and
//   n1 - sigma (slot 0: rows 0 and n1/2), and rank r owns slots [r*H,
//   (r + 1)*H), H = W/2, W = n1/C rows: the left rows at local rows
//   sigma - r*H, the right ones H further.  A point goes to its row's owner
//   through distributed shared memory; a warp stores 256 contiguous bytes
//   (32 adjacent j2 of one row), as in cluster_kernel.
// - Row phase: each rank runs regfft's length-n2 DFT on its W rows, so both
//   rows of each slot it owns are in its own shared memory.
// - Split and store (K3's; K4's is described above packed_transpose_kernel):
//   Z is staged in tstore.cuh's swizzled layout (bin k2 of local row rho at
//   slot(k2*W + rho)); item (q, k2), k2 < n2/2, q fastest,
//   reads Z(q, k2) and its partner (local row q ^ H, bin n2 - 1 - k2; slot
//   0's rows themselves) and writes A to out[2p][k] and B to out[2p + 1][k],
//   k = k1 + n1*k2: each output element once, bin n/2 (row 0's bin n2/2,
//   its own partner) by one thread of rank 0.  The half spectrum k <= n/2 is
//   bins k2 < n2/2 of every row plus that one.  A warp's store is runs of H
//   neighbouring k1 of one output row (the left rows rising, the right
//   falling), off 32-byte boundaries as the rows of n/2 + 1 bins are.
// Nothing of a pair leaves the cluster before its output; the second cluster
// barrier is the last, so no CTA waits for another at the end.
// tests/_torch_parity.py::k3_cluster_model and k4_16k_model check every
// index in float64.
//
// K3's best shape (kClusterLog2Ctas, kClusterLog2Pairs, kClusterLog2N2): 2
// CTAs of 1 pair, n1 = 64 and n2 = 256, 32 rows of B a rank (runs of 16
// bins, 128 bytes), half of the points crossing to the other CTA, 512
// threads and 69632 bytes of shared memory a CTA, two CTAs an SM.  4 CTAs of
// 2 pairs, 8 of 4, the split n2 = 512 and 2 CTAs of 2 pairs (one CTA an SM)
// took 11-31 % longer at 4096 rows.  An odd row count leaves the last pair
// without b: it is read as 0 and B is not stored.

#pragma once

#include "fourstep_cluster.cuh"

namespace {

constexpr int kClusterLog2Ctas = 1;
constexpr int kClusterLog2Pairs = 0;
constexpr int kClusterLog2N2 = 8;

// The mirror slots of rows of B over the ranks of a cluster: n1 = 2^LOG2N1
// rows, W = 2^LOG2W a rank, H = W/2 slots a rank.
template <int LOG2N1, int LOG2W>
struct Mirror {
    static constexpr int N1 = 1 << LOG2N1, H = 1 << (LOG2W - 1);
    static_assert(LOG2W >= 1, "two rows of a slot a rank at least");
    __host__ __device__ static constexpr int slot(int k1) {
        return k1 < N1 / 2 ? k1 : k1 == N1 / 2 ? 0 : N1 - k1;
    }
    __host__ __device__ static constexpr int owner(int k1) { return slot(k1) >> (LOG2W - 1); }
    __host__ __device__ static constexpr int local(int k1) {
        return (slot(k1) & (H - 1)) + (k1 >= N1 / 2 ? H : 0);
    }
    // Row k1 of local row rho of rank r.
    __host__ __device__ static constexpr int row(int r, int rho) {
        return rho < H ? r * H + rho
                       : r * H + rho - H == 0 ? N1 / 2 : N1 - (r * H + rho - H);
    }
};

// Pair p of the call (rows 2p and 2p + 1, read as 0 where the call has
// none) through the column phase, the exchange to the mirror slots and the
// row phase, as pair g of the cluster in part `buf` of its CTA's buffer: on
// return thread rt = rho*G2 + t2 of the pair holds v[k] = bin t2 + k*G2 of
// local row rho, row M::row(rank, rho) of B.  The two cluster barriers are
// inside, so every thread of the cluster calls it.
template <int LOG2N1, int LOG2N2, int LOG2C, int LOG2R>
__device__ __forceinline__ void packed_cluster_rows(const float* __restrict__ in,
                                                    long long rows, long long p, float2* buf,
                                                    int rt, int rank, float2 (&v)[16]) {
    using CP = ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>;
    using M = Mirror<LOG2N1, CP::LOG2W>;
    constexpr int LOG2N = LOG2N1 + LOG2N2;
    constexpr int N2 = CP::N2, G1 = CP::G1, G2 = CP::G2, COLS = CP::COLS;
    cg::cluster_group cluster = cg::this_cluster();
    const bool has_a = 2 * p < rows, has_b = 2 * p + 1 < rows;

    // Column phase: thread t*COLS + c holds z[(t + k*G1)*N2 + j2], j2 =
    // rank*COLS + c, as a + i*b; all 32 loads before the first butterfly.
    const int c = rt % COLS, t = rt / COLS;
    const int j2 = rank * COLS + c;
    const float* xa = in + ((has_a ? 2 * p : 0) << LOG2N) + t * N2 + j2;
    const float* xb = in + ((has_b ? 2 * p + 1 : 0) << LOG2N) + t * N2 + j2;
    float re[16], im[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) re[k] = has_a ? xa[k * G1 * N2] : 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) im[k] = has_b ? xb[k * G1 * N2] : 0.0f;
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = make_float2(re[k], im[k]);
    column_fft<LOG2N1, COLS, false>(v, buf, c, t);
    column_twiddles<false>(v, t, G1, j2, LOG2N);
    cluster.sync();  // column exchanges done, every CTA of the cluster running

    // Exchange: B[k1][j2], k1 = t + k*G1, to the owner of k1's slot, its
    // local row at offset row*N2 + j2 of pair g's part.
#pragma unroll
    for (int k = 0; k < 16; ++k) {
        const int k1 = t + k * G1;
        float2* slab = cluster.map_shared_rank(buf, M::owner(k1));
        slab[M::local(k1) * N2 + j2] = v[k];
    }
    cluster.sync();  // every slab whole

    // Row phase: local row rho is row M::row(rank, rho) of B.
    const int rho = rt / G2, t2 = rt % G2;
#pragma unroll
    for (int k = 0; k < 16; ++k) v[k] = buf[rho * N2 + t2 + k * G2];
    repro::regfft::fft_row<LOG2N2, false>(v, buf, rho * N2, t2);
}

// K3's design: blockIdx.x = q*C + r, rank r of the cluster of pairs q*R ...
// q*R + R - 1 (pairs past the call's load zeros and store nothing).
template <int LOG2N1, int LOG2N2, int LOG2C, int LOG2R>
__global__ void __launch_bounds__(ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>::THREADS,
                                  ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>::MIN_BLOCKS)
packed_cluster_kernel(const float* __restrict__ in, float2* __restrict__ out,
                      long long rows) {
    using CP = ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>;
    using M = Mirror<LOG2N1, CP::LOG2W>;
    constexpr int LOG2N = LOG2N1 + LOG2N2, LOG2W = CP::LOG2W;
    constexpr int N2 = CP::N2, G2 = CP::G2, W = CP::W, H = W / 2;
    constexpr int RT = CP::ROW_THREADS;
    constexpr long long NH = (1LL << (LOG2N - 1)) + 1;
    extern __shared__ float2 smem[];
    const int rank = (int)cg::this_cluster().block_rank();
    const int g = CP::R == 1 ? 0 : threadIdx.x / RT;
    const int rt = CP::R == 1 ? threadIdx.x : threadIdx.x % RT;
    const long long p = (((long long)blockIdx.x >> LOG2C) << LOG2R) + g;
    const bool has_a = 2 * p < rows, has_b = 2 * p + 1 < rows;
    float2* buf = smem + g * CP::ROW_ELEMS;    // pair g's part
    float2 v[16];
    packed_cluster_rows<LOG2N1, LOG2N2, LOG2C, LOG2R>(in, rows, p, buf, rt, rank, v);

    // Stage Z: bin k2 of local row rho at slot(k2*W + rho) of pair g's part.
    const int rho = rt / G2, t2 = rt % G2;
    const Swizzle<LOG2N2> slot(LOG2W);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int k = 0; k < 16; ++k) buf[slot(((t2 + k * G2) << LOG2W) + rho)] = v[k];
    __syncthreads();
    if (!has_a) return;

    // Split: item idx = rt + i*RT, i < 8, is (q, k2) = (idx % W, idx / W),
    // k2 < N2/2; its partner is local row q ^ H at bin N2 - 1 - k2, or in
    // slot 0 (rank 0, q = 0 or H) its own row, at (N2 - k2) mod N2 on the
    // left (row 0) and N2 - 1 - k2 on the right (row n1/2).  Four items a
    // batch: their eight reads, then their stores.
    float2* oa = out + 2 * p * NH;
    float2* ob = oa + NH;
#pragma unroll
    for (int first = 0; first < 8; first += 4) {
        float2 zk[4], zr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = rt + (first + i) * RT;
            const int q = idx & (W - 1), k2 = idx >> LOG2W;
            const bool self = rank == 0 && (q & (H - 1)) == 0;
            const int pq = self ? q : q ^ H;
            const int pk = self && q == 0 ? (N2 - k2) & (N2 - 1) : N2 - 1 - k2;
            zk[i] = buf[slot((k2 << LOG2W) + q)];
            zr[i] = buf[slot((pk << LOG2W) + pq)];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int idx = rt + (first + i) * RT;
            const int q = idx & (W - 1), k2 = idx >> LOG2W;
            const int k = M::row(rank, q) + (k2 << LOG2N1);
            oa[k] = split_a(zk[i], zr[i]);
            if (has_b) ob[k] = split_b(zk[i], zr[i]);
        }
    }
    // Bin n/2: row 0's bin N2/2, its own partner, on rank 0.
    if (rank == 0 && rt == 0) {
        const float2 z = buf[slot((N2 / 2) << LOG2W)];
        oa[NH - 1] = split_a(z, z);
        if (has_b) ob[NH - 1] = split_b(z, z);
    }
}

// K4's design (rfft_rows_transpose_16k.cu): the pairs and phases of
// packed_cluster_kernel, blockIdx.x = q*C + r as there, then the split
// stored transposed with the R pairs side by side.  Z of the R pairs is
// staged together in the whole buffer, bin k2 of local row rho of pair g at
// slot(f), f = ((k2*W + rho) << LOG2R) + g (tstore.cuh's swizzle for P =
// W*R rows of n2, as cluster_kernel stages K2's rows).  Item f = threadIdx.x
// + i*THREADS, i < 8, is (g, q, k2) = (f % R, (f / R) % W, f / (R*W)), k2 <
// N2/2, with its partner as in packed_cluster_kernel: A of bin k = M::row(
// rank, q) + n1*k2 of pair p = q*R + g to out[k][2p] and B to out[k][2p +
// 1], one float4 where the row count is even (the output's rows start on
// 16 bytes).  A warp's store is 32/(R*W) bins of each of the W local rows,
// the R pairs' 2R real rows of a bin side by side: 16*R contiguous bytes
// of an output row, whole sectors where the row count is a multiple of 4.
template <int LOG2N1, int LOG2N2, int LOG2C, int LOG2R>
__global__ void __launch_bounds__(ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>::THREADS,
                                  ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>::MIN_BLOCKS)
packed_transpose_kernel(const float* __restrict__ in, float2* __restrict__ out,
                        long long rows) {
    using CP = ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>;
    using M = Mirror<LOG2N1, CP::LOG2W>;
    constexpr int LOG2W = CP::LOG2W, LOG2P = LOG2W + LOG2R;
    constexpr int N2 = CP::N2, G2 = CP::G2, W = CP::W, H = W / 2, R = CP::R;
    constexpr int RT = CP::ROW_THREADS, THREADS = CP::THREADS;
    constexpr long long HALF = 1LL << (LOG2N1 + LOG2N2 - 1);   // bin n/2
    extern __shared__ float2 smem[];
    const int rank = (int)cg::this_cluster().block_rank();
    const int g = threadIdx.x / RT, rt = threadIdx.x % RT;
    const long long p0 = ((long long)blockIdx.x >> LOG2C) << LOG2R;
    const long long pairs = (rows + 1) / 2;
    float2 v[16];
    packed_cluster_rows<LOG2N1, LOG2N2, LOG2C, LOG2R>(in, rows, p0 + g,
                                                      smem + g * CP::ROW_ELEMS, rt, rank, v);

    // Stage Z of the R pairs side by side.
    const int rho = rt / G2, t2 = rt % G2;
    const Swizzle<LOG2N2> slot(LOG2P);
    __syncthreads();  // the last exchange's reads are done
#pragma unroll
    for (int k = 0; k < 16; ++k)
        smem[slot(((((t2 + k * G2) << LOG2W) + rho) << LOG2R) + g)] = v[k];
    __syncthreads();

    // Item f: Z and its partner, read from the buffer, and its bin.
    auto read = [&](int f, float2& zk, float2& zr) {
        const int gq = f & (R - 1), q = (f >> LOG2R) & (W - 1), k2 = f >> LOG2P;
        const bool self = rank == 0 && (q & (H - 1)) == 0;
        const int pq = self ? q : q ^ H;
        const int pk = self && q == 0 ? (N2 - k2) & (N2 - 1) : N2 - 1 - k2;
        zk = smem[slot(f)];
        zr = smem[slot((((pk << LOG2W) + pq) << LOG2R) + gq)];
    };
    auto bin = [&](int f) {
        return M::row(rank, (f >> LOG2R) & (W - 1)) + ((long long)(f >> LOG2P) << LOG2N1);
    };
    // Split and store, four items a batch: their eight reads, then their
    // stores.  At an odd row count (output rows off 16 bytes) lanes 2f and
    // 2f + 1 split item f and store A and B, so a warp's store is still 16*R
    // contiguous bytes of an output row, 8 bytes a lane.
    const bool vec = (rows & 1) == 0 && (reinterpret_cast<unsigned long long>(out) & 15) == 0;
    if (vec) {
#pragma unroll
        for (int first = 0; first < 8; first += 4) {
            float2 zk[4], zr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) read(threadIdx.x + (first + i) * THREADS, zk[i], zr[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int f = threadIdx.x + (first + i) * THREADS;
                const long long p = p0 + (f & (R - 1));
                if (p < pairs)
                    store_split<true>(out, p, bin(f), split_a(zk[i], zr[i]),
                                      split_b(zk[i], zr[i]), rows, rows, true);
            }
        }
    } else {
        const int half = threadIdx.x & 1;
#pragma unroll
        for (int first = 0; first < 16; first += 4) {
            float2 zk[4], zr[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                read((threadIdx.x >> 1) + (first + i) * (THREADS / 2), zk[i], zr[i]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const int f = (threadIdx.x >> 1) + (first + i) * (THREADS / 2);
                const long long col = 2 * (p0 + (f & (R - 1))) + half;
                if (col < rows)
                    out[bin(f) * rows + col] = half ? split_b(zk[i], zr[i])
                                                    : split_a(zk[i], zr[i]);
            }
        }
    }
    // Bin n/2: row 0's bin N2/2 of each pair, its own partner, on rank 0.
    if (rank == 0 && threadIdx.x < R && p0 + threadIdx.x < pairs) {
        const float2 z = smem[slot(((N2 / 2) << LOG2P) + threadIdx.x)];
        store_split<true>(out, p0 + threadIdx.x, HALF, split_a(z, z), split_b(z, z), rows,
                          rows, vec);
    }
}

// Clusters of this shape the card can hold at once: set by the first launch
// (tstore::launch), 0 before.
template <int LOG2N1, int LOG2N2, int LOG2C, int LOG2R, bool TRANSPOSED = false>
int& packed_occupancy() {
    static int active = 0;
    return active;
}

// One launch over ceil(pairs / R) clusters of packed_cluster_kernel (K3's
// row-major split) or, TRANSPOSED, packed_transpose_kernel (K4's).  Returns
// a CUDA error code (0 = launched).
template <int LOG2N1, int LOG2N2, int LOG2C, int LOG2R, bool TRANSPOSED = false>
int launch_packed(const void* in, void* out, long long rows, cudaStream_t stream) {
    using CP = ClusterPlan<LOG2N1, LOG2N2, LOG2C, LOG2R>;
    auto kernel = [] {   // the other kernel is not instantiated
        if constexpr (TRANSPOSED) return packed_transpose_kernel<LOG2N1, LOG2N2, LOG2C, LOG2R>;
        else return packed_cluster_kernel<LOG2N1, LOG2N2, LOG2C, LOG2R>;
    }();
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
    const long long pairs = (rows + 1) / 2;
    return repro::tstore::launch<CP::C>(
        kernel, ((pairs + CP::R - 1) >> LOG2R) << LOG2C, CP::THREADS, smem, stream,
        &packed_occupancy<LOG2N1, LOG2N2, LOG2C, LOG2R, TRANSPOSED>(), (const float*)in,
        (float2*)out, rows);
}

}  // namespace
