// K4 at n = 16384 as persistent CTAs in clusters of 4, for Hopper
// (sm_90a): the second of the two designs tried for the fused real row FFT
// -> transposed store at its longest row, out[k, r] = DFT_n(in[r, :])[k]
// for k < n/2 + 1 and every row r of a (rows, n) float32 matrix, out (n/2 +
// 1, rows) interleaved complex64.  It lost to the cluster design that the
// library builds (src/repro_torch/kernels/csrc/rfft_rows_transpose_16k.cu;
// PERF.md), so no source of the library includes this file:
// examples/kernel_check_torch.py builds it out of the library as a variant
// (RFFT_TRANSPOSE_PERSISTENT_VARIANTS), beside a copy of the library's
// sources, and times it.
//
// The TPU kernel it would replace: `rfft_rows_transpose_pallas` of
// src/repro/kernels/fused/real.py at n = 16384.  Bound on this card: bytes
// (rows*n*4 read, rows*(n/2 + 1)*8 written).
//
// The design: K3's persistent loop (rfft_rows_16k.cu) inside the clusters
// of the register kernel (rfft_rows_transpose.cu at LOG2N = 14).  As many
// clusters of 4 CTAs of 1024 threads as the card holds at once
// (cudaOccupancyMaxActiveClusters), one CTA an SM, and no more than the
// groups of 4 pairs need; cluster q takes groups q, q + clusters, ..., CTA
// rank r pair 4*group + r.  Right after a pair's loads, thread 0 copies the
// CTA's next pair's row a and kStaged slices of 1024 floats of its row b
// into shared memory beside the exchange buffer (cp.async.bulk on an
// mbarrier) and prefetches the rest of b into L2, so those loads are in
// flight while the current pair's passes, cluster store and barriers run.
// The passes are regfft's Plan<14>; Z goes once to the buffer (one pair,
// unswizzled); after a cluster barrier rank r stores bins r*S ... r*S + S -
// 1 of the 4 pairs, reading the others' Z through map_shared_rank, the pair
// fastest: 64 contiguous bytes of an output row.  The second barrier keeps
// the next pair's passes off a buffer another CTA still reads.  The bulk
// copies need a 16-byte aligned input: the entry refuses any other.

#include <cstdint>

#include "fourstep.cuh"
#include "rfft_rows_16k.cu"

namespace {

constexpr int kPersistentCluster = 4;

__global__ void __launch_bounds__(1024, 1)
rfft_transpose_persistent_kernel(const float* __restrict__ in, float2* __restrict__ out,
                                 long long rows) {
    using PP = PersistentPlan;
    constexpr int N = PP::N, G = PP::G, R = 16, NH = N / 2 + 1, C = kPersistentCluster;
    constexpr int S = (NH + C - 1) / C;
    extern __shared__ float2 smem[];
    float* stage = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + PP::EXCHANGE_BYTES);
    const unsigned bar = shared_addr(stage + PP::STAGE_FLOATS);
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    const int t = threadIdx.x;
    const long long pairs = (rows + 1) / 2;
    const long long groups = (pairs + C - 1) / C;
    const long long step = gridDim.x / C;
    const bool vec = (rows & 1) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
    auto stage_pair = [&](long long q) {
        const float* src = in + ((2 * q) << 14);
        const bool b = 2 * q + 1 < rows;
        bulk_copy<PP::CHUNK>(stage, src, 4u * (b ? N + kStaged * G : N), bar);
        if (b && kStaged < 16)
            prefetch_l2<PP::CHUNK>(src + N + kStaged * G, 4u * (16 - kStaged) * G);
    };
    if (t == 0) {
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(bar) : "memory");
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    long long grp = blockIdx.x / C;
    if (t == 0 && grp * C + rank < pairs) stage_pair(grp * C + rank);
    unsigned parity = 0;
    for (; grp < groups; grp += step) {
        const long long p = grp * C + rank, next = (grp + step) * C + rank;
        const bool has_a = p < pairs, has_b = 2 * p + 1 < rows;
        float re[R], im[R];
        const float* xb = in + ((2 * p + 1) << 14) + t;
        if (has_a) {
            mbarrier_wait(bar, parity);
            parity ^= 1;
        }
#pragma unroll
        for (int k = 0; k < R; ++k) re[k] = has_a ? stage[t + k * G] : 0.0f;
#pragma unroll
        for (int k = 0; k < R; ++k)
            im[k] = !has_b ? 0.0f : k < kStaged ? stage[N + t + k * G] : xb[k * G];
        __syncthreads();  // every thread has read the staging area
        if (t == 0 && next < pairs) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            stage_pair(next);
        }
        float2 v[R];
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = make_float2(re[k], im[k]);
        repro::regfft::fft_row<14, false>(v, smem, 0, t);
        __syncthreads();  // the last exchange's reads are done
#pragma unroll
        for (int c = 0; c < R; ++c) smem[t + c * G] = v[c];
        cluster.sync();  // every CTA's Z is in its buffer

        // Rank r stores bins r*S ... r*S + S - 1 of the C pairs, idx = (k -
        // r*S)*C + q with the pair q fastest, reading Z_q from CTA q.
        const long long first = grp * C;
#pragma unroll
        for (int c = 0; c < (S * C + G - 1) / G; ++c) {
            const int idx = t + c * G;
            const int q = idx & (C - 1);
            const int k = rank * S + (idx >> 2);
            if (idx >= S * C || k >= NH || first + q >= pairs) continue;
            const float2* z = cluster.map_shared_rank(smem, q);
            const float2 zk = z[k], zr = z[(N - k) & (N - 1)];
            store_split<true>(out, first + q, k, split_a(zk, zr), split_b(zk, zr), rows, rows,
                              vec);
        }
        cluster.sync();  // no CTA writes its buffer while another still reads it
    }
}

// Clusters of the persistent kernel the card holds at once: set by the first
// launch, 0 before.
int& persistent_transpose_occupancy() {
    static int active = 0;
    return active;
}

// One launch of min(active clusters, groups of 4 pairs) clusters.  Returns a
// CUDA error code (0 = launched; cudaErrorInvalidValue for an input off 16
// bytes).
int launch_persistent_transpose(const void* in, void* out, long long rows,
                                cudaStream_t stream) {
    using PP = PersistentPlan;
    constexpr int C = kPersistentCluster;
    if (rows <= 0) return 0;
    if (reinterpret_cast<uintptr_t>(in) % 16 != 0) return (int)cudaErrorInvalidValue;
    auto kernel = rfft_transpose_persistent_kernel;
    static int configured_smem = 48 * 1024;
    int err = repro::allow_dynamic_smem(kernel, &configured_smem, (int)PP::SMEM);
    if (err != 0) return err;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(C);
    config.blockDim = dim3(1024);
    config.dynamicSmemBytes = (size_t)PP::SMEM;
    config.stream = stream;
    cudaLaunchAttribute cluster;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = C;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    config.attrs = &cluster;
    config.numAttrs = 1;
    int& active = persistent_transpose_occupancy();
    if (active == 0) {
        cudaError_t e = cudaOccupancyMaxActiveClusters(&active, kernel, &config);
        if (e != cudaSuccess) return (int)e;
        if (active <= 0) return (int)cudaErrorInvalidConfiguration;
    }
    const long long groups = ((rows + 1) / 2 + C - 1) / C;
    config.gridDim = dim3((unsigned)((groups < active ? groups : active) * C));
    cudaError_t e = cudaLaunchKernelEx(&config, kernel, (const float*)in, (float2*)out, rows);
    return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

}  // namespace
