// The transposed store of the fused row kernels for Hopper (sm_90a):
// fft_rows_transpose.cu (complex rows) and rfft_rows_transpose.cu (packed
// real pairs).  Both run regfft.cuh's passes and then write bin k of row r to
// out[k*rows + r], so one row alone gives each output row one element: the
// rows must be stored side by side to write whole sectors.  What they share:
//
// - Swizzle: the slot of bin k of the CTA's row p in the buffer that takes
//   the transformed rows from the registers of the passes, f = k*P + p with
//   P rows a CTA, so that both the writes from registers and the store's
//   reads (row fastest) are free of bank conflicts.
// - store_cluster: where a whole CTA's rows still make less than a 32-byte
//   sector per output row, the CTAs run in thread-block clusters and each
//   stores a slice of the bins for the rows of all of them, read through
//   distributed shared memory (map_shared_rank).
// - launch: the grid padded to a multiple of the cluster and launched in
//   clusters (cudaLaunchKernelEx), or alone.

#pragma once

#include "regfft.cuh"

namespace repro {
namespace tstore {

// Slot of element f = k*P + p of the buffer; P = 2^log2_rows.  A half-warp's
// writes vary the low min(LG, 4) bits of k (LG = log2 of the threads of a
// row) and, below 16 threads a row, the low 4 - LG bits of p.  The slot is
// f ^ h(f >> 4): h moves the bits of the 16-slot block number that vary
// across those writes (16 bins a thread group apart) into the bank bits
// that are fixed there, and leaves the bits at and above log2 P alone.  The
// store's reads, 16 consecutive f or a run that crosses one 16-slot block
// per half-warp, stay conflict-free; unswizzled, the writes conflict up to
// 16-way (n = 256, 16 rows a CTA).  tests/_torch_parity.py (k4_swizzle,
// k4_store_model, k2_store_model) checks every plan on the CPU.
template <int LOG2N>
struct Swizzle {
    static constexpr int LG = LOG2N < 4 ? 0 : LOG2N - 4;
    static constexpr int LANES_K = LG < 4 ? LG : 4;
    int s, mask;
    __device__ explicit Swizzle(int log2_rows) {
        const int bits = log2_rows >= 4 ? LANES_K : LANES_K + log2_rows - 4;
        s = log2_rows >= 4 ? log2_rows - 4 : 0;
        mask = bits > 0 ? (1 << bits) - 1 : 0;
    }
    __device__ __forceinline__ int operator()(int f) const {
        return f ^ (((f >> 4 >> s) & mask) << (4 - LANES_K));
    }
};

// CTAs of a cluster for a kernel that stores UNIT bytes of each row per
// output row: where the Plan<LOG2N>::MAX_ROWS rows of a whole CTA make less
// than a 32-byte sector, `ctas_at_one_row` / MAX_ROWS CTAs (as many rows side
// by side as that many CTAs of one row); 1 (no cluster) elsewhere.
template <int LOG2N, int UNIT>
__host__ __device__ constexpr int store_cluster(int ctas_at_one_row) {
    return regfft::Plan<LOG2N>::MAX_ROWS * UNIT < 32
               ? ctas_at_one_row / regfft::Plan<LOG2N>::MAX_ROWS : 1;
}

// Launches `kernel` over `ctas` CTAs of `threads` threads and `smem` bytes of
// dynamic shared memory on `stream`: alone when C = 1, else in clusters of C
// CTAs over a grid padded to a multiple of C, after checking once
// (`*active_clusters`, 0 at first, one per kernel) that a cluster of this
// shape fits on the card.  Returns a CUDA error code (0 = launched).
template <int C, typename... Params, typename... Args>
int launch(void (*kernel)(Params...), long long ctas, int threads, long long smem,
           cudaStream_t stream, int* active_clusters, Args... args) {
    const long long blocks = (ctas + C - 1) / C * C;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
    if constexpr (C == 1) {
        kernel<<<(unsigned)blocks, threads, (size_t)smem, stream>>>(args...);
        return (int)cudaGetLastError();
    } else {
        cudaLaunchConfig_t config = {};
        config.gridDim = dim3((unsigned)blocks);
        config.blockDim = dim3((unsigned)threads);
        config.dynamicSmemBytes = (size_t)smem;
        config.stream = stream;
        cudaLaunchAttribute cluster;
        cluster.id = cudaLaunchAttributeClusterDimension;
        cluster.val.clusterDim.x = C;
        cluster.val.clusterDim.y = 1;
        cluster.val.clusterDim.z = 1;
        config.attrs = &cluster;
        config.numAttrs = 1;
        if (*active_clusters == 0) {
            cudaError_t e = cudaOccupancyMaxActiveClusters(active_clusters, kernel, &config);
            if (e != cudaSuccess) return (int)e;
            if (*active_clusters <= 0) return (int)cudaErrorInvalidConfiguration;
        }
        cudaError_t e = cudaLaunchKernelEx(&config, kernel, args...);
        return (int)(e != cudaSuccess ? e : cudaGetLastError());
    }
}

}  // namespace tstore
}  // namespace repro
