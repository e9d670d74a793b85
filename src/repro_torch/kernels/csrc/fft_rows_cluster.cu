// Batched row FFT of long rows for Hopper (sm_90a), K1b at n = 32768 and
// 65536: out[r, :] = DFT_n(in[r, :]) for every row r of a (rows, n) matrix of
// interleaved complex64, forward or inverse (inverse scaled by 1/n), in one
// launch over thread-block clusters (fourstep_cluster.cuh): a cluster a row,
// the four-step's intermediate in the cluster's shared memory.  Longer rows
// take the two passes of fft_rows_large.cu.
//
// Replaces the TPU kernel `fft_rows_pallas` (body `_fft_kernel`) of
// src/repro/kernels/fft/kernel.py at these lengths, where that kernel holds a
// row in VMEM and one H100 CTA cannot.
//
// Bound on this card: bytes (rows*n*8 read and as many written), which this
// design moves once each way; fourstep_cluster.cuh says how.
//
// The shape follows from n (mirrored by kernels/fft/large.py::cluster_plan):
// a cluster of 2^kLog2Ctas CTAs and large_split(n)'s near-square split, n1 =
// 2^floor(log2 n / 2): (128, 256) at 32768, (256, 256) at 65536.

#include "fourstep_cluster.cuh"

namespace {

constexpr int kLog2Ctas = 3;

template <int LOG2N, bool INV>
int launch_length(const void* in, void* out, long long rows, cudaStream_t stream) {
    return launch_cluster<LOG2N / 2, LOG2N - LOG2N / 2, kLog2Ctas, INV>(in, out, rows, stream);
}

}  // namespace

// One launch on `stream`; does not synchronise.  Returns a CUDA error code
// (0 = launched; cudaErrorInvalidValue for another n, or where a cluster
// cannot be placed on the card).  `in` and `out` are distinct (rows, n)
// complex64 buffers, n = 32768 or 65536.
extern "C" int repro_fft_rows_cluster(const void* in, void* out, long long rows, int n,
                                      int inverse, void* stream) {
    if (rows <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (n) {
    case 1 << 15:
        return inverse ? launch_length<15, true>(in, out, rows, s)
                       : launch_length<15, false>(in, out, rows, s);
    case 1 << 16:
        return inverse ? launch_length<16, true>(in, out, rows, s)
                       : launch_length<16, false>(in, out, rows, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
