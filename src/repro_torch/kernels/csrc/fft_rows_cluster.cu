// Batched row FFT of long rows for Hopper (sm_90a), K1b at n = 32768 ...
// 2^18: out[r, :] = DFT_n(in[r, :]) for every row r of a (rows, n) matrix of
// interleaved complex64, forward or inverse (inverse scaled by 1/n), in one
// launch over thread-block clusters (fourstep_cluster.cuh): a cluster a row,
// the four-step's intermediate in the cluster's shared memory.  Rows of 2^19
// and longer (4 MiB, more than 16 x 227 KB) take the two passes of
// fft_rows_large.cu.
//
// Replaces the TPU kernel `fft_rows_pallas` (body `_fft_kernel`) of
// src/repro/kernels/fft/kernel.py at these lengths, where that kernel holds a
// row in VMEM and one H100 CTA cannot.
//
// Bound on this card: bytes (rows*n*8 read and as many written), which this
// design moves once each way; fourstep_cluster.cuh says how.
//
// The shape follows from n (mirrored by kernels/fft/large.py::cluster_plan):
// large_split(n)'s near-square split, n1 = 2^floor(log2 n / 2), over a
// cluster of 2^log2_ctas(log2 n) CTAs, each holding (n/C)*17/16 complex64.
// At 32768 and 65536 a portable cluster of 8: (128, 256) and (256, 256),
// 256 and 512 threads a CTA.  At 2^17 and 2^18 (rows of 1 and 2 MiB) a
// non-portable cluster of 16: (256, 512) at 2^17, 512 threads and 69632
// bytes a CTA, two CTAs an SM (so that one's epilogue overlaps the other's
// loads), W = 16 rows of B a rank, 128-byte runs in the store; (512, 512) at
// 2^18, 1024 threads and 139264 bytes, one CTA an SM, W = 32, 256-byte runs
// (8 CTAs would need 272 KiB a CTA there).

#include "fourstep_cluster.cuh"

namespace {

// log2 of the CTAs a cluster at n = 2^log2n.
constexpr int log2_ctas(int log2n) { return log2n <= 16 ? 3 : 4; }

template <int LOG2N, bool INV>
int launch_length(const void* in, void* out, long long rows, cudaStream_t stream) {
    return launch_cluster<LOG2N / 2, LOG2N - LOG2N / 2, log2_ctas(LOG2N), INV>(in, out, rows,
                                                                              stream);
}

}  // namespace

// One launch on `stream`; does not synchronise.  Returns a CUDA error code
// (0 = launched; cudaErrorInvalidValue for another n, or where a cluster
// cannot be placed on the card).  `in` and `out` are distinct (rows, n)
// complex64 buffers, n = 2^15, 2^16, 2^17 or 2^18.
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
    case 1 << 17:
        return inverse ? launch_length<17, true>(in, out, rows, s)
                       : launch_length<17, false>(in, out, rows, s);
    case 1 << 18:
        return inverse ? launch_length<18, true>(in, out, rows, s)
                       : launch_length<18, false>(in, out, rows, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
