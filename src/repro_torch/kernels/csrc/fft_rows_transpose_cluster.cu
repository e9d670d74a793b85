// Fused row FFT -> transposed store of long rows for Hopper (sm_90a), K2 at
// n = 16384 and K2b at 32768 and 65536: out[k, r] = DFT_n(in[r, :])[k] for
// every row r of a (rows, n) matrix of interleaved complex64, out of shape
// (n, rows) with row stride `out_stride`; forward or inverse (inverse scaled
// by 1/n), in one launch over thread-block clusters (fourstep_cluster.cuh):
// a cluster of 16 CTAs holds 4 neighbouring rows, the four-step's
// intermediate in the cluster's shared memory, and writes each (k1, k2) of
// the 4 rows as one 32-byte run of an output row.  Shorter rows take the
// register-resident fft_rows_transpose.cu, longer ones the two passes of
// fft_rows_transpose_large.cu.
//
// Replaces the TPU kernel `fft_rows_transpose_pallas` (body `_fused_kernel`)
// of src/repro/kernels/fused/kernel.py at these lengths, where that kernel
// holds a row in VMEM and one H100 CTA cannot, or (at 16384) only as a CTA
// that takes an SM alone.
//
// Bound on this card: bytes (rows*n*8 read and as many written), which this
// design moves once each way; fourstep_cluster.cuh says how.
//
// The shape follows from n (mirrored by kernels/fused/large.py::
// transpose_cluster_plan): 2^kLog2Ctas CTAs and 2^kLog2Rows signal rows a
// cluster (16 is a non-portable cluster size, which the card takes), and
// the split n2 = 32 * 16 = 512, so that each rank loads 32 columns: (32,
// 512) at 16384, 256 threads and 34816 bytes of shared memory a CTA, four
// CTAs an SM, each rank 2 rows of B a signal row; (64, 512) at 32768, 512
// threads and 69632 bytes, two CTAs an SM; (128, 512) at 65536, 1024
// threads and 139264 bytes, one CTA an SM.  Four rows make the store's runs
// whole sectors; two, half sectors, took 2.4x the time at 32768, and a
// 16-CTA cluster of 8 rows, or 8 CTAs of 4 rows of the near-square split,
// one 1024-thread CTA an SM, more.  At 16384 the register-resident kernel
// (Plan<14>: 1024 threads and 136 KiB a row, one CTA an SM, so no load was
// in flight while a CTA ran its cluster store) took 0.70 ms at 4096 rows
// against this shape's 0.55; at the 16384 rows of the main path 8 CTAs of
// 4 rows (n1 = 64 or 32) took 8-12 % longer and 8 rows a cluster 17-28 %,
// though 8 rows a cluster won by 19 % at an odd output stride (PERF.md).

#include "fourstep_cluster.cuh"

namespace {

constexpr int kLog2Ctas = 4;
constexpr int kLog2Rows = 2;
constexpr int kLog2N2 = kLog2Ctas + 5;   // 32 columns a rank

template <int LOG2N, bool INV>
int launch_length(const void* in, void* out, long long rows, long long out_stride,
                  cudaStream_t stream) {
    return launch_cluster<LOG2N - kLog2N2, kLog2N2, kLog2Ctas, INV, kLog2Rows, true>(
        in, out, rows, stream, out_stride);
}

}  // namespace

// One launch on `stream`; does not synchronise.  Returns a CUDA error code
// (0 = launched; cudaErrorInvalidValue for another n or an out_stride below
// rows, or where a cluster cannot be placed on the card).  `in` is (rows, n)
// complex64; `out` the first of `rows` columns of an (n, out_stride) buffer,
// distinct from `in`; n = 16384, 32768 or 65536.
extern "C" int repro_fft_rows_transpose_cluster(const void* in, void* out, long long rows,
                                                int n, int inverse, long long out_stride,
                                                void* stream) {
    if (rows <= 0) return 0;
    if (out_stride < rows) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (n) {
    case 1 << 14:
        return inverse ? launch_length<14, true>(in, out, rows, out_stride, s)
                       : launch_length<14, false>(in, out, rows, out_stride, s);
    case 1 << 15:
        return inverse ? launch_length<15, true>(in, out, rows, out_stride, s)
                       : launch_length<15, false>(in, out, rows, out_stride, s);
    case 1 << 16:
        return inverse ? launch_length<16, true>(in, out, rows, out_stride, s)
                       : launch_length<16, false>(in, out, rows, out_stride, s);
    default:
        return (int)cudaErrorInvalidValue;
    }
}
