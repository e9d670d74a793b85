// Fused real row FFT -> transposed store of rows of n = 16384 for Hopper
// (sm_90a), K4 at its longest row: out[k, r] = DFT_n(in[r, :])[k] for k <
// n/2 + 1 and every row r of a (rows, n) float32 matrix, out (n/2 + 1, rows)
// interleaved complex64, forward only, in one launch over thread-block
// clusters.  Shorter rows stay on rfft_rows_transpose.cu.
//
// Replaces the TPU kernel `rfft_rows_transpose_pallas` (body
// `_rfused_kernel`) of src/repro/kernels/fused/real.py at n = 16384.  Same
// algorithm: rows a = in[2p], b = in[2p + 1] packed as z = a + i*b, one
// complex FFT Z, and the conjugate split A[k] = (Z[k] + conj Z[n-k]) / 2,
// B[k] = (Z[k] - conj Z[n-k]) / (2i), stored to columns 2p and 2p + 1.
//
// Bound on this card: bytes (rows*n*4 read once, rows*(n/2 + 1)*8 written
// once; 0.1603 ms at 4096 x 16384 at 3.35 TB/s).  What held
// rfft_rows_transpose.cu back at this length: a pair took regfft's
// Plan<14>, 1024 threads and 136 KiB, one CTA an SM, in clusters of 4 CTAs
// whose store read the other CTAs' Z, so while a CTA ran its passes, its
// cluster store and two cluster barriers no load was in flight on its SM,
// and a new cluster started only when four SMs were free at once (0.38 ms
// back to back at 4096 x 16384 on an H100, PERF.md).  Here a pair is split
// over a cluster as K2 at 16384 splits a complex row
// (fft_rows_transpose_cluster.cu): rfft_rows_cluster.cuh's
// packed_transpose_kernel, the four-step n = n1*n2 = 32 * 512 of
// fourstep_cluster.cuh, 256 threads and 34816 bytes a CTA, four CTAs an SM,
// so that one CTA's passes and store overlap the others' loads (mirrored
// by kernels/fused/real.py::rfft_transpose_16k_plan).  A warp loads 32
// adjacent floats of row a and of row b; each point goes to the rank that
// owns its row of B's mirror slot, so rows k1 and n1 - k1 meet in one CTA
// and the split runs on chip; the store puts the cluster's pairs side by
// side in each output row, as K2's store puts its rows.
//
// The cluster: 8 CTAs of 2 pairs where the row count is a multiple of 4,
// so each bin's 4 real rows are one whole 32-byte sector of an output row;
// 16 CTAs of 4 pairs (a non-portable cluster) elsewhere, 64-byte runs, as
// 32-byte runs that start off a sector took 1.15-1.27x the time there.  At
// 4096 x 16384 the 8 of 2 took 0.26 ms back to back against 0.27-0.28 for
// the 16 of 4, 8 CTAs of 4 pairs at n1 = 64 (two CTAs an SM) 0.28, and
// the other design tried, persistent 1024-thread CTAs in clusters of 4
// staging their next pair by bulk copies (examples/
// rfft_rows_transpose_persistent.cuh), 0.38 (PERF.md).
// tests/_torch_parity.py::k4_16k_model checks every index in float64.
//
// An odd row count leaves the last pair without b: it is read as 0 and its
// column is not stored; pairs past the call's (a ragged last cluster) load
// zeros and store nothing.  There the output rows start off 16 bytes, so
// two lanes store a pair's A and B, 8 bytes each.

#include "rfft_rows_cluster.cuh"

namespace {

// The shapes at n = 16384 (kernels/fused/real.py::RFFT_TRANSPOSE_16K_*), n1
// = 2^kLog2N1 = 32 and n2 = 512 in both, 256 threads and 34816 bytes a CTA:
// 2^kLog2Ctas CTAs and 2^kLog2Pairs pairs a cluster where the row count is
// a multiple of 4, 2^kWideLog2Ctas and 2^kWideLog2Pairs elsewhere.
constexpr int kLog2N1 = 5;
constexpr int kLog2Ctas = 3;
constexpr int kLog2Pairs = 1;
constexpr int kWideLog2Ctas = 4;
constexpr int kWideLog2Pairs = 2;

}  // namespace

// One launch on `stream`; does not synchronise.  Returns a CUDA error code
// (0 = launched; cudaErrorInvalidValue for another n, or where a cluster
// cannot be placed on the card).  `in` is (rows, n) float32, `out` a
// distinct (n/2 + 1, rows) complex64 buffer; n = 16384.
extern "C" int repro_rfft_rows_transpose_16k(const void* in, void* out, long long rows, int n,
                                             void* stream) {
    if (rows <= 0) return 0;
    if (n != 1 << 14) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = (cudaStream_t)stream;
    if (rows % 4 == 0)
        return launch_packed<kLog2N1, 14 - kLog2N1, kLog2Ctas, kLog2Pairs, true>(
            in, out, rows, s);
    return launch_packed<kLog2N1, 14 - kLog2N1, kWideLog2Ctas, kWideLog2Pairs, true>(
        in, out, rows, s);
}
