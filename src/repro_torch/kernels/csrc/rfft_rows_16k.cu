// Batched real row FFT of rows of n = 16384 for Hopper (sm_90a), K3 at its
// longest row: out[r, k] = DFT_n(in[r, :])[k] for k < n/2 + 1 and every row r
// of a (rows, n) float32 matrix, out (rows, n/2 + 1) interleaved complex64,
// in one launch of one persistent CTA an SM.  Shorter rows stay on
// rfft_rows.cu.
//
// Replaces the TPU kernel `rfft_rows_pallas` (body `_rfft_kernel`) of
// src/repro/kernels/fft/real.py at n = 16384.  Same algorithm: rows a =
// in[2p], b = in[2p + 1] packed as z = a + i*b, one complex FFT Z, and the
// conjugate split A[k] = (Z[k] + conj Z[n-k]) / 2, B[k] = (Z[k] - conj
// Z[n-k]) / (2i).
//
// Bound on this card: bytes (rows*n*4 read, rows*(n/2 + 1)*8 written).  What
// held rfft_rows.cu back at this length: a pair takes regfft's Plan<14>,
// 1024 threads and 136 KiB, one CTA an SM, so while a CTA runs its passes
// and its epilogue (Z written to the buffer, a barrier, Z[k] and Z[n-k]
// read, two rows stored) no load is in flight on its SM, and the next CTA's
// loads start only when it has gone.  Here the pair, its passes and its
// split are rfft_rows.cu's kernel's at LOG2N = 14, but each CTA walks over
// the pairs p = blockIdx.x, blockIdx.x + gridDim.x, ... (min(pairs, SMs)
// CTAs) and the next pair's loads overlap the current pair's passes, split
// and stores: right after a pair's loads, thread 0 copies the next pair's
// row a and the first kStaged slices of 1024 floats of its row b into
// shared memory beside the exchange buffer (88 of the 91 KiB it leaves
// free; cp.async.bulk, which completes on an mbarrier) and asks for the
// rest of b to be prefetched into L2 (cp.async.bulk.prefetch.L2); at the
// top of the next pair the threads wait on the mbarrier and read the staged
// floats from shared memory, the rest from L2.  A warp reads 32 consecutive
// floats of the staging area (no bank conflict); the bulk copies are 16 KiB
// each.  An odd row count leaves the last pair without b: it is read as 0,
// neither staged nor prefetched, and B is not stored.  The bulk copies and
// the prefetch need 16-byte aligned global addresses: the entry refuses an
// `in` that is not (a row is 64 KiB, so every row is aligned as `in` is).
// Timed at 4096 x 16384 against rfft_rows.cu's register-resident kernel
// (from the parent tree), 4 slices staged, and the design that splits the
// pair over a cluster (PERF.md; examples/kernel_check_torch.py
// --rfft-rows-only builds the variants, the latter from its own header).
// tests/_torch_parity.py::k3_16k_model checks the pair schedule, the staging
// and every load and store index in float64.
// Shared memory: the exchange buffer, then the staging area and the
// mbarrier: 139264 + 4*(16384 + 1024*kStaged) + 16 bytes (229392 at
// kStaged = 6, the most that fits), one CTA an SM.

#include <cstdint>

#include "regfft.cuh"

namespace {

// Slices of 1024 floats of row b staged with the next pair's row a (the
// rest of b is prefetched into L2); kernels/fft/real.py::RFFT_16K_STAGED.
constexpr int kStaged = 6;

struct PersistentPlan {
    static constexpr int N = 1 << 14, G = 1024;
    static constexpr long long EXCHANGE_BYTES = 8 * repro::regfft::exchange_elems(1, N);
    static constexpr int STAGE_FLOATS = N + kStaged * G;
    static constexpr long long SMEM = EXCHANGE_BYTES + 4LL * STAGE_FLOATS + 16;
    static constexpr unsigned CHUNK = 16384;   // bytes a bulk copy or prefetch
    static_assert(kStaged >= 0 && kStaged <= 16, "slices of row b: 0 ... 16");
    static_assert(SMEM <= 232448, "the opt-in shared memory of one CTA");
};

__device__ __forceinline__ unsigned shared_addr(const void* p) {
    return (unsigned)__cvta_generic_to_shared(p);
}

// `bytes` (a multiple of 16) from `src` prefetched into L2, in chunks.
template <unsigned CHUNK>
__device__ __forceinline__ void prefetch_l2(const float* src, unsigned bytes) {
    for (unsigned off = 0; off < bytes; off += CHUNK) {
        const unsigned size = bytes - off < CHUNK ? bytes - off : CHUNK;
        asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n"
                     :: "l"(reinterpret_cast<const char*>(src) + off), "r"(size) : "memory");
    }
}

// `bytes` from `src` to shared `dst`, completing on the mbarrier at `bar`
// (which expects them: arrive.expect_tx first).
template <unsigned CHUNK>
__device__ __forceinline__ void bulk_copy(float* dst, const float* src, unsigned bytes,
                                          unsigned bar) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(bar), "r"(bytes) : "memory");
    for (unsigned off = 0; off < bytes; off += CHUNK) {
        const unsigned size = bytes - off < CHUNK ? bytes - off : CHUNK;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n"
            :: "r"(shared_addr(dst) + off), "l"(reinterpret_cast<const char*>(src) + off),
               "r"(size), "r"(bar) : "memory");
    }
}

__device__ __forceinline__ void mbarrier_wait(unsigned bar, unsigned parity) {
    unsigned done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred P;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, P;\n}\n"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__global__ void __launch_bounds__(1024, 1)
rfft_persistent_kernel(const float* __restrict__ in, float2* __restrict__ out,
                       long long rows) {
    using PP = PersistentPlan;
    using repro::regfft::pad;
    using repro::regfft::point_index;
    constexpr int N = PP::N, G = PP::G, R = 16, NH = N / 2 + 1;
    extern __shared__ float2 smem[];
    float* stage = reinterpret_cast<float*>(reinterpret_cast<char*>(smem) + PP::EXCHANGE_BYTES);
    const unsigned bar = shared_addr(stage + PP::STAGE_FLOATS);
    const int t = threadIdx.x;
    const long long pairs = (rows + 1) / 2;
    long long p = blockIdx.x;
    if (p >= pairs) return;
    auto stage_next = [&](long long q) {
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
    if (t == 0) stage_next(p);
    unsigned parity = 0;
    for (; p < pairs; p += gridDim.x) {
        const long long a = 2 * p, next = p + gridDim.x;
        const bool has_b = a + 1 < rows;
        float re[R], im[R];
        const float* xb = in + ((a + 1) << 14) + t;
        mbarrier_wait(bar, parity);
        parity ^= 1;
#pragma unroll
        for (int k = 0; k < R; ++k) re[k] = stage[t + k * G];
#pragma unroll
        for (int k = 0; k < R; ++k)
            im[k] = !has_b ? 0.0f : k < kStaged ? stage[N + t + k * G] : xb[k * G];
        __syncthreads();  // every thread has read the staging area
        if (t == 0 && next < pairs) {
            asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
            stage_next(next);
        }
        float2 v[R];
#pragma unroll
        for (int k = 0; k < R; ++k) v[k] = make_float2(re[k], im[k]);

        // rfft_rows.cu's passes and split at LOG2N = 14, the CTA's one pair at base 0.
        repro::regfft::fft_row<14, false>(v, smem, 0, t);
        __syncthreads();  // the last exchange's reads are done
#pragma unroll
        for (int k = 0; k < R; ++k) smem[point_index<G>(0, t, k)] = v[k];
        __syncthreads();
        float2* oa = out + a * NH;
        float2* ob = oa + NH;
#pragma unroll
        for (int c = 0; c < (NH + G - 1) / G; ++c) {
            const int k = t + c * G;
            if (k < NH) {
                const float2 zk = smem[point_index<G>(0, t, c)];
                const float2 zr = smem[pad((N - k) & (N - 1))];
                oa[k] = make_float2(0.5f * (zk.x + zr.x), 0.5f * (zk.y - zr.y));
                if (has_b) ob[k] = make_float2(0.5f * (zk.y + zr.y), 0.5f * (zr.x - zk.x));
            }
        }
        // The next pair's first exchange writes follow a barrier in fft_row.
    }
}

// One launch of min(pairs, SMs) persistent CTAs.  Returns a CUDA error code
// (0 = launched).
int launch_persistent(const void* in, void* out, long long rows, cudaStream_t stream) {
    using PP = PersistentPlan;
    auto kernel = rfft_persistent_kernel;
    static int configured_smem = 48 * 1024;
    static int sms = 0;
    int err = repro::allow_dynamic_smem(kernel, &configured_smem, (int)PP::SMEM);
    if (err != 0) return err;
    if (sms == 0) {
        int device = 0;
        err = (int)cudaGetDevice(&device);
        if (err == 0)
            err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
        if (err != 0) return err;
    }
    const long long pairs = (rows + 1) / 2;
    const unsigned grid = (unsigned)(pairs < sms ? pairs : sms);
    kernel<<<grid, 1024, (size_t)PP::SMEM, stream>>>((const float*)in, (float2*)out, rows);
    return (int)cudaGetLastError();
}

}  // namespace

// One launch on `stream`; does not synchronise.  Returns a CUDA error code
// (0 = launched; cudaErrorInvalidValue for another n or an `in` that is not
// 16-byte aligned).  `in` is (rows, n) float32, `out` a distinct
// (rows, n/2 + 1) complex64 buffer; n = 16384.
extern "C" int repro_rfft_rows_16k(const void* in, void* out, long long rows, int n,
                                   void* stream) {
    if (rows <= 0) return 0;
    if (n != 1 << 14 || reinterpret_cast<uintptr_t>(in) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    return launch_persistent(in, out, rows, (cudaStream_t)stream);
}
