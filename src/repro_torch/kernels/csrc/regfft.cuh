// Register-resident Stockham FFT of length n = 2^LOG2N for Hopper (sm_90a).
//
// A group of GROUP threads owns one row; thread t of the group holds the
// POINTS = n / GROUP points x[t + k*GROUP], k < POINTS, in registers
// (POINTS = 16, or n when n < 16).  Every pass is a Stockham autosort pass
// of the stage loop in kernels/fft/kernel.py, with the row viewed as
// (ncur, s): butterfly i = j*s + q reads x[i + u*n/r] and writes
// y[(j*r + u)*s + q] = w_j^u * sum_v x_v * omega_r^(u v),
// w_j = exp(sign*2*pi*i*j/ncur).  With i = t + b*GROUP, the points a thread
// reads are always its own x[t + k*GROUP], so the passes run inside the
// thread and shared memory only exchanges points between passes.
//
// Pass plan: log2 n = 4q + r gives q radix-16 passes and, when r > 0, one
// radix-2^r pass in which each thread runs 16 / 2^r butterflies (below
// n = 16, one radix-n pass).  At n = 8192: 512 threads, radices 16.16.16.2,
// three exchanges; at n = 16384 (Plan<14>, the largest instantiated):
// 1024 threads, radices 16.16.16.4, three exchanges.  The last pass has ncur = r, so j = 0 and no twiddle, and
// its outputs y[t + k*GROUP] are in natural order: no bit reversal.
//
// The radix-16 butterfly is two in-register radix-4 stages with the
// omega_16 constants as literals.  Twiddles: two sincospif per thread per
// pass, on the exact arguments 2j/ncur and 8j/ncur (ncur is a power of two),
// the other powers w^u = w^(u mod 4) * (w^4)^(u div 4) by products.
// sincospif, not __sincosf and not a table: the argument 2j/ncur is exact in
// float, sincospif reduces it in units of pi without rounding and is good to
// about 1 ulp for every j, whereas __sincosf loses absolute accuracy as |x|
// grows towards 2*pi, which a length-8192 transform would show (so no
// -use_fast_math either).  A table would add a read stream to kernels bound
// by bytes, so the arithmetic stays until measured otherwise.
//
// Exchange buffer: one per CTA, rows side by side (row r at r*n), used in
// place: __syncthreads, write, __syncthreads, read.  Element f is stored at
// f + f/16.  Unpadded, the write y[(j*16 + u)*s + q] at s = 1 puts the 16
// threads of a half-warp 16 float2 apart, one bank: a 16-way conflict.  With
// the padding every exchange write and read of every plan is conflict-free
// (checked on the CPU by the model of the passes in tests/_torch_parity.py).
//
// Every thread of the CTA must call fft_row: the exchange synchronises the
// CTA.  A caller with no row for a thread passes zeros and stores nothing.

#pragma once

#include <cuda_runtime.h>

namespace repro {

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
    return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
    return make_float2(a.x - b.x, a.y - b.y);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cscale(float2 a, float k) {
    return make_float2(a.x * k, a.y * k);
}

// Opt in to more than 48 KiB of dynamic shared memory, once per kernel and
// process; returns a CUDA error code (0 = success).
template <typename Kernel>
inline int allow_dynamic_smem(Kernel kernel, int* configured, int bytes) {
    if (bytes <= *configured) return 0;
    int device = 0, limit = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err != cudaSuccess) return (int)err;
    if (bytes > limit) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (err != cudaSuccess) return (int)err;
    *configured = limit;
    return 0;
}

namespace regfft {

constexpr int kMaxPoints = 16;
constexpr int kCtaThreads = 256;   // aimed at when a row needs fewer threads

template <int LOG2N>
struct Plan {
    static constexpr int N = 1 << LOG2N;
    static constexpr int POINTS = N < kMaxPoints ? N : kMaxPoints;
    static constexpr int GROUP = N / POINTS;               // threads per row
    static constexpr int RADIX16_PASSES = N < kMaxPoints ? 0 : LOG2N / 4;
    static constexpr int TAIL_LOG2 = N < kMaxPoints ? LOG2N : LOG2N % 4;  // 0: no tail
    static constexpr int MAX_ROWS = GROUP >= kCtaThreads ? 1 : kCtaThreads / GROUP;
    static constexpr int MAX_THREADS = MAX_ROWS * GROUP;
    // Registers a thread may take: twice its points' 2*POINTS, at least 32.
    // With 16 points that is 64: two CTAs of 512 threads (or four of 256)
    // share an SM.
    static constexpr int MIN_BLOCKS =
        65536 / (MAX_THREADS * (4 * POINTS > 32 ? 4 * POINTS : 32));
};

// Padded index of element f of the exchange buffer.
__device__ __forceinline__ int pad(int f) { return f + (f >> 4); }

// Padded index of a thread's point k, element base + t + k*G of its row:
// pad(f + d) = pad(f) + pad(d) when d is a multiple of 16, so for G a
// multiple of 16 the k-dependent part is a constant (an immediate offset).
template <int G>
__device__ __forceinline__ int point_index(int base, int t, int k) {
    if constexpr (G % 16 == 0) return pad(base + t) + k * (G + G / 16);
    else return pad(base + t + k * G);
}

// float2 elements of the exchange buffer for `rows` rows of length n.
__host__ __device__ constexpr long long exchange_elems(long long rows, int n) {
    return rows * n + (rows * n + 15) / 16;
}

__host__ __device__ constexpr float cos16(int e) {  // cos(pi*e/8), e < 10
    return e == 0 ? 1.0f : e == 1 ? 0.92387953251128674f : e == 2 ? 0.70710678118654752f
         : e == 3 ? 0.38268343236508977f : e == 4 ? 0.0f : e == 5 ? -0.38268343236508977f
         : e == 6 ? -0.70710678118654752f : e == 7 ? -0.92387953251128674f
         : e == 8 ? -1.0f : -0.92387953251128674f;
}

__host__ __device__ constexpr float sin16(int e) {  // sin(pi*e/8) = cos(pi*(e-4)/8)
    return cos16(e < 4 ? 4 - e : e - 4);
}

// a * omega_16^e, omega_16 = exp(sign*2*pi*i/16); e is a constant after
// unrolling, so the branches fold.
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 a, int e) {
    constexpr float sign = INV ? 1.0f : -1.0f;
    if (e == 0) return a;
    if (e == 4) return make_float2(-sign * a.y, sign * a.x);
    return cmul(a, make_float2(cos16(e), sign * sin16(e)));
}

template <bool INV>
__device__ __forceinline__ void dft2(float2 (&x)[2]) {
    const float2 a = x[0];
    x[0] = cadd(a, x[1]);
    x[1] = csub(a, x[1]);
}

template <bool INV>
__device__ __forceinline__ void dft4(float2 (&x)[4]) {
    constexpr float sign = INV ? 1.0f : -1.0f;
    const float2 e0 = cadd(x[0], x[2]);
    const float2 e1 = csub(x[0], x[2]);
    const float2 o0 = cadd(x[1], x[3]);
    const float2 d3 = csub(x[1], x[3]);
    const float2 o1 = make_float2(-sign * d3.y, sign * d3.x);   // omega_4 = sign*i
    x[0] = cadd(e0, o0);
    x[1] = cadd(e1, o1);
    x[2] = csub(e0, o0);
    x[3] = csub(e1, o1);
}

template <bool INV>
__device__ __forceinline__ void dft8(float2 (&x)[8]) {
    float2 e[4] = {x[0], x[2], x[4], x[6]};
    float2 o[4] = {x[1], x[3], x[5], x[7]};
    dft4<INV>(e);
    dft4<INV>(o);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
        const float2 w = rot16<INV>(o[u], 2 * u);             // omega_8^u * O[u]
        x[u] = cadd(e[u], w);
        x[u + 4] = csub(e[u], w);
    }
}

// Natural order in and out: k = k1 + 4*k2, u = u1 + 4*u2.
template <bool INV>
__device__ __forceinline__ void dft16(float2 (&x)[16]) {
    float2 y[16];
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
        float2 a[4] = {x[k1], x[k1 + 4], x[k1 + 8], x[k1 + 12]};
        dft4<INV>(a);
#pragma unroll
        for (int u1 = 0; u1 < 4; ++u1) y[4 * k1 + u1] = rot16<INV>(a[u1], u1 * k1);
    }
#pragma unroll
    for (int u1 = 0; u1 < 4; ++u1) {
        float2 b[4] = {y[u1], y[4 + u1], y[8 + u1], y[12 + u1]};
        dft4<INV>(b);
#pragma unroll
        for (int u2 = 0; u2 < 4; ++u2) x[u1 + 4 * u2] = b[u2];
    }
}

template <int RADIX, bool INV>
__device__ __forceinline__ void dft(float2 (&x)[RADIX]) {
    if constexpr (RADIX == 2) dft2<INV>(x);
    else if constexpr (RADIX == 4) dft4<INV>(x);
    else if constexpr (RADIX == 8) dft8<INV>(x);
    else dft16<INV>(x);
}

// x[u] *= w^u, w = exp(sign*2*pi*i*j/ncur), ncur = 2^log2ncur.
template <bool INV>
__device__ __forceinline__ void twiddle16(float2 (&x)[16], int j, int log2ncur) {
    constexpr float sign = INV ? 1.0f : -1.0f;
    // sign / ncur, exact: the float with exponent -log2ncur.
    const float step = sign * __int_as_float((127 - log2ncur) << 23);
    float sn, cs;
    sincospif(2.0f * (float)j * step, &sn, &cs);
    const float2 w1 = make_float2(cs, sn);
    sincospif(8.0f * (float)j * step, &sn, &cs);
    const float2 w4 = make_float2(cs, sn);
    const float2 w2 = cmul(w1, w1);
    const float2 w8 = cmul(w4, w4);
    const float2 lo[4] = {make_float2(1.0f, 0.0f), w1, w2, cmul(w2, w1)};
    const float2 hi[4] = {make_float2(1.0f, 0.0f), w4, w8, cmul(w8, w4)};
#pragma unroll
    for (int u = 1; u < 16; ++u) {
        const int l = u & 3, h = u >> 2;
        const float2 w = l == 0 ? hi[h] : h == 0 ? lo[l] : cmul(lo[l], hi[h]);
        x[u] = cmul(x[u], w);
    }
}

// The radix-16 passes of a row of length n = 2^LOG2N >= 16, each but the
// last of the transform followed by its twiddles and an exchange.
template <int LOG2N, bool INV>
__device__ __forceinline__ void radix16_passes(float2 (&v)[16], float2* buf, int base,
                                               int t) {
    using P = Plan<LOG2N>;
#pragma unroll
    for (int pass = 0; pass < P::RADIX16_PASSES; ++pass) {
        dft16<INV>(v);
        if (pass == P::RADIX16_PASSES - 1 && P::TAIL_LOG2 == 0) break;  // natural order
        const int log2s = 4 * pass;
        const int j = t >> log2s;
        const int q = t & ((1 << log2s) - 1);
        twiddle16<INV>(v, j, LOG2N - log2s);
        // Slot u goes to y[(j*16 + u)*s + q]: f0 = base + j*16*s + q is a
        // multiple of 16 at s = 1 and u*s is one at s >= 16, so the padded
        // index is pad(f0) plus a constant.
        const int p0 = pad(base + ((j << 4) << log2s) + q);
        __syncthreads();  // the previous exchange's reads are done
#pragma unroll
        for (int u = 0; u < 16; ++u) buf[p0 + pad(u << log2s)] = v[u];
        __syncthreads();
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = buf[point_index<P::GROUP>(base, t, k)];
    }
}

// The transform of one row.  In: v[k] = x[t + k*GROUP].  Out: v[k] =
// X[t + k*GROUP], scaled by 1/n when INV.  buf is the CTA's exchange buffer,
// base = (row within the CTA) * n.  Does not leave the result in buf.
template <int LOG2N, bool INV>
__device__ __forceinline__ void fft_row(float2 (&v)[Plan<LOG2N>::POINTS], float2* buf,
                                        int base, int t) {
    using P = Plan<LOG2N>;
    if constexpr (P::RADIX16_PASSES > 0) radix16_passes<LOG2N, INV>(v, buf, base, t);
    if constexpr (P::TAIL_LOG2 > 0) {
        constexpr int r = 1 << P::TAIL_LOG2;
        constexpr int B = P::POINTS / r;   // butterflies a thread runs
#pragma unroll
        for (int b = 0; b < B; ++b) {
            float2 w[r];
#pragma unroll
            for (int u = 0; u < r; ++u) w[u] = v[b + u * B];
            dft<r, INV>(w);
#pragma unroll
            for (int u = 0; u < r; ++u) v[b + u * B] = w[u];
        }
    }
    if constexpr (INV) {
#pragma unroll
        for (int k = 0; k < P::POINTS; ++k) v[k] = cscale(v[k], 1.0f / (float)P::N);
    }
}

}  // namespace regfft
}  // namespace repro
