// Shared __device__ Stockham autosort stage loop for the row-FFT kernels.
//
// One CTA transforms `nrows` rows of length n = 2^log2n.  A pass reads every
// element of a row once and writes it once, to another buffer (autosort: no
// bit reversal, every pass is out of place).  The first pass reads straight
// from device memory and the last may write straight to it, so a row makes one
// trip in and one trip out; the passes between ping-pong between two shared
// buffers.
//
// Stage structure (identical to the plain PyTorch version in
// kernels/fft/kernel.py, so the two can be compared pass for pass): with the
// row viewed as (ncur, s), ncur * s = n, and m = ncur / r, butterfly j of
// column q reads x[(t*m + j)*s + q], t = 0..r-1, and writes
// y[(j*r + u)*s + q] = w_j^u * sum_t x_t * omega_r^(u t), w_j = exp(sign*2*pi*i*j/ncur).
// Since m*s = n/r in every pass, the reads of butterfly i = j*s + q are
// x[i + t*n/r]: neighbouring threads read neighbouring addresses.
//
// Twiddles come from sincospif, not from __sincosf and not from a table:
// the argument 2*j/ncur is exact in float (ncur is a power of two), sincospif
// reduces it in units of pi without rounding and is good to about 1 ulp for
// every j, whereas __sincosf loses absolute accuracy as |x| grows towards
// 2*pi, which a length-8192 transform with 7 passes would show.  A table would
// add a read stream; the kernel is bound by bytes, so the arithmetic is free
// until measured otherwise.  w^2 and w^3 are products of w, as in the plain
// version.

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

// exp(sign * 2*pi*i * j / ncur), ncur a power of two.
__device__ __forceinline__ float2 twiddle(int j, int ncur, float sign) {
    float sn, cs;
    sincospif(sign * 2.0f * (float)j / (float)ncur, &sn, &cs);
    return make_float2(cs, sn);
}

// One radix-4 pass over `nrows` rows.  s = 2^log2s columns, ncur = n / s.
__device__ __forceinline__ void pass_radix4(
        const float2* src, long long src_stride, float2* dst, long long dst_stride,
        int nrows, int log2n, int log2s, float sign, float scale) {
    const int log2q = log2n - 2;
    const int quarter = 1 << log2q;          // butterflies per row = n / 4
    const int s = 1 << log2s;
    const int ncur = 1 << (log2n - log2s);
    const int total = nrows << log2q;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int row = idx >> log2q;
        const int i = idx & (quarter - 1);
        const int j = i >> log2s;
        const int q = i & (s - 1);
        const float2* x = src + row * src_stride + i;
        const float2 p0 = x[0];
        const float2 p1 = x[quarter];
        const float2 p2 = x[2 * quarter];
        const float2 p3 = x[3 * quarter];
        // DFT-4 across the parts: omega_4 = sign * i.
        const float2 e0 = cadd(p0, p2);
        const float2 e1 = csub(p0, p2);
        const float2 o0 = cadd(p1, p3);
        const float2 d3 = csub(p1, p3);
        const float2 o1 = make_float2(-sign * d3.y, sign * d3.x);
        const float2 s0 = cadd(e0, o0);
        const float2 s1 = cadd(e1, o1);
        const float2 s2 = csub(e0, o0);
        const float2 s3 = csub(e1, o1);
        const float2 w1 = twiddle(j, ncur, sign);
        const float2 w2 = cmul(w1, w1);
        const float2 w3 = cmul(w2, w1);
        float2* y = dst + row * dst_stride + ((j << 2) << log2s) + q;
        y[0] = cscale(s0, scale);
        y[s] = cscale(cmul(s1, w1), scale);
        y[2 * s] = cscale(cmul(s2, w2), scale);
        y[3 * s] = cscale(cmul(s3, w3), scale);
    }
}

// One radix-2 pass over `nrows` rows.
__device__ __forceinline__ void pass_radix2(
        const float2* src, long long src_stride, float2* dst, long long dst_stride,
        int nrows, int log2n, int log2s, float sign, float scale) {
    const int log2h = log2n - 1;
    const int half = 1 << log2h;             // butterflies per row = n / 2
    const int s = 1 << log2s;
    const int ncur = 1 << (log2n - log2s);
    const int total = nrows << log2h;
    for (int idx = threadIdx.x; idx < total; idx += blockDim.x) {
        const int row = idx >> log2h;
        const int i = idx & (half - 1);
        const int j = i >> log2s;
        const int q = i & (s - 1);
        const float2* x = src + row * src_stride + i;
        const float2 a = x[0];
        const float2 b = x[half];
        const float2 w = twiddle(j, ncur, sign);
        float2* y = dst + row * dst_stride + ((j << 1) << log2s) + q;
        y[0] = cscale(cadd(a, b), scale);
        y[s] = cscale(cmul(csub(a, b), w), scale);
    }
}

// The whole transform of `nrows` rows held by this CTA.
//
// in/in_stride: the rows in device memory (stride in float2 elements).
// buf0/buf1: two shared buffers of nrows * buf_stride float2 each.
// final_dst: where the last pass writes; nullptr keeps the result in shared
//   memory.  Returns the buffer that holds the result (final_dst if given),
//   after a __syncthreads() when it is a shared buffer.
// radix 4 runs radix-4 passes with one radix-2 tail when log2n is odd;
// radix 2 runs log2n radix-2 passes.  inverse scales by 1/n in the last pass.
__device__ __forceinline__ float2* stockham_rows(
        const float2* in, long long in_stride,
        float2* buf0, float2* buf1, int buf_stride,
        float2* final_dst, long long final_stride,
        int nrows, int log2n, int radix, int inverse) {
    const float sign = inverse ? 1.0f : -1.0f;
    const float inv_n = inverse ? 1.0f / (float)(1 << log2n) : 1.0f;
    const int passes = radix == 4 ? (log2n + 1) / 2 : log2n;
    const float2* src = in;
    long long src_stride = in_stride;
    float2* dst = nullptr;
    int log2s = 0;
    for (int pass = 0; pass < passes; ++pass) {
        const bool last = pass == passes - 1;
        long long dst_stride = buf_stride;
        dst = (pass & 1) ? buf1 : buf0;
        if (last && final_dst != nullptr) {
            dst = final_dst;
            dst_stride = final_stride;
        }
        const float scale = last ? inv_n : 1.0f;
        if (radix == 4 && log2n - log2s >= 2) {
            pass_radix4(src, src_stride, dst, dst_stride, nrows, log2n, log2s, sign, scale);
            log2s += 2;
        } else {
            pass_radix2(src, src_stride, dst, dst_stride, nrows, log2n, log2s, sign, scale);
            log2s += 1;
        }
        if (!(last && final_dst != nullptr)) __syncthreads();
        src = dst;
        src_stride = dst_stride;
    }
    return dst;
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

}  // namespace repro
