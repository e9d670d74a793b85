// Blocked out-of-place transpose for Hopper (sm_90a): out[j, i] = in[i, j]
// for an (r, c) matrix of elements of 1, 2, 4, 8 or 16 bytes; out is (c, r).
// Bit-exact: the kernel moves bits and never looks at a value, so complex64
// moves as one 8-byte element and complex128 as one 16-byte element.
//
// Replaces the TPU kernel `transpose_pallas` (body `_tr_kernel`) of
// src/repro/kernels/transpose/kernel.py, the paper's Appendix-A blocked
// transpose: tile (i, j) of the input is written as tile (j, i) of the
// output.  The TPU kernel takes 128 x 128 tiles that its op pads to; here the
// tile is 32 x 32 and the kernel masks the ragged edge tiles, so nothing is
// padded or cropped.
//
// Bound on this card: bytes (r*c*elem read once, r*c*elem written once; no
// arithmetic).  A direct transpose reads or writes with a stride of a whole
// row, one element per 32-byte sector.  So a CTA of 32 x 8 threads reads its
// tile row by row with neighbouring threads on neighbouring elements
// (coalesced along c), keeps it in shared memory with one element of padding
// per row (the column-direction reads of the next step then fall in
// different banks), syncs, and writes the tile's columns as output rows,
// again with neighbouring threads on neighbouring elements (coalesced along
// r).  A grid-stride loop over the tiles covers any shape with a bounded
// grid.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kRowsPerPass = 8;

template <typename T>
__global__ void __launch_bounds__(kTile * kRowsPerPass)
transpose_kernel(const T* __restrict__ in, T* __restrict__ out, long long r,
                 long long c, long long tiles_c, long long tiles) {
    __shared__ T tile[kTile][kTile + 1];
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
        const long long row0 = (t / tiles_c) * kTile;   // input rows of the tile
        const long long col0 = (t % tiles_c) * kTile;   // input columns of the tile
        for (int i = threadIdx.y; i < kTile; i += kRowsPerPass) {
            const long long row = row0 + i;
            const long long col = col0 + threadIdx.x;
            if (row < r && col < c) tile[i][threadIdx.x] = in[row * c + col];
        }
        __syncthreads();
        for (int i = threadIdx.y; i < kTile; i += kRowsPerPass) {
            const long long orow = col0 + i;             // an input column
            const long long ocol = row0 + threadIdx.x;   // an input row
            if (orow < c && ocol < r) out[orow * r + ocol] = tile[threadIdx.x][i];
        }
        __syncthreads();
    }
}

template <typename T>
int launch(const void* in, void* out, long long r, long long c, cudaStream_t stream) {
    const long long tiles_c = (c + kTile - 1) / kTile;
    const long long tiles = ((r + kTile - 1) / kTile) * tiles_c;
    // Enough CTAs to fill every SM many times over; larger shapes loop.
    const long long blocks = tiles < (1LL << 20) ? tiles : (1LL << 20);
    transpose_kernel<T><<<(unsigned)blocks, dim3(kTile, kRowsPerPass), 0, stream>>>(
        (const T*)in, (T*)out, r, c, tiles_c, tiles);
    return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` and does not synchronise.  Returns a CUDA error code
// (0 = launched).  `in` is (r, c), `out` a distinct (c, r) buffer, both of
// elements of `elem_bytes` bytes.
extern "C" int repro_transpose(const void* in, void* out, long long r, long long c,
                               int elem_bytes, void* stream) {
    if (r <= 0 || c <= 0) return 0;
    const cudaStream_t s = (cudaStream_t)stream;
    switch (elem_bytes) {
        case 1: return launch<uint8_t>(in, out, r, c, s);
        case 2: return launch<uint16_t>(in, out, r, c, s);
        case 4: return launch<uint32_t>(in, out, r, c, s);
        case 8: return launch<uint2>(in, out, r, c, s);
        case 16: return launch<uint4>(in, out, r, c, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
