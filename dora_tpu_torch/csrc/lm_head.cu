// Greedy head: replaces the Pallas kernel _head_kernel / lm_head_argmax of
// dora_tpu/ops/decode_block.py.
//
//   idx[m] = argmax_v (rms(x[m]).astype(bf16) @ q_head)[v] * s[v]
//
// Bound: the int8 head, 1536 x 151936 = 233 MB at Qwen2-1.5B width, read once
// per call; the [M, V] logits are never written to device memory.
//
// Design: the TPU kernel walks the vocab tile by tile and keeps a running
// (max, index) in scratch across grid steps. Here every block owns one
// 128-column vocab tile for a band of rows, computes its logits in registers
// and writes one (max, index) pair per (row, tile); a second pass reduces the
// pairs of a row. Both passes order equal values by index, so the smallest
// index among the maxima wins, as jnp.argmax's first-index rule does (the TPU
// kernel gets the same result from a strict > across tiles). Columns at or
// past the vocab size never compete (the TPU kernel's -inf tail).
#include "common.cuh"
#include <limits.h>

static __device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

template <int TM>
static __global__ void __launch_bounds__(256)
head_tiles(const bf16* __restrict__ H, const int8_t* __restrict__ W,
           const float* __restrict__ s, float* __restrict__ tile_val,
           int* __restrict__ tile_idx, int M, int V, int D, int ntiles) {
    constexpr int BM = 16 * TM, TN = GEMM_TN;
    __shared__ float As[GEMM_BK][BM + 1];
    __shared__ float Ws[GEMM_BK][GEMM_BN];
    __shared__ float rv[BM][16];
    __shared__ int ri[BM][16];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int n0 = blockIdx.x * GEMM_BN, m0 = blockIdx.y * BM;
    float acc[TM][TN];
    int8_tile_product<TM>(H, W, M, V, D, m0, n0, 0, D, As, Ws, acc);
    // Per thread: best of its TN columns for each of its rows.
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        float bv = -INFINITY;
        int bi = INT_MAX;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
            int n = n0 + tx + 16 * j;
            if (n < V) {
                float v = acc[i][j] * s[n];
                if (better(v, n, bv, bi)) { bv = v; bi = n; }
            }
        }
        rv[ty * TM + i][tx] = bv;
        ri[ty * TM + i][tx] = bi;
    }
    __syncthreads();
    // Per row of the band: best of the 16 column groups.
    if (tid < BM) {
        int m = m0 + tid;
        float bv = rv[tid][0];
        int bi = ri[tid][0];
        for (int t = 1; t < 16; ++t)
            if (better(rv[tid][t], ri[tid][t], bv, bi)) { bv = rv[tid][t]; bi = ri[tid][t]; }
        if (m < M) {
            tile_val[(size_t)m * ntiles + blockIdx.x] = bv;
            tile_idx[(size_t)m * ntiles + blockIdx.x] = bi;
        }
    }
}

// One block per row: the best (max, first index) pair over the row's tiles.
static __global__ void __launch_bounds__(256)
head_reduce(const float* __restrict__ tile_val, const int* __restrict__ tile_idx,
            int ntiles, int* __restrict__ out_idx, float* __restrict__ out_val) {
    __shared__ float rv[256];
    __shared__ int ri[256];
    const int m = blockIdx.x, tid = threadIdx.x;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int t = tid; t < ntiles; t += 256) {
        float v = tile_val[(size_t)m * ntiles + t];
        int i = tile_idx[(size_t)m * ntiles + t];
        if (better(v, i, bv, bi)) { bv = v; bi = i; }
    }
    rv[tid] = bv;
    ri[tid] = bi;
    __syncthreads();
    for (int s = 128; s > 0; s >>= 1) {
        if (tid < s && better(rv[tid + s], ri[tid + s], rv[tid], ri[tid])) {
            rv[tid] = rv[tid + s];
            ri[tid] = ri[tid + s];
        }
        __syncthreads();
    }
    if (tid == 0) {
        out_idx[m] = ri[0];
        out_val[m] = rv[0];
    }
}

extern "C" int dora_head_tiles(int V) { return (V + GEMM_BN - 1) / GEMM_BN; }

// x [M, D] bf16; norm_w [D] f32; w int8 [D, V]; s [V] f32.
// out_idx [M] int32; out_val [M] f32. Scratch: h bf16 [M, D];
// tile_val f32 / tile_idx int32 [M, dora_head_tiles(V)].
extern "C" int dora_lm_head_argmax(const void* x, const void* norm_w,
                                   const void* w, const void* s, void* out_idx,
                                   void* out_val, int M, int D, int V, float eps,
                                   void* h, void* tile_val, void* tile_idx,
                                   void* stream) {
    int err = 0;
    int ntiles = dora_head_tiles(V);
    DORA_LAUNCH(rmsnorm_rows, dim3(M), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    int tm = gemm_tm(M);
    dim3 grid(ntiles, (M + 16 * tm - 1) / (16 * tm));
    if (tm == 1) {
        auto kern = head_tiles<1>;
        DORA_LAUNCH(kern, grid, dim3(256), stream, (const bf16*)h,
                    (const int8_t*)w, (const float*)s, (float*)tile_val,
                    (int*)tile_idx, M, V, D, ntiles);
    } else {
        auto kern = head_tiles<4>;
        DORA_LAUNCH(kern, grid, dim3(256), stream, (const bf16*)h,
                    (const int8_t*)w, (const float*)s, (float*)tile_val,
                    (int*)tile_idx, M, V, D, ntiles);
    }
    DORA_CHECK(err);
    DORA_LAUNCH(head_reduce, dim3(M), dim3(256), stream,
                (const float*)tile_val, (const int*)tile_idx, ntiles,
                (int*)out_idx, (float*)out_val);
    DORA_CHECK(err);
    return err;
}
