// Greedy head: replaces the Pallas kernel _head_kernel / lm_head_argmax of
// dora_tpu/ops/decode_block.py.
//
//   idx[m] = argmax_v (rms(x[m]).astype(bf16) @ q_head)[v] * s[v]
//
// int4 weights (the TPU kernel's branch on w.dtype == uint8): the packed head
// [D/2, V] with group scales [D/G, V], 117 MB + 7.3 MB at that width, through
// the int4 form of the same product (TcInt4, common.cuh), whose sums come
// scaled, over the full D with no split.
//
// Bound: the int8 head, 1536 x 151936 = 233 MB at Qwen2-1.5B width, read once
// per call while rows are few; at 256 rows the product is 120 GFLOP and the
// call is bound by operations. The [M, V] logits never reach device memory.
//
// Design: the TPU kernel walks the vocab tile by tile and keeps a running
// (max, index) in scratch across grid steps. Here every block owns one
// 128-column vocab tile for a band of rows, computes its logits on the
// tensor cores (tc_tile_product, common.cuh) and reduces them in registers
// to one (max, index) pair per (row, tile); a second pass reduces the pairs
// of a row. The head is streamed from HBM once per call at every M: up to 64
// rows one band holds them all; above, the grid's fastest dimension is the
// band, so the bands of one vocab tile are scheduled together and the second
// reads the tile from L2. Every comparison orders equal values by index (the
// quad's shuffles, the warps' shared pairs, the row's tiles), so the smallest
// index among the maxima wins, as jnp.argmax's first-index rule does (the TPU
// kernel gets the same result from a strict > across tiles). Columns at or
// past the vocab size never compete (the TPU kernel's -inf tail).
#include "common.cuh"

static __device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
    return v > bv || (v == bv && i < bi);
}

constexpr int HEAD_BN = TcPrefill::BN;
static_assert(TcDecode<1>::BN == HEAD_BN && TcDecode4<1>::BN == HEAD_BN,
              "one vocab tile width for every band");

// Grid (bands, vocab tiles): the best (logit, index) of each row of the band
// over the tile's columns (s null: the sums are scaled already).
template <class T, class Fmt>
static __global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
head_tiles(const bf16* __restrict__ H, QWeight W, const float* __restrict__ s,
           float* __restrict__ tile_val, int* __restrict__ tile_idx, int M, int V, int D,
           int ntiles) {
    DORA_DYNAMIC_SMEM(smem);
    __shared__ float rv[T::BM][T::WN];
    __shared__ int ri[T::BM][T::WN];
    const int tile = blockIdx.y, m0 = blockIdx.x * T::BM;
    const TcCols cols{T::BN, tile * T::BN, V, 0};
    float acc[T::MT][T::NT][4];
    tc_tile_product<T, Fmt>(H, W, M, D, V, cols, m0, 0, D, smem, acc);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wm = warp / T::WN, wn = warp % T::WN;
    // Per lane: the best of its columns (4t .. 4t + 3 of each of the warp's
    // 16-column groups) in each of its rows (g and g + 8 of every 16-row
    // tile); then across the quad, whose four lanes hold the warp's other
    // columns of the same rows.
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            float bv = -INFINITY;
            int bi = INT_MAX;
#pragma unroll
            for (int j = 0; j < T::NT; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int n = tile * T::BN + tc_col<T>(wn, j, t, 2 * hh + e);
                    if (n < V) {
                        const float v = col_scale(s, n, acc[i][j][2 * hh + e]);
                        if (better(v, n, bv, bi)) { bv = v; bi = n; }
                    }
                }
#pragma unroll
            for (int mask = 1; mask <= 2; mask <<= 1) {
                const float ov = shfl_xor(bv, mask);
                const int oi = shfl_xor(bi, mask);
                if (better(ov, oi, bv, bi)) { bv = ov; bi = oi; }
            }
            if (t == 0) {
                const int r = (wm * T::MT + i) * 16 + g + 8 * hh;
                rv[r][wn] = bv;
                ri[r][wn] = bi;
            }
        }
    __syncthreads();
    // Per row of the band: best of the warps that share it.
    if ((int)threadIdx.x < T::BM) {
        const int r = threadIdx.x, m = m0 + r;
        float bv = rv[r][0];
        int bi = ri[r][0];
        for (int w = 1; w < T::WN; ++w)
            if (better(rv[r][w], ri[r][w], bv, bi)) { bv = rv[r][w]; bi = ri[r][w]; }
        if (m < M) {
            tile_val[(size_t)m * ntiles + tile] = bv;
            tile_idx[(size_t)m * ntiles + tile] = bi;
        }
    }
}

template <class T, class Fmt>
static inline int launch_head(const bf16* H, const QWeight& W, const float* s, float* tile_val,
                              int* tile_idx, int M, int V, int D, int ntiles, void* stream) {
    int err = tc_takes<T>(W, D);
    if (err) return err;
    auto kern = head_tiles<T, Fmt>;
    err = tc_allow<T, Fmt>(kern);
    if (err) return err;
    dim3 grid((M + T::BM - 1) / T::BM, ntiles);
    DORA_LAUNCH_SMEM(kern, grid, dim3(T::THREADS), T::SMEM, stream, H, W, s, tile_val,
                     tile_idx, M, V, D, ntiles);
    DORA_CHECK(err);
    return err;
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

extern "C" int dora_head_tiles(int V) { return (V + HEAD_BN - 1) / HEAD_BN; }

// x [M, D] bf16; norm_w [D] f32; w int8 [D, V] with s [V] f32 (G 0), or
// int4 [D/2, V] with group scales s [D/G, V] f32 (G a multiple of TC_MAX_BK).
// out_idx [M] int32; out_val [M] f32. Scratch: h bf16 [M, D];
// tile_val f32 / tile_idx int32 [M, dora_head_tiles(V)].
extern "C" int dora_lm_head_argmax(const void* x, const void* norm_w,
                                   const void* w, const void* s, void* out_idx,
                                   void* out_val, int M, int D, int V, int G, float eps,
                                   void* h, void* tile_val, void* tile_idx,
                                   void* stream) {
    int err = 0;
    const int ntiles = dora_head_tiles(V);
    DORA_LAUNCH(rmsnorm_rows, dim3(M), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    const bf16* H = (const bf16*)h;
    const QWeight Wq = G ? QWeight(w, (const float*)s, G) : QWeight((const int8_t*)w);
    const float* sv = G ? nullptr : (const float*)s;
    float* tv = (float*)tile_val;
    int* ti = (int*)tile_idx;
    const int e = tc_by_format(Wq, [&](auto f) {
        return tc_band<decltype(f)>(M, [&](auto c) {
            return launch_head<decltype(c), decltype(f)>(H, Wq, sv, tv, ti, M, V, D, ntiles,
                                                         stream);
        });
    });
    if (!err) err = e;
    DORA_LAUNCH(head_reduce, dim3(M), dim3(256), stream,
                (const float*)tile_val, (const int*)tile_idx, ntiles,
                (int*)out_idx, (float*)out_val);
    DORA_CHECK(err);
    return err;
}
