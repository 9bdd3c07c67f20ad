// Building blocks shared by the decode kernels (mlp.cu, lm_head.cu,
// paged_attention.cu): RMSNorm, the int8-weight product with an f32
// accumulator, and the epilogues that apply the per-column scale.
//
// Number format (dora_tpu/ops/int8_matmul.py): weights are int8 [K, N] with
// one f32 scale per output column. The scale commutes with the product, so
// every kernel accumulates x @ q in f32 and applies the scale once at the end,
// exactly as the TPU kernels do. Activations are bf16; a bf16 value times an
// int8 value is exact in f32, so the accumulators hold what the TPU's
// preferred_element_type=f32 dots hold, up to summation order.
//
// Every kernel keeps its __syncthreads() uniform across the block (no early
// return), and uses shared memory rather than warp shuffles for reductions.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#ifdef DORA_EMULATE
// Host build for checking the kernels' indexing on a machine without a card
// (csrc/emu/): each block runs as one OS thread per CUDA thread.
#define DORA_LAUNCH(kern, grid, block, stream, ...) \
    dora_emu_launch(grid, block, [&] { kern(__VA_ARGS__); })
#else
#define DORA_LAUNCH(kern, grid, block, stream, ...) \
    kern<<<grid, block, 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#endif

// Record the first launch error of a C entry point and return it.
#define DORA_CHECK(err)                                  \
    do {                                                 \
        cudaError_t e_ = cudaGetLastError();             \
        if (e_ != cudaSuccess && (err) == 0) (err) = (int)e_; \
    } while (0)

static __device__ __forceinline__ float bf16_round(float v) {
    return __bfloat162float(__float2bfloat16(v));
}

// Sum of v over a block of NT threads through shared scratch red[NT].
template <int NT>
static __device__ float block_sum(float v, float* red) {
    red[threadIdx.x] = v;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
        if ((int)threadIdx.x < s) red[threadIdx.x] += red[threadIdx.x + s];
        __syncthreads();
    }
    float r = red[0];
    __syncthreads();
    return r;
}

// h[m] = bf16(x[m] * rsqrt(mean(x[m]^2) + eps) * w), statistics in f32
// (dora_tpu/ops/decode_block.py:_rms followed by .astype(dtype)).
// One block of 256 threads per row.
static __global__ void __launch_bounds__(256)
rmsnorm_rows(const bf16* __restrict__ x, const float* __restrict__ w,
             bf16* __restrict__ h, int D, float eps) {
    __shared__ float red[256];
    const bf16* xr = x + (size_t)blockIdx.x * D;
    float ss = 0.f;
    for (int d = threadIdx.x; d < D; d += 256) {
        float v = __bfloat162float(xr[d]);
        ss += v * v;
    }
    ss = block_sum<256>(ss, red);
    float r = rsqrtf(ss / (float)D + eps);
    for (int d = threadIdx.x; d < D; d += 256) {
        float v = __bfloat162float(xr[d]) * r;
        h[(size_t)blockIdx.x * D + d] = __float2bfloat16(v * w[d]);
    }
}

// ---------------------------------------------------------------------------
// int8-weight product: P[z, m, n] = sum over split z of A[m, k] * W[k, n]
// ---------------------------------------------------------------------------
//
// Tile BM x BN = (16*TM) x (16*TN) outputs per block of 256 threads, K in
// steps of 32 through shared memory (the int8 tile widened to f32 once on
// load). Thread (ty, tx) owns rows ty*TM.. and columns tx + 16*j, so a
// half-warp reads 16 neighbouring columns of the weight tile (no bank
// conflict) and writes 16 neighbouring floats of P. At decode widths the grid
// over N alone is too small to stream the weights through every SM, so K is
// split across blockIdx.z and the epilogue sums the splits in order (no
// atomics: the result does not depend on scheduling).
constexpr int GEMM_BK = 32;
constexpr int GEMM_TN = 8;
constexpr int GEMM_BN = 16 * GEMM_TN;

// acc[i][j] = sum over k in [kbeg, kend) of A[m0 + ty*TM + i, k] *
// W[k, n0 + tx + 16*j]: the block's tile of the product, staged through the
// caller's shared arrays. Rows >= M and columns >= N read as zero.
template <int TM>
static __device__ __forceinline__ void int8_tile_product(
    const bf16* __restrict__ A, const int8_t* __restrict__ W, int M, int N,
    int K, int m0, int n0, int kbeg, int kend,
    float (&As)[GEMM_BK][16 * TM + 1], float (&Ws)[GEMM_BK][GEMM_BN],
    float (&acc)[TM][GEMM_TN]) {
    constexpr int BM = 16 * TM, BN = GEMM_BN, BK = GEMM_BK, TN = GEMM_TN;
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = kbeg; k0 < kend; k0 += BK) {
        for (int idx = tid; idx < BM * BK; idx += 256) {
            int mm = idx / BK, kk = idx % BK;
            int m = m0 + mm, k = k0 + kk;
            As[kk][mm] = (m < M && k < kend)
                ? __bfloat162float(A[(size_t)m * K + k]) : 0.f;
        }
        for (int idx = tid; idx < BK * (BN / 16); idx += 256) {
            int kk = idx / (BN / 16), c = (idx % (BN / 16)) * 16;
            int k = k0 + kk, n = n0 + c;
            if (k < kend && N % 16 == 0 && n + 16 <= N) {
                int4 v = *reinterpret_cast<const int4*>(W + (size_t)k * N + n);
                const int8_t* b = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
                for (int j = 0; j < 16; ++j) Ws[kk][c + j] = (float)b[j];
            } else {
                for (int j = 0; j < 16; ++j)
                    Ws[kk][c + j] = (k < kend && n + j < N)
                        ? (float)W[(size_t)k * N + n + j] : 0.f;
            }
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float a[TM], w[TN];
#pragma unroll
            for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
            for (int j = 0; j < TN; ++j) w[j] = Ws[kk][tx + 16 * j];
#pragma unroll
            for (int i = 0; i < TM; ++i)
#pragma unroll
                for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * w[j];
        }
        __syncthreads();
    }
}

template <int TM>
static __global__ void __launch_bounds__(256)
gemm_i8_partial(const bf16* __restrict__ A, const int8_t* __restrict__ W,
                float* __restrict__ P, int M, int N, int K, int kchunk) {
    __shared__ float As[GEMM_BK][16 * TM + 1];
    __shared__ float Ws[GEMM_BK][GEMM_BN];
    float acc[TM][GEMM_TN];
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const int n0 = blockIdx.x * GEMM_BN, m0 = blockIdx.y * 16 * TM;
    const int kbeg = blockIdx.z * kchunk;
    int8_tile_product<TM>(A, W, M, N, K, m0, n0, kbeg, min(K, kbeg + kchunk),
                          As, Ws, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
        int m = m0 + ty * TM + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < GEMM_TN; ++j) {
            int n = n0 + tx + 16 * j;
            if (n < N) P[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j];
        }
    }
}

static inline int gemm_tm(int M) { return M <= 16 ? 1 : 4; }

// K splits for an M x N x K product: enough blocks for two waves over the
// 132 SMs, each split at least four K tiles deep.
static inline int gemm_kchunk(int M, int N, int K) {
    int bm = 16 * gemm_tm(M);
    int blocks = ((N + GEMM_BN - 1) / GEMM_BN) * ((M + bm - 1) / bm);
    int splits = (2 * 132 + blocks - 1) / blocks;
    int max_splits = K / (4 * GEMM_BK);
    if (splits > max_splits) splits = max_splits;
    if (splits < 1) splits = 1;
    int chunk = (K + splits - 1) / splits;
    return (chunk + GEMM_BK - 1) / GEMM_BK * GEMM_BK;
}

static inline int gemm_splits(int M, int N, int K) {
    int chunk = gemm_kchunk(M, N, K);
    return (K + chunk - 1) / chunk;
}

// Launch the product; the caller's P holds gemm_splits(M, N, K) * M * N floats.
static inline void launch_gemm(const bf16* A, const int8_t* W, float* P,
                               int M, int N, int K, void* stream, int& err) {
    int chunk = gemm_kchunk(M, N, K);
    int splits = (K + chunk - 1) / chunk;
    int tm = gemm_tm(M);
    dim3 grid((N + GEMM_BN - 1) / GEMM_BN, (M + 16 * tm - 1) / (16 * tm), splits);
    if (tm == 1) {
        auto kern = gemm_i8_partial<1>;
        DORA_LAUNCH(kern, grid, dim3(256), stream, A, W, P, M, N, K, chunk);
    } else {
        auto kern = gemm_i8_partial<4>;
        DORA_LAUNCH(kern, grid, dim3(256), stream, A, W, P, M, N, K, chunk);
    }
    DORA_CHECK(err);
}

// out[m, n] = (sum_z P[z, m, n]) * s[n] (+ b[n]) (+ res[m, n]), in f32, then
// stored as bf16 (out_bf) or f32 (out_f): the tail of the TPU kernels'
// output projections, with the residual added in f32 before the cast.
static __global__ void __launch_bounds__(256)
epilogue_linear(const float* __restrict__ P, int splits, int M, int N,
                const float* __restrict__ s, const float* __restrict__ b,
                const bf16* __restrict__ res, bf16* __restrict__ out_bf,
                float* __restrict__ out_f) {
    size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
    if (idx >= (size_t)M * N) return;
    int n = (int)(idx % N);
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += P[(size_t)z * M * N + idx];
    acc *= s[n];
    if (b) acc += b[n];
    if (res) acc = __bfloat162float(res[idx]) + acc;
    if (out_f) out_f[idx] = acc;
    else out_bf[idx] = __float2bfloat16(acc);
}

static inline void launch_epilogue(const float* P, int splits, int M, int N,
                                   const float* s, const float* b,
                                   const bf16* res, bf16* out_bf, float* out_f,
                                   void* stream, int& err) {
    size_t total = (size_t)M * N;
    dim3 grid((unsigned)((total + 255) / 256));
    DORA_LAUNCH(epilogue_linear, grid, dim3(256), stream,
                P, splits, M, N, s, b, res, out_bf, out_f);
    DORA_CHECK(err);
}
