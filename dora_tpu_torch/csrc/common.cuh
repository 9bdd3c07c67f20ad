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
// return). Reductions over a block go through shared memory; the
// tensor-core sweeps of paged_attention.cu reduce over a warp's quad with
// shuffles and call the PTX-level operations only through the inline
// helpers at the end of this file (mma, shuffle, cp.async), which the
// emulated build (csrc/emu/) runs on the host.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#ifdef DORA_EMULATE
// Host build for checking the kernels' indexing on a machine without a card
// (csrc/emu/): each block runs as one OS thread per CUDA thread.
#define DORA_LAUNCH(kern, grid, block, stream, ...) \
    dora_emu_launch(grid, block, [&] { kern(__VA_ARGS__); })
#define DORA_LAUNCH_SMEM(kern, grid, block, smem, stream, ...) \
    dora_emu_launch(grid, block, [&] { kern(__VA_ARGS__); }, smem)
#define DORA_DYNAMIC_SMEM(name) unsigned char* name = dora_emu_smem
#else
#define DORA_LAUNCH(kern, grid, block, stream, ...) \
    kern<<<grid, block, 0, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#define DORA_LAUNCH_SMEM(kern, grid, block, smem, stream, ...) \
    kern<<<grid, block, smem, (cudaStream_t)(stream)>>>(__VA_ARGS__)
#define DORA_DYNAMIC_SMEM(name) extern __shared__ __align__(16) unsigned char name[]
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

// Maximum of v over a block of NT threads through shared scratch red[NT].
template <int NT>
static __device__ float block_max(float v, float* red) {
    red[threadIdx.x] = v;
    __syncthreads();
    for (int s = NT / 2; s > 0; s >>= 1) {
        if ((int)threadIdx.x < s) red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
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

// ---------------------------------------------------------------------------
// Warp-level operations of the tensor-core sweeps
// ---------------------------------------------------------------------------

// Allow `bytes` of dynamic shared memory to `kern`: above the default 48 KB
// a kernel must ask first. Returns the call's cudaError_t (0 below 48 KB).
template <class K>
static inline int allow_dynamic_smem(K kern, size_t bytes) {
    if (bytes <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)bytes);
}

// Two bf16 in one 32-bit register, the lower index in the lower half (the
// fragment format of mma_bf16_16816).
static __device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
    return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

static __device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    return pack_bf16(__float2bfloat16(lo), __float2bfloat16(hi));
}

// D = A B + D on the tensor cores, one 16 x 8 x 16 tile per warp:
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32. With g = lane / 4
// and t = lane % 4, each lane holds A rows g and g + 8 at columns 2t, 2t + 1
// (a[0], a[1]) and 2t + 8, 2t + 9 (a[2], a[3]) as (row g, row g + 8) pairs;
// B rows (k) 2t, 2t + 1 (b[0]) and 2t + 8, 2t + 9 (b[1]) of column n = g;
// D rows g (d[0], d[1]) and g + 8 (d[2], d[3]) at columns 2t, 2t + 1.
static __device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                                      const uint32_t (&b)[2]) {
#ifdef DORA_EMULATE
    dora_emu_mma_bf16_16816(d, a, b);
#else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#endif
}

// v from the lane whose index differs from this one's in the bits of `mask`
// (every lane of the warp takes part).
static __device__ __forceinline__ float shfl_xor(float v, int mask) {
    return __shfl_xor_sync(0xffffffffu, v, mask);
}

// Copy 16 bytes from device memory to shared memory without passing
// through registers; a row that is not `live` reads nothing and lands as
// zeros (src-size 0), whatever lies at src.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
#ifdef DORA_EMULATE
    if (live) memcpy(dst, src, 16);
    else memset(dst, 0, 16);
#else
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(live ? 16 : 0) : "memory");
#endif
}

// Close the group of copies issued since the last commit.
static __device__ __forceinline__ void cp_async_commit() {
#ifndef DORA_EMULATE
    asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Wait until at most N committed groups are in flight (the caller then
// syncs the block before reading what the others copied).
template <int N>
static __device__ __forceinline__ void cp_async_wait() {
#ifndef DORA_EMULATE
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
#endif
}
