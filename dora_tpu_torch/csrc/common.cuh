// Building blocks shared by the kernels (mlp.cu, lm_head.cu,
// paged_attention.cu, int8_matmul.cu, flash_attention.cu, lora.cu): RMSNorm, the
// quantized-weight products with f32 accumulators (the SIMT int8 launch_gemm
// of the attention sublayers, and the tensor-core tc_tile_product of kernels
// 1, 2 and 7, and of the int4 branch of kernels 1-5 and 8-10), the epilogues
// that apply the per-column scale, and the warp-level operations of the
// tensor-core kernels.
//
// Number formats. int8 (dora_tpu/ops/int8_matmul.py): weights int8 [K, N]
// with one f32 scale per output column. The scale commutes with the product,
// so every kernel accumulates x @ q in f32 and applies the scale once at the
// end, exactly as the TPU kernels do. int4 (dora_tpu/ops/int4.py): [K/2, N]
// bytes, two biased nibbles (q + 8) a byte paired within each group of G
// rows of K, and one f32 scale per (group, column); the tensor-core product
// applies each group's scale to that group's f32 sums itself (TcInt4), so
// its epilogues take no per-column scale. Activations are bf16; a bf16 value
// times an int8 or int4 value is exact in f32, so the accumulators hold what
// the TPU's preferred_element_type=f32 dots hold, up to summation order.
//
// Every kernel keeps its __syncthreads() uniform across the block (no early
// return). Reductions over a block go through shared memory; the
// tensor-core sweeps of paged_attention.cu reduce over a warp's quad with
// shuffles and call the PTX-level operations only through the inline
// helpers near the end of this file (mma, shuffle, ballot, cp.async,
// ldmatrix),
// which the emulated build (csrc/emu/) runs on the host.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#ifdef DORA_EMULATE
// Host build for checking the kernels' indexing on a machine without a card
// (csrc/emu/): each block runs as one fiber per CUDA thread.
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

// out[m, n] = (sum_z P[z, m, n]) * s[n] (+ b[n]) (+ res[m, n]), in f32 (s null:
// no scale), then
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
    if (s) acc *= s[n];  // null: the sums are scaled already (int4)
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


static __device__ __forceinline__ int shfl_xor(int v, int mask) {
    return __shfl_xor_sync(0xffffffffu, v, mask);
}

// One bit a lane, set where the lane's p holds (every lane takes part).
static __device__ __forceinline__ unsigned warp_ballot(bool p) {
#ifdef DORA_EMULATE
    return dora_emu_ballot(p);
#else
    return __ballot_sync(0xffffffffu, p);
#endif
}

// Four 8 x 8 bf16 matrices from shared memory, one register each, in the
// fragment layout of mma_bf16_16816: lane l gives the address of row l % 8 of
// matrix l / 8 (16 bytes, 16-byte aligned); of matrix i a lane gets r[i] =
// row g = lane / 4, columns 2t, 2t + 1 (t = lane % 4), or with TRANS column
// g, rows 2t, 2t + 1; the lower index in the lower half.
// ldmatrix.sync.aligned.m8n8.x4(.trans).shared.b16.
template <bool TRANS>
static __device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
#ifdef DORA_EMULATE
    dora_emu_ldmatrix_x4(r, row, TRANS);
#else
    const unsigned s = (unsigned)__cvta_generic_to_shared(row);
    if (TRANS)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
    else
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s) : "memory");
#endif
}

// ---------------------------------------------------------------------------
// Tensor-core quantized-weight product (mlp.cu, lm_head.cu, int8_matmul.cu,
// and the int4 branch of paged_attention.cu)
// ---------------------------------------------------------------------------
//
// acc = A[m0.., kbeg..kend) @ W[kbeg..kend), cols) for bf16 activations A
// [M, K] and int8 weights W [K, ldw] (row-major), on mma.sync.m16n8k16 bf16
// with f32 accumulators. Each stage of BK k goes to shared memory
// through cp.async into a ring of STAGES stages, one barrier a stage: the A
// rows as bf16, the weight rows as int8 (16-byte copies; rows past M, k past
// kend and columns past the panel land as zeros; where the 16-byte chunks of
// a row are not aligned, element by element). The warps read A with
// ldmatrix, and the int8 weights with ldmatrix.trans as if they were 16-bit:
// a lane gets, of an 8 x 16-byte block, k rows 2t and 2t + 1 of the byte
// pair (2g, 2g + 1): the two k of the B register of columns 2g and 2g + 1.
// It widens them to bf16 in registers (exact: |q| <= 127). So one mma takes
// the even columns of a 16-column group and a second the odd ones; a lane's
// accumulators hold columns 4t .. 4t + 3 of the group. Every product is the
// one the SIMT product and the TPU kernel form. The mma's own accumulation
// truncates; summed over a whole K that put the head's logits several times
// further from f64 than an f32 product (PERF.md), so each stage's mma sums start
// from zero and are added to the running sums in f32, rounded to nearest:
// only the order of the f32 sums differs.
//
// int4 weights (TcInt4) take the same loop. A stage of BK k lies inside one
// group of G (G a multiple of BK, and K splits at multiples of G) and reads
// the BK / 2 packed rows of its k once: their low nibbles are rows gG + j0 ..
// of the group and their high nibbles rows gG + G/2 + j0 .., so the stage
// copies those two runs of A's columns, BK / 2 each, side by side. One
// ldmatrix.trans of 16 packed rows then gives a lane the B registers of two
// k steps, the low nibbles' (the stage's first BK / 32 k steps) and the high
// nibbles' (the rest). A nibble is widened exactly to bf16 q in registers
// (u4_pair: under the bf16 128 it is 128 + q + 8; a bf16x2 fma takes 136
// off), so the bias is taken off there and the sums need no 8 * sum(x)
// correction (the TPU kernel's form, which rounds no differently in exact
// arithmetic).
// Each stage's f32 sums are multiplied by their group's scale of each column
// (read from device memory, one a lane column, before the stage's wait)
// before they are added in: the product returns scaled sums. Decode bands
// take TcDecode4, whose stages are 128 k deep, so that a stage carries as
// many weight bytes as an int8 stage: with int8's stages the int4 product
// has half the bytes in flight and, paced by them, takes int8's time.
//
// A block is WM x WN warps; warp (wm, wn) owns MT 16-row tiles and NT / 2
// 16-column groups (NT mma column tiles of 8): half of its groups in the
// block's first BN / 2 columns and the same ones in the second half, so that
// with two panels (gate | up) one thread holds g and u of the same column.
constexpr int TC_SPLIT_K = 128;     // the least K of one split
constexpr int TC_DECODE_ROWS = 64;  // up to here a product is bound by its weight bytes
constexpr int TC_SMS = 132;         // H100 SXM

template <int MT_, int NT_, int WM_, int WN_, int STAGES_, int MIN_BLOCKS_, int BK_ = 32,
          int KPR_ = 1>
struct TcCfg {
    static constexpr int MT = MT_, NT = NT_, WM = WM_, WN = WN_, STAGES = STAGES_, BK = BK_;
    static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
    static constexpr int BM = 16 * MT * WM, BN = 8 * NT * WN, THREADS = 32 * WM * WN;
    static constexpr int LDA = BK + 8;  // bf16 a row of an A stage (conflict-free ldmatrix)
    static constexpr int LDR = BN + 16; // bytes a row of a weight stage
    // weight rows a stage holds: BK, or BK / 2 for a configuration made for
    // int4 only (KPR_ 2: two k a packed row)
    static constexpr int W_ROWS = BK / KPR_;
    static constexpr size_t A_BYTES = (size_t)STAGES * BM * LDA * 2;
    static constexpr size_t SMEM = A_BYTES + (size_t)STAGES * W_ROWS * LDR;
    static_assert(NT % 4 == 0, "16-column groups in both halves");
    static_assert(BK % 32 == 0 && TC_SPLIT_K % BK == 0, "whole k steps in a split");
};

// Decode: all rows in one band (16, 32 or 64), 128 columns over 4 warps; a
// deep ring and as many blocks an SM as shared memory allows, for weight
// bytes in flight (stages and depth as measured best on an H100, PERF.md).
template <int MT>
using TcDecode = TcCfg<MT, 4, 1, 4, MT == 1 ? 6 : 8, MT == 4 ? 2 : 3, MT == 1 ? 64 : 32>;
// Prefill: 128 x 128 tiles, 2 x 4 warps of 64 x 32, 64 k a stage.
using TcPrefill = TcCfg<4, 4, 2, 4, 3, 2, 64>;
// Decode on int4 weights: TcDecode's tiles with 128 k a stage, so that a
// stage holds as many weight bytes (64 packed rows) as an int8 stage of 64
// rows: a decode product is paced by the weight bytes it has in flight, and
// with int8's stages int4 would keep half of them. The ring is as deep as
// shared memory allows at TcDecode's blocks an SM.
template <int MT>
using TcDecode4 = TcCfg<MT, 4, 1, 4, MT == 1 ? 5 : 4, MT == 4 ? 2 : 3, 128, 2>;
// The deepest stage of any configuration: an int4 weight's group is a
// multiple of it (ops/decode_block.KERNEL_INT4_GROUP_MULTIPLE).
constexpr int TC_MAX_BK = 128;

// A weight operand of the products: int8 [K, N] (gs null; its per-column
// scales are the caller's epilogue's), or int4 [K/2, N] nibbles with f32
// group scales gs [K/G, N], which the tensor-core product applies.
struct QWeight {
    const void* q;
    const float* gs;
    int group;
    QWeight(const int8_t* w) : q(w), gs(nullptr), group(0) {}
    QWeight(const void* w, const float* s, int g) : q(w), gs(s), group(g) {}
};

// The weight formats of tc_tile_product: KPR k a weight row, and the A
// column of column kk of the stage that starts at k0 (int4: the low half of
// k0's group from (k0 % G) / 2, then its high half).
struct TcInt8 {
    static constexpr bool INT4 = false;
    static constexpr int KPR = 1;
    template <int BK>
    static __device__ __forceinline__ int a_col(int k0, int kk, int) { return k0 + kk; }
};
struct TcInt4 {
    static constexpr bool INT4 = true;
    static constexpr int KPR = 2;
    template <int BK>
    static __device__ __forceinline__ int a_col(int k0, int kk, int G) {
        const int g0 = k0 - k0 % G, j0 = (k0 % G) / 2;
        return kk < BK / 2 ? g0 + j0 + kk : g0 + G / 2 + j0 + kk - BK / 2;
    }
};

// The block's BN logical columns over the weight columns: `half` of them in
// each panel (BN, or BN / 2 with two), from column col0 of the panel; panel p
// starts at weight column p * stride; a panel is `width` columns wide.
struct TcCols {
    int half, col0, width, stride;
    __device__ int phys(int j) const { return (j / half) * stride + col0 + j % half; }
    __device__ bool live(int j) const { return col0 + j % half < width; }
};

// The block-tile column of warp wn's 16-column group q.
template <class T>
static __device__ __forceinline__ int tc_group(int wn, int q) {
    constexpr int H = T::NT / 4;  // groups a warp owns in each half
    return (q < H ? 0 : T::BN / 2) + (wn * H + q % H) * 16;
}

// The block-tile column of accumulator c of mma column tile j for lane
// quarter t (the even mma of a group takes its even columns).
template <class T>
static __device__ __forceinline__ int tc_col(int wn, int j, int t, int c) {
    return tc_group<T>(wn, j / 2) + 4 * t + 2 * (c & 1) + (j & 1);
}

// The int8 word ldmatrix.trans gives a lane (bytes: k 2t of columns 2g and
// 2g + 1, then k 2t + 1 of the same) as the mma's B registers of column 2g
// (even) and 2g + 1 (odd): bf16, the lower k in the lower half. q + 128
// under the exponent byte 0x4B is the f32 2^23 + (q + 128), exact; minus
// 2^23 + 128 leaves q, whose bf16 is the f32's upper half.
static __device__ __forceinline__ void widen_i8_cols(uint32_t w, uint32_t& even, uint32_t& odd) {
    const uint32_t u = w ^ 0x80808080u;
    uint32_t f[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
        f[b] = __float_as_uint(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | b)) -
                               8388736.f);
    even = __byte_perm(f[0], f[2], 0x7632u);
    odd = __byte_perm(f[1], f[3], 0x7632u);
}

// The nibbles at bits 0-3 and 16-19 of u, each q + 8, as a bf16 pair q (the
// lower in the lower half): under the bf16 0x4300 (128) a nibble n is the
// mantissa of 128 + n, exact; one bf16x2 fma by 1 and -136 leaves n - 8 = q,
// exact. One shift, one lop3 and one fma a register.
static __device__ __forceinline__ uint32_t u4_pair(uint32_t u) {
    const uint32_t v = (u & 0x000F000Fu) | 0x43004300u;
#ifdef DORA_EMULATE
    uint32_t r = 0;
    for (int h = 0; h < 2; ++h) {
        const float q = __uint_as_float(((v >> (16 * h)) & 0xFFFFu) << 16) - 136.f;
        r |= (__float_as_uint(q) >> 16) << (16 * h);
    }
    return r;
#else
    uint32_t r;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(v), "r"(0x3F803F80u), "r"(0xC308C308u));
    return r;
#endif
}

// int4: a lane's ldmatrix.trans word of packed bytes (k 2t of columns 2g and
// 2g + 1, then k 2t + 1 of the same) as the B registers of columns 2g (even)
// and 2g + 1 (odd) for the low nibbles (rows of the group's low half) and for
// the high ones (its high half).
static __device__ __forceinline__ void widen_u4_cols(uint32_t w, uint32_t& lo_even,
                                                     uint32_t& lo_odd, uint32_t& hi_even,
                                                     uint32_t& hi_odd) {
    lo_even = u4_pair(w);
    lo_odd = u4_pair(w >> 8);
    hi_even = u4_pair(w >> 4);
    hi_odd = u4_pair(w >> 12);
}

template <class T, class F>
static __device__ __forceinline__ void tc_load_stage(
    const bf16* __restrict__ A, const int8_t* __restrict__ W, int M, int K, int ldw, int G,
    const TcCols& cols, int m0, int k0, int kend, bool a_vec, bool w_vec,
    bf16* __restrict__ As, int8_t* __restrict__ Rs) {
    for (int c = threadIdx.x; c < T::BM * (T::BK / 8); c += T::THREADS) {
        const int r = c / (T::BK / 8), kk = (c % (T::BK / 8)) * 8;
        const int m = m0 + r, k = F::template a_col<T::BK>(k0, kk, G);
        bf16* dst = As + r * T::LDA + kk;
        const bool live = m < M && k < kend;
        if (a_vec) {
            cp_async16(dst, live ? A + (size_t)m * K + k : A, live);
        } else {
            for (int e = 0; e < 8; ++e)
                dst[e] = (m < M && k + e < kend) ? A[(size_t)m * K + k + e] : __float2bfloat16(0.f);
        }
    }
    // the stage's weight rows: BK / KPR of them from row k0 / KPR
    constexpr int ROWS = T::BK / F::KPR;
    for (int c = threadIdx.x; c < ROWS * (T::BN / 16); c += T::THREADS) {
        const int kk = c / (T::BN / 16), j = (c % (T::BN / 16)) * 16;
        const int k = k0 / F::KPR + kk;
        int8_t* dst = Rs + kk * T::LDR + j;
        if (k >= kend / F::KPR || !cols.live(j)) {
            cp_async16(dst, W, false);
        } else if (w_vec && cols.live(j + 15)) {
            cp_async16(dst, W + (size_t)k * ldw + cols.phys(j), true);
        } else {
            for (int e = 0; e < 16; ++e)
                dst[e] = cols.live(j + e) ? W[(size_t)k * ldw + cols.phys(j + e)] : (int8_t)0;
        }
    }
}

// acc[i][j][c] of warp (wm, wn) = the block tile's row wm*MT*16 + 16i + g
// (+ 8 for c >= 2), column tc_col(wn, j, t, c), g = lane / 4, t = lane % 4,
// summed over k in [kbeg, kend) (F = TcInt4: each stage's sums times its
// group's scales, kbeg and kend multiples of w.group). smem holds T::SMEM
// bytes.
template <class T, class F = TcInt8>
static __device__ __forceinline__ void tc_tile_product(
    const bf16* __restrict__ A, const QWeight& w, int M, int K, int ldw,
    const TcCols& cols, int m0, int kbeg, int kend, unsigned char* smem,
    float (&acc)[T::MT][T::NT][4]) {
    static_assert(T::W_ROWS * F::KPR >= T::BK, "a stage's weight rows fit its ring slot");
    bf16* As = reinterpret_cast<bf16*>(smem);
    int8_t* Rs = reinterpret_cast<int8_t*>(smem + T::A_BYTES);
    const int8_t* W = reinterpret_cast<const int8_t*>(w.q);
    const int G = w.group;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
    const int wm = warp / T::WN, wn = warp % T::WN;
    const bool a_vec = K % 8 == 0 && ((uintptr_t)A & 15) == 0;
    const bool w_vec = ldw % 16 == 0 && (cols.half == T::BN || cols.stride % 16 == 0) &&
                       ((uintptr_t)W & 15) == 0;
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;

    const int ntiles = (kend - kbeg + T::BK - 1) / T::BK;
    for (int kt = 0; kt < T::STAGES - 1; ++kt) {
        if (kt < ntiles)
            tc_load_stage<T, F>(A, W, M, K, ldw, G, cols, m0, kbeg + kt * T::BK, kend, a_vec,
                                w_vec, As + (size_t)kt * T::BM * T::LDA,
                                Rs + (size_t)kt * T::W_ROWS * T::LDR);
        cp_async_commit();
    }
    // Lane l's ldmatrix rows: A rows (l % 8) + 8 * (l / 8 % 2) at k 8 * (l / 16);
    // weight rows (l % 8) + 8 * (l / 8 % 2) of group pair member l / 16.
    const int lr = lane % 8 + 8 * (lane / 8 % 2), lh = lane / 16;
    for (int kt = 0; kt < ntiles; ++kt) {
        // int4: the group scales of the lane's columns for this stage's group,
        // asked for before the wait so that their latency overlaps it.
        float gsc[T::NT][2];
        if constexpr (F::INT4) {
            const float* gr = w.gs + (size_t)((kbeg + kt * T::BK) / G) * ldw;
#pragma unroll
            for (int j = 0; j < T::NT; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int jj = tc_col<T>(wn, j, t, e);
                    gsc[j][e] = cols.live(jj) ? gr[cols.phys(jj)] : 0.f;
                }
        }
        cp_async_wait<T::STAGES - 2>();
        __syncthreads();  // stage kt landed; every warp is done with stage kt - 1
        {
            const int nk = kt + T::STAGES - 1, s = nk % T::STAGES;
            if (nk < ntiles)
                tc_load_stage<T, F>(A, W, M, K, ldw, G, cols, m0, kbeg + nk * T::BK, kend,
                                    a_vec, w_vec, As + (size_t)s * T::BM * T::LDA,
                                    Rs + (size_t)s * T::W_ROWS * T::LDR);
            cp_async_commit();
        }
        const bf16* Ak = As + (size_t)(kt % T::STAGES) * T::BM * T::LDA;
        const int8_t* Rk = Rs + (size_t)(kt % T::STAGES) * T::W_ROWS * T::LDR;
        // The stage's weights, widened: the B registers of every k step and
        // column tile (two 16-column groups a ldmatrix: matrices 0-1, 2-3).
        // int8: 16 weight rows a k step; int4: 16 packed rows give k step p
        // (low nibbles) and p + BK / 32 (high nibbles).
        uint32_t b[T::BK / 16][T::NT][2];
        constexpr int BLOCKS = T::BK / 16 / F::KPR;
#pragma unroll
        for (int p = 0; p < BLOCKS; ++p)
#pragma unroll
            for (int q = 0; q < T::NT / 2; q += 2) {
                uint32_t r[4];
                ldmatrix_x4<true>(r, Rk + (p * 16 + lr) * T::LDR + tc_group<T>(wn, q + lh));
#pragma unroll
                for (int h = 0; h < 2; ++h)
#pragma unroll
                    for (int v = 0; v < 2; ++v) {
                        const int je = 2 * (q + h), jo = je + 1;
                        if constexpr (F::INT4)
                            widen_u4_cols(r[2 * h + v], b[p][je][v], b[p][jo][v],
                                          b[p + BLOCKS][je][v], b[p + BLOCKS][jo][v]);
                        else
                            widen_i8_cols(r[2 * h + v], b[p][je][v], b[p][jo][v]);
                    }
            }
        // Row tile by row tile, the stage's sums go to a fresh accumulator and
        // are added to acc in f32 (round to nearest): the mma's own
        // accumulation truncates, and over a whole K that drifts from the f32
        // sums of the plain version.
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
            float part[T::NT][4];
#pragma unroll
            for (int j = 0; j < T::NT; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) part[j][c] = 0.f;
#pragma unroll
            for (int ks = 0; ks < T::BK / 16; ++ks) {
                uint32_t a[4];
                ldmatrix_x4<false>(a, Ak + ((wm * T::MT + i) * 16 + lr) * T::LDA + ks * 16 +
                                          8 * lh);
#pragma unroll
                for (int j = 0; j < T::NT; ++j) mma_bf16_16816(part[j], a, b[ks][j]);
            }
#pragma unroll
            for (int j = 0; j < T::NT; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    if constexpr (F::INT4)
                        acc[i][j][c] += part[j][c] * gsc[j][c & 1];
                    else
                        acc[i][j][c] += part[j][c];
                }
        }
    }
}

// v times the per-column scale s[n]; s null (int4: the sums are scaled
// already) leaves v.
static __device__ __forceinline__ float col_scale(const float* __restrict__ s, int n, float v) {
    return s ? v * s[n] : v;
}

// K splits of a tensor-core product whose grid has `blocks` (column tiles x
// row bands) before splitting, `want` blocks to fill the card. Each split is
// at least TC_SPLIT_K deep and a whole number of `step` k (the stage depth;
// for int4 the group, so that no split starts inside a group); the splits are
// summed in a fixed order by the caller's epilogue.
static inline int tc_kchunk(int blocks, int K, int want, int step) {
    int splits = (want + blocks - 1) / blocks;
    const int max_splits = K / TC_SPLIT_K;
    if (splits > max_splits) splits = max_splits;
    if (splits < 1) splits = 1;
    const int chunk = (K + splits - 1) / splits;
    return (chunk + step - 1) / step * step;
}

// The K chunk of configuration T for an M x N x K product (G: the int4
// group, 0 for int8): split until the grid fills every block the card holds
// at once (decode: to stream the weights through every SM; prefill: where
// the grid is small).
template <class T>
static inline int tc_chunk(int M, int N, int K, int G) {
    const int blocks = ((N + T::BN - 1) / T::BN) * ((M + T::BM - 1) / T::BM);
    return tc_kchunk(blocks, K, T::MIN_BLOCKS * TC_SMS, G ? G : T::BK);
}

// f(C{}) for the configuration C that takes M rows: a decode band that
// holds them all (16, 32 or 64), else Prefill's 128-row bands.
template <class Prefill = TcPrefill, class F>
static inline auto tc_by_band(int M, F&& f) {
    if (M <= 16) return f(TcDecode<1>{});
    if (M <= 32) return f(TcDecode<2>{});
    if (M <= TC_DECODE_ROWS) return f(TcDecode<4>{});
    return f(Prefill{});
}

// f(TcInt8{}) or f(TcInt4{}): the format of weight w.
template <class F>
static inline auto tc_by_format(const QWeight& w, F&& f) {
    if (w.gs) return f(TcInt4{});
    return f(TcInt8{});
}

// tc_by_band for weights of format Fmt: int4 decode bands take TcDecode4.
template <class Fmt, class Prefill = TcPrefill, class F>
static inline auto tc_band(int M, F&& f) {
    if constexpr (Fmt::INT4) {
        if (M <= 16) return f(TcDecode4<1>{});
        if (M <= 32) return f(TcDecode4<2>{});
        if (M <= TC_DECODE_ROWS) return f(TcDecode4<4>{});
        return f(Prefill{});
    } else {
        return tc_by_band<Prefill>(M, f);
    }
}

// Whether configuration T takes weight w: an int4 group is a whole number of
// its stages and K a whole number of groups (else cudaErrorInvalidValue, 1).
template <class T>
static inline int tc_takes(const QWeight& w, int K) {
    return w.gs && (w.group < T::BK || w.group % T::BK || K % w.group) ? 1 : 0;
}

// Dynamic shared memory for kern, asked for once per instantiation (T and
// the weight format F name it: the int8 and int4 kernels share a type).
template <class T, class F = void, class Kern>
static inline int tc_allow(Kern kern) {
    static const int err = allow_dynamic_smem(kern, T::SMEM);
    return err;
}

// P[z, m, n] = the z-th K split of A @ W over all N columns of W [K, N]; or,
// where out is given (a grid of one split), out[m, n] = bf16(acc * s[n])
// straight from the accumulators, so no f32 partial reaches memory.
template <class T, class F>
static __global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
tc_gemm_partial(const bf16* __restrict__ A, QWeight w, float* __restrict__ P,
                const float* __restrict__ s, bf16* __restrict__ out, int M, int N, int K,
                int kchunk) {
    DORA_DYNAMIC_SMEM(smem);
    const TcCols cols{T::BN, (int)blockIdx.x * T::BN, N, 0};
    const int m0 = blockIdx.y * T::BM, kbeg = blockIdx.z * kchunk;
    float acc[T::MT][T::NT][4];
    tc_tile_product<T, F>(A, w, M, K, N, cols, m0, kbeg, min(K, kbeg + kchunk), smem, acc);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wm = warp / T::WN, wn = warp % T::WN;
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int m = m0 + (wm * T::MT + i) * 16 + g + (c >= 2 ? 8 : 0);
                const int jj = tc_col<T>(wn, j, t, c);
                if (m >= M || !cols.live(jj)) continue;
                const int n = cols.phys(jj);
                if (out)
                    out[(size_t)m * N + n] = __float2bfloat16(col_scale(s, n, acc[i][j][c]));
                else
                    P[((size_t)blockIdx.z * M + m) * N + n] = acc[i][j][c];
            }
}

template <class T, class F>
static inline int tc_launch_partial(const bf16* A, const QWeight& w, float* P, const float* s,
                                    bf16* out, int M, int N, int K, void* stream) {
    int err = tc_takes<T>(w, K);
    if (err) return err;
    const int chunk = tc_chunk<T>(M, N, K, w.group);
    auto kern = tc_gemm_partial<T, F>;
    err = tc_allow<T, F>(kern);
    if (err) return err;
    dim3 grid((N + T::BN - 1) / T::BN, (M + T::BM - 1) / T::BM, (K + chunk - 1) / chunk);
    DORA_LAUNCH_SMEM(kern, grid, dim3(T::THREADS), T::SMEM, stream, A, w, P, s, out, M, N, K,
                     chunk);
    DORA_CHECK(err);
    return err;
}

// The product by the configuration for M rows and the format of w: f32
// partials of its K splits into P (int4: scaled by the group scales); or,
// with one split and out given, bf16(acc * s) (s null: acc) into out.
static inline int tc_gemm(const bf16* A, const QWeight& w, float* P, int M, int N, int K,
                          void* stream, const float* s = nullptr, bf16* out = nullptr) {
    return tc_by_format(w, [&](auto f) {
        return tc_band<decltype(f)>(M, [&](auto c) {
            return tc_launch_partial<decltype(c), decltype(f)>(A, w, P, s, out, M, N, K, stream);
        });
    });
}

// The number of K splits tc_gemm takes for an M x N x K product (G: the
// int4 group, 0 for int8).
static inline int tc_splits(int M, int N, int K, int G = 0) {
    auto chunk_of = [&](auto c) { return tc_chunk<decltype(c)>(M, N, K, G); };
    const int chunk = G ? tc_band<TcInt4>(M, chunk_of) : tc_band<TcInt8>(M, chunk_of);
    return (K + chunk - 1) / chunk;
}
