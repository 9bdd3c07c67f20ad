// Fused SwiGLU sublayer: replaces the Pallas kernel _mlp_kernel /
// mlp_step of dora_tpu/ops/decode_block.py.
//
//   out = x + ((silu(g) * u).astype(bf16) @ q_down) * s_down
//   [g | u] = rms(x).astype(bf16) @ q_gateup * s_gateup + b_gateup
//
// Bound: the weight stream. At Qwen2-1.5B width one call reads the int8
// gate/up panel (1536 x 17920) and down panel (8960 x 1536), 41.3 MB, against
// a few hundred KB of activations at M = 16; at M = 256 (prefill) the
// products reach 21 GFLOP and the call becomes bound by operations.
//
// Design: the TPU kernel sweeps the ffn in tiles and carries one f32
// accumulator from grid step to grid step. Hopper blocks run in no order, so
// the sweep is split into launches: RMSNorm rows; the gate/up product with K
// split across blocks; an epilogue that sums the splits, applies scale and
// bias and writes silu(g) * u as bf16 (the cast before down is part of the
// reference math); the down product; an epilogue that applies s_down once
// and adds the residual in f32.
#include "common.cuh"

// a[m, f] = bf16(silu(g) * u) with g, u from the split partials of the fused
// [M, 2F] gate/up product.
static __global__ void __launch_bounds__(256)
silu_mul(const float* __restrict__ P, int splits, int M, int F,
         const float* __restrict__ s, const float* __restrict__ b,
         bf16* __restrict__ a) {
    size_t idx = (size_t)blockIdx.x * 256 + threadIdx.x;
    if (idx >= (size_t)M * F) return;
    int m = (int)(idx / F), f = (int)(idx % F);
    size_t N = 2 * (size_t)F;
    float g = 0.f, u = 0.f;
    for (int z = 0; z < splits; ++z) {
        const float* pz = P + (size_t)z * M * N + (size_t)m * N;
        g += pz[f];
        u += pz[F + f];
    }
    g = g * s[f] + (b ? b[f] : 0.f);
    u = u * s[F + f] + (b ? b[F + f] : 0.f);
    float silu = g / (1.f + expf(-g));
    a[idx] = __float2bfloat16(silu * u);
}

extern "C" int dora_gemm_splits(int M, int N, int K) {
    return gemm_splits(M, N, K);
}

// x [M, D] bf16; norm_w [D] f32; w_gu int8 [D, 2F]; s_gu [2F] f32;
// b_gu [2F] f32 or null; w_down int8 [F, D]; s_down [D] f32.
// out [M, D]: bf16 (x + delta) when residual, else f32 delta.
// Scratch: h bf16 [M, D]; a bf16 [M, F]; p f32 of
// max(splits(M, 2F, D) * M * 2F, splits(M, D, F) * M * D).
extern "C" int dora_mlp_step(const void* x, const void* norm_w, const void* w_gu,
                             const void* s_gu, const void* b_gu,
                             const void* w_down, const void* s_down, void* out,
                             int residual, int M, int D, int F, float eps,
                             void* h, void* a, void* p, void* stream) {
    int err = 0;
    DORA_LAUNCH(rmsnorm_rows, dim3(M), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    launch_gemm((const bf16*)h, (const int8_t*)w_gu, (float*)p, M, 2 * F, D,
                stream, err);
    int splits = gemm_splits(M, 2 * F, D);
    size_t total = (size_t)M * F;
    DORA_LAUNCH(silu_mul, dim3((unsigned)((total + 255) / 256)), dim3(256),
                stream, (const float*)p, splits, M, F, (const float*)s_gu,
                (const float*)b_gu, (bf16*)a);
    DORA_CHECK(err);
    launch_gemm((const bf16*)a, (const int8_t*)w_down, (float*)p, M, D, F,
                stream, err);
    launch_epilogue((const float*)p, gemm_splits(M, D, F), M, D,
                    (const float*)s_down, nullptr,
                    residual ? (const bf16*)x : nullptr,
                    residual ? (bf16*)out : nullptr,
                    residual ? nullptr : (float*)out, stream, err);
    return err;
}
