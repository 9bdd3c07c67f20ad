// Int8 weight-only product: replaces the Pallas kernel _kernel / int8_matmul
// of dora_tpu/ops/int8_matmul.py.
//
//   out[m, n] = bf16((sum_k x[m, k] * q[k, n]) * scale[n])
//
// x [M, K] bf16, q [K, N] int8, scale [N] f32: the int8 values widen to f32
// inside the kernel (exact, as the TPU kernel's cast to bf16 is), the products
// accumulate in f32, the per-column scale multiplies the accumulator once and
// the result rounds to bf16: the reference order (int8_matmul.py _kernel).
// Any M, K and N: ragged edges are masked here, the caller pads nothing.
//
// Bound: at matvec widths (M <= 32: the prefill head on one row, the
// projections of short prompts, unfused decode) the weight bytes, one pass
// over q per call (the head at Qwen2-1.5B width, 1536 x 151936, is 233 MB);
// at large M (the DORA_INT8_PURE prefill) the products.
//
// Design (simple first): the K-split tile product of common.cuh, as
// mlp_step's products run it. Every block owns a 16*TM x 128 output tile
// (TM 1 for M <= 16, 4 above) and one K range; blocks are laid out so the
// grid fills the card twice over, splitting K when N alone gives too few
// tiles. A second launch sums the splits in a fixed order (no atomics, the
// result does not depend on scheduling), applies the scale and rounds.
// Every row tile reads q once, so M <= 64 streams q exactly once; larger M
// reads it once per 64-row band (from L2 where it fits).
#include "common.cuh"

extern "C" int dora_gemm_splits(int M, int N, int K) {
    return gemm_splits(M, N, K);
}

// x [M, K] bf16; q [K, N] int8; scale [N] f32; out [M, N] bf16.
// Scratch: p f32 of dora_gemm_splits(M, N, K) * M * N.
extern "C" int dora_int8_matmul(const void* x, const void* q, const void* scale,
                                void* out, int M, int N, int K, void* p,
                                void* stream) {
    int err = 0;
    launch_gemm((const bf16*)x, (const int8_t*)q, (float*)p, M, N, K, stream, err);
    launch_epilogue((const float*)p, gemm_splits(M, N, K), M, N,
                    (const float*)scale, nullptr, nullptr, (bf16*)out, nullptr,
                    stream, err);
    return err;
}
