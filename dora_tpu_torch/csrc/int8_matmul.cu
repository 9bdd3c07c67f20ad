// Int8 weight-only product: replaces the Pallas kernel _kernel / int8_matmul
// of dora_tpu/ops/int8_matmul.py.
//
//   out[m, n] = bf16((sum_k x[m, k] * q[k, n]) * scale[n])
//
// x [M, K] bf16, q [K, N] int8, scale [N] f32: the int8 values widen to bf16
// inside the kernel (exact, as the TPU kernel's cast is), the products
// accumulate in f32, the per-column scale multiplies the accumulator once and
// the result rounds to bf16: the reference order (int8_matmul.py _kernel).
// Any M, K and N: ragged edges are masked here, the caller pads nothing.
//
// Bound: at matvec widths (M <= 32: the prefill head on one row, the
// projections of short prompts, unfused decode) the weight bytes, one pass
// over q per call (the head at Qwen2-1.5B width, 1536 x 151936, is 233 MB);
// at large M (the DORA_INT8_PURE prefill) the products.
//
// Design: the tensor-core product of kernels 1 and 2 (tc_gemm, common.cuh):
// bf16 rows and int8 weight rows through a cp.async ring, the int8 bytes read
// by ldmatrix.trans and widened exactly in registers, mma.sync m16n8k16 with
// each stage's sums added in f32. Up to 64 rows one band holds them all and
// streams q once; above, 128-row bands. Where the column tiles alone fill the
// card (the head at one row: 1187 tiles) K is not split, and each block
// applies the scale to its accumulators and writes bf16 straight from the
// mma fragments: one launch, no f32 partial of the [M, N] product in memory.
// Where they do not (a short prompt's wqkv: 16 tiles), K is split to stream
// q through every SM, and a second launch sums the splits in a fixed order
// (no atomics: the result does not depend on scheduling), applies the scale
// and rounds.
#include "common.cuh"

// The K splits of an M x N x K product (1: the fused epilogue, no scratch).
extern "C" int dora_int8_matmul_splits(int M, int N, int K) {
    return tc_splits(M, N, K);
}

// x [M, K] bf16; q [K, N] int8; scale [N] f32; out [M, N] bf16.
// Scratch: p f32 of splits * M * N where dora_int8_matmul_splits(M, N, K)
// is above 1 (null where it is 1).
extern "C" int dora_int8_matmul(const void* x, const void* q, const void* scale,
                                void* out, int M, int N, int K, void* p,
                                void* stream) {
    const int splits = tc_splits(M, N, K);
    const float* s = (const float*)scale;
    if (splits == 1)
        return tc_gemm((const bf16*)x, (const int8_t*)q, nullptr, M, N, K, stream, s,
                       (bf16*)out);
    int err = tc_gemm((const bf16*)x, (const int8_t*)q, (float*)p, M, N, K, stream);
    launch_epilogue((const float*)p, splits, M, N, s, nullptr, nullptr, (bf16*)out, nullptr,
                    stream, err);
    return err;
}
