// Grouped (multi-tenant) LoRA delta: replaces the Pallas kernel
// lora_gather_matmul of dora_tpu/ops/lora.py.
//
// y[i] = (x[i] @ A[g[i]]) @ B[g[i]] for every row i, gathered by adapter id
// g[i] out of the resident stacks A [S, D, r] / B [S, r, N] (one layer's
// slice of the [S, L, ...] stacks, so consecutive slots sit `a_slot` /
// `b_slot` elements apart), f32 accumulation, y in bf16 (x's dtype).
//
// Bound: bytes. The work is 4 * R * D * r operations against the distinct
// slabs of A and B (2 * D * r bf16 each) plus x and y; at decode width (16
// rows, D 1536, r 32) that is a few microseconds of HBM time and far less
// of tensor-core time.
//
// Design (simple first): one block of 256 threads per row. The row of x is
// staged in shared memory as f32; t = x @ A[g] is taken by (d-slice, column)
// thread pairs (256 / r slices of D; at the largest rank, 256, one thread
// per column over all of D), whose partial sums are added in a fixed order,
// and kept in shared memory in f32, unrounded, as the reference keeps it;
// then each
// thread produces output columns n, tid + 256, ... from t and B[g]. Slot 0 is
// the all-zeros base adapter by contract: its rows skip the slab reads and
// write exact zeros, which is what the reference's product of zeros gives.
// The slab reads are the latency chain (each thread makes D*r/256 loads
// per phase), so both loops are unrolled to keep several loads in flight.
// Each row reads its slabs itself, so rows that share an adapter read them
// again (from L2); grouping rows by id, so each distinct slab is read once,
// is the obvious next speed step.
#include "common.cuh"

constexpr int LT = 256;        // threads per row
constexpr int LMAXD = 8192;    // most model width the kernel takes (ops/lora.py KERNEL_MAX_DIM)
constexpr int LMAXR = 256;     // most adapter rank the kernel takes (KERNEL_MAX_RANK)

static __global__ void __launch_bounds__(LT)
lora_gather_rows(const bf16* __restrict__ x, const int* __restrict__ groups,
                 const bf16* __restrict__ a, const bf16* __restrict__ b,
                 long long a_slot, long long b_slot, bf16* __restrict__ y,
                 int D, int R, int N) {
    __shared__ float xs[LMAXD];
    __shared__ float part[LT];
    __shared__ float t[LMAXR];
    const int i = blockIdx.x, tid = threadIdx.x;
    const int g = groups[i];
    bf16* __restrict__ yr = y + (size_t)i * N;
    if (g == 0) {  // uniform over the block: no thread reaches a barrier
        for (int n = tid; n < N; n += LT) yr[n] = __float2bfloat16(0.f);
    } else {
        const bf16* __restrict__ ag = a + (size_t)g * a_slot;
        const bf16* __restrict__ bg = b + (size_t)g * b_slot;
        for (int d = tid; d < D; d += LT) xs[d] = __bfloat162float(x[(size_t)i * D + d]);
        __syncthreads();
        const int S = LT / R;  // d-slices
        float acc = 0.f;
        if (tid < S * R) {
            const int j = tid % R, s = tid / R;
#pragma unroll 8
            for (int d = s; d < D; d += S) acc += xs[d] * __bfloat162float(ag[(size_t)d * R + j]);
        }
        part[tid] = acc;
        __syncthreads();
        if (tid < R) {
            float tt = 0.f;
            for (int s = 0; s < S; ++s) tt += part[s * R + tid];
            t[tid] = tt;
        }
        __syncthreads();
        for (int n = tid; n < N; n += LT) {
            float o = 0.f;
#pragma unroll 8
            for (int j = 0; j < R; ++j) o += t[j] * __bfloat162float(bg[(size_t)j * N + n]);
            yr[n] = __float2bfloat16(o);
        }
    }
}

// x [rows, D] bf16; groups [rows] int32 in [0, S) (the caller's contract:
// not checked on the card); a: slot s's [D, r] bf16 block at a + s * a_slot;
// b: slot s's [r, N] bf16 block at b + s * b_slot; y [rows, N] bf16.
// 1 <= r <= LMAXR, D <= LMAXD.
extern "C" int dora_lora_gather_matmul(const void* x, const void* groups,
                                       const void* a, const void* b,
                                       long long a_slot, long long b_slot, void* y,
                                       int rows, int D, int r, int N, void* stream) {
    int err = 0;
    DORA_LAUNCH(lora_gather_rows, dim3(rows), dim3(LT), stream,
                (const bf16*)x, (const int*)groups, (const bf16*)a, (const bf16*)b,
                a_slot, b_slot, (bf16*)y, D, r, N);
    DORA_CHECK(err);
    return err;
}
