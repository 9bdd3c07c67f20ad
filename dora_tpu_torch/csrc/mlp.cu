// Fused SwiGLU sublayer: replaces the Pallas kernel _mlp_kernel /
// mlp_step of dora_tpu/ops/decode_block.py.
//
//   out = x + ((silu(g) * u).astype(bf16) @ q_down) * s_down
//   [g | u] = rms(x).astype(bf16) @ q_gateup * s_gateup + b_gateup
//
// Bound: the weight stream while rows are few. At Qwen2-1.5B width one call
// reads the int8 gate/up panel (1536 x 17920) and down panel (8960 x 1536),
// 41.3 MB, against a few hundred KB of activations at M = 16; at M = 256
// (prefill) the products reach 21 GFLOP and the call is bound by operations.
//
// int4 weights (the TPU kernel's branch on w_gateup.dtype == uint8): packed
// w_gateup [D/2, 2F] with group scales [D/G, 2F], w_down [F/2, D] with
// [F/G, D], half the bytes (20.6 MB at Qwen2-1.5B width). The same launches
// run the int4 form of the product (TcInt4, common.cuh), which applies the
// group scales itself, so every epilogue's per-column scale is null.
//
// Design: the TPU kernel sweeps the ffn in tiles and carries one f32
// accumulator from grid step to grid step. Hopper blocks run in no order, so
// the sweep is split into launches: RMSNorm rows; the gate/up product; the
// down product; an epilogue that sums the down product's K splits in order,
// applies s_down once and adds the residual in f32. Both products run on the
// tensor cores (tc_tile_product, common.cuh): bf16 rows times int8 weights
// widened to bf16 in shared memory, f32 sums.
//
// Above 64 rows (prefill), and wherever K is too short to split, one block
// owns gate columns [n0, n0 + W) and up columns [F + n0, F + n0 + W), applies
// scale and bias in f32 and writes bf16(silu(g) * u) straight from its
// accumulators: no f32 partials of the [M, 2F] product reach device memory.
// Decode splits K to stream the weights through every SM; its partials are
// summed in a fixed order by silu_mul. The cast before down is part of the
// reference math.
#include "common.cuh"

// a[m, f] = bf16(silu(g) * u) with g, u from the split partials of the
// [M, 2F] gate/up product (s null: the partials are scaled already).
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
    g = col_scale(s, f, g) + (b ? b[f] : 0.f);
    u = col_scale(s, F + f, u) + (b ? b[F + f] : 0.f);
    float silu = g / (1.f + expf(-g));
    a[idx] = __float2bfloat16(silu * u);
}

// The gate/up product over all of K with the SwiGLU in its epilogue: the
// block's first BN / 2 columns are gate columns n0.., the second BN / 2 the
// matching up columns F + n0.., so each thread holds g and u of its columns.
template <class T, class Fmt>
static __global__ void __launch_bounds__(T::THREADS, T::MIN_BLOCKS)
gateup_swiglu(const bf16* __restrict__ h, QWeight w, const float* __restrict__ s,
              const float* __restrict__ b, bf16* __restrict__ a, int M, int D, int F) {
    DORA_DYNAMIC_SMEM(smem);
    const TcCols cols{T::BN / 2, (int)blockIdx.x * (T::BN / 2), F, F};
    const int m0 = blockIdx.y * T::BM;
    float acc[T::MT][T::NT][4];
    tc_tile_product<T, Fmt>(h, w, M, D, 2 * F, cols, m0, 0, D, smem, acc);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int wm = warp / T::WN, wn = warp % T::WN;
#pragma unroll
    for (int i = 0; i < T::MT; ++i)
#pragma unroll
        for (int j = 0; j < T::NT / 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int m = m0 + (wm * T::MT + i) * 16 + g + (c >= 2 ? 8 : 0);
                const int f = cols.col0 + tc_col<T>(wn, j, t, c);
                if (m >= M || f >= F) continue;
                const float gv = col_scale(s, f, acc[i][j][c]) + (b ? b[f] : 0.f);
                const float uv = col_scale(s, F + f, acc[i][j + T::NT / 2][c]) +
                                 (b ? b[F + f] : 0.f);
                a[(size_t)m * F + f] = __float2bfloat16(gv / (1.f + expf(-gv)) * uv);
            }
}

// The gate/up product of a prefill band: 80 gate and 80 up columns a block
// over 2 x 5 warps, so that Qwen2-1.5B's 8960 / 80 = 112 column tiles of two
// 128-row bands fill the card's 264 block slots in one round (64 + 64
// columns make 280 blocks and a second round of 16); 32 k a stage, which
// leaves the 320 threads the fewest spilled registers.
using TcSwiglu = TcCfg<4, 4, 2, 5, 4, 2, 32>;

template <class T, class Fmt>
static inline int launch_swiglu(const bf16* h, const QWeight& w, const float* s,
                                const float* b, bf16* a, int M, int D, int F, void* stream) {
    int err = tc_takes<T>(w, D);
    if (err) return err;
    auto kern = gateup_swiglu<T, Fmt>;
    err = tc_allow<T, Fmt>(kern);
    if (err) return err;
    dim3 grid((F + T::BN / 2 - 1) / (T::BN / 2), (M + T::BM - 1) / T::BM);
    DORA_LAUNCH_SMEM(kern, grid, dim3(T::THREADS), T::SMEM, stream, h, w, s, b, a, M, D, F);
    DORA_CHECK(err);
    return err;
}

// One 16 x 16 x 16 tile through the product's fragment path (one warp): A
// bf16 [16, 16] and W int8 [16, 16] in shared memory, A read with ldmatrix,
// W with ldmatrix.trans as 16-bit pairs and widened by widen_i8_cols, one
// mma for the even columns and one for the odd: D f32 [16, 16] = A @ W.
// Checks that path against a plain product, on the card and in the emulated
// build.
static __global__ void __launch_bounds__(32)
tc_tile(const bf16* __restrict__ A, const int8_t* __restrict__ W, float* __restrict__ D) {
    DORA_DYNAMIC_SMEM(smem);
    constexpr int LD = 24;  // bf16 an A row: 48 bytes, 16-byte aligned
    bf16* As = reinterpret_cast<bf16*>(smem);
    int8_t* Rs = reinterpret_cast<int8_t*>(As + 16 * LD);  // 16-byte rows
    const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
    for (int i = lane; i < 256; i += 32) {
        As[(i / 16) * LD + i % 16] = A[i];
        Rs[i] = W[i];
    }
    __syncthreads();
    const int lr = lane % 8 + 8 * (lane / 8 % 2), lh = lane / 16;
    uint32_t a[4], r[4], even[2], odd[2];
    ldmatrix_x4<false>(a, As + lr * LD + 8 * lh);
    ldmatrix_x4<true>(r, Rs + lr * 16);
    widen_i8_cols(r[0], even[0], odd[0]);
    widen_i8_cols(r[1], even[1], odd[1]);
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    mma_bf16_16816(d[0], a, even);
    mma_bf16_16816(d[1], a, odd);
    for (int p = 0; p < 2; ++p)
        for (int c = 0; c < 4; ++c)
            D[(g + (c >= 2 ? 8 : 0)) * 16 + 4 * t + 2 * (c & 1) + p] = d[p][c];
}

extern "C" int dora_tc_tile(const void* A, const void* W, void* D, void* stream) {
    int err = 0;
    DORA_LAUNCH_SMEM(tc_tile, dim3(1), dim3(32), 16 * 24 * 2 + 256, stream,
                     (const bf16*)A, (const int8_t*)W, (float*)D);
    DORA_CHECK(err);
    return err;
}

// The int4 form of tc_tile: A bf16 [16, 32] and W [16, 16] bytes, one group
// of 32 rows packed as ops/int4.py packs it (the low nibble of byte [j, n] is
// row j, the high nibble row 16 + j, each q + 8): one ldmatrix.trans of W
// gives the B registers of both k steps through widen_u4_cols, and D f32
// [16, 16] = A @ q, the product's fragment path for int4 weights.
static __global__ void __launch_bounds__(32)
tc_tile4(const bf16* __restrict__ A, const uint8_t* __restrict__ W, float* __restrict__ D) {
    DORA_DYNAMIC_SMEM(smem);
    constexpr int LD = 40;  // bf16 an A row: 80 bytes, 16-byte aligned
    bf16* As = reinterpret_cast<bf16*>(smem);
    int8_t* Rs = reinterpret_cast<int8_t*>(As + 16 * LD);  // 16-byte rows
    const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
    for (int i = lane; i < 512; i += 32) As[(i / 32) * LD + i % 32] = A[i];
    for (int i = lane; i < 256; i += 32) Rs[i] = (int8_t)W[i];
    __syncthreads();
    const int lr = lane % 8 + 8 * (lane / 8 % 2), lh = lane / 16;
    uint32_t r[4], b[2][2][2];  // [k step][even, odd][register]
    ldmatrix_x4<true>(r, Rs + lr * 16);
    for (int v = 0; v < 2; ++v)
        widen_u4_cols(r[v], b[0][0][v], b[0][1][v], b[1][0][v], b[1][1][v]);
    float d[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    for (int ks = 0; ks < 2; ++ks) {
        uint32_t a[4];
        ldmatrix_x4<false>(a, As + lr * LD + 16 * ks + 8 * lh);
        mma_bf16_16816(d[0], a, b[ks][0]);
        mma_bf16_16816(d[1], a, b[ks][1]);
    }
    for (int p = 0; p < 2; ++p)
        for (int c = 0; c < 4; ++c)
            D[(g + (c >= 2 ? 8 : 0)) * 16 + 4 * t + 2 * (c & 1) + p] = d[p][c];
}

extern "C" int dora_tc_tile4(const void* A, const void* W, void* D, void* stream) {
    int err = 0;
    DORA_LAUNCH_SMEM(tc_tile4, dim3(1), dim3(32), 16 * 40 * 2 + 256, stream,
                     (const bf16*)A, (const uint8_t*)W, (float*)D);
    DORA_CHECK(err);
    return err;
}

// K splits of the gate/up (which 0; 1 = fused SwiGLU, no partials) and down
// (which 1) products at M rows, G the int4 group of that product's weight (0:
// int8). A prefill band runs the gate/up product whole; decode splits it as
// tc_gemm does.
extern "C" int dora_mlp_splits(int M, int D, int F, int which, int G) {
    if (which == 0) return M > TC_DECODE_ROWS ? 1 : tc_splits(M, 2 * F, D, G);
    return tc_splits(M, D, F, G);
}

// f32 elements of the partials scratch dora_mlp_step needs (-1 past int).
extern "C" int dora_mlp_scratch(int M, int D, int F, int g_gu, int g_down) {
    const long long gu = dora_mlp_splits(M, D, F, 0, g_gu);
    long long need = gu > 1 ? gu * M * 2 * F : 0;
    const long long dn = (long long)dora_mlp_splits(M, D, F, 1, g_down) * M * D;
    if (dn > need) need = dn;
    return need > INT_MAX ? -1 : (int)need;
}

// x [M, D] bf16; norm_w [D] f32; b_gu [2F] f32 or null. Weights int8 with
// per-column f32 scales (g_gu, g_down 0): w_gu [D, 2F] with s_gu [2F],
// w_down [F, D] with s_down [D]; or int4 (g_gu, g_down their groups, each a
// multiple of TC_MAX_BK): w_gu [D/2, 2F] with group scales s_gu [D/g_gu, 2F],
// w_down [F/2, D] with s_down [F/g_down, D].
// out [M, D]: bf16 (x + delta) when residual, else f32 delta.
// Scratch: h bf16 [M, D]; a bf16 [M, F]; p f32 of dora_mlp_scratch(M, D, F,
// g_gu, g_down).
extern "C" int dora_mlp_step(const void* x, const void* norm_w, const void* w_gu,
                             const void* s_gu, const void* b_gu,
                             const void* w_down, const void* s_down, void* out,
                             int residual, int M, int D, int F, int g_gu, int g_down,
                             float eps, void* h, void* a, void* p, void* stream) {
    int err = 0;
    DORA_LAUNCH(rmsnorm_rows, dim3(M), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    auto keep = [&](int e) { if (!err) err = e; };
    const bf16* hb = (const bf16*)h;
    // int4: the products apply the group scales, the epilogues none
    const QWeight wg = g_gu ? QWeight(w_gu, (const float*)s_gu, g_gu)
                            : QWeight((const int8_t*)w_gu);
    const QWeight wd = g_down ? QWeight(w_down, (const float*)s_down, g_down)
                              : QWeight((const int8_t*)w_down);
    const float* sg = g_gu ? nullptr : (const float*)s_gu;
    const float* sd = g_down ? nullptr : (const float*)s_down;
    const float* bg = (const float*)b_gu;
    const int gu = dora_mlp_splits(M, D, F, 0, g_gu);
    if (gu == 1) {
        keep(tc_by_format(wg, [&](auto f) {
            return tc_band<decltype(f), TcSwiglu>(M, [&](auto c) {
                return launch_swiglu<decltype(c), decltype(f)>(hb, wg, sg, bg, (bf16*)a, M, D,
                                                               F, stream);
            });
        }));
    } else {
        keep(tc_gemm(hb, wg, (float*)p, M, 2 * F, D, stream));
        size_t total = (size_t)M * F;
        DORA_LAUNCH(silu_mul, dim3((unsigned)((total + 255) / 256)), dim3(256), stream,
                    (const float*)p, gu, M, F, sg, bg, (bf16*)a);
        DORA_CHECK(err);
    }
    keep(tc_gemm((const bf16*)a, wd, (float*)p, M, D, F, stream));
    launch_epilogue((const float*)p, tc_splits(M, D, F, g_down), M, D, sd, nullptr,
                    residual ? (const bf16*)x : nullptr, residual ? (bf16*)out : nullptr,
                    residual ? nullptr : (float*)out, stream, err);
    return err;
}
