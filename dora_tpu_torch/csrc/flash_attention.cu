// Flash attention (self-attention with an online softmax): replaces the
// Pallas kernel _flash_kernel / flash_attention of
// dora_tpu/ops/flash_attention.py.
//
//   out[b, h, i] = sum_j softmax_j(q[b, h, i] . k[b, h, j] / sqrt(D)) v[b, h, j]
//
// over q, k, v [B, H, T, D] bf16 of one length T (keys j <= i only when
// causal), the scores, the running max m, the denominator l and the [BQ, D]
// accumulator in f32 as the reference keeps them (its scores and P.V are
// f32 dots of the f32-widened inputs; the probabilities are not rounded),
// the output rounded once to bf16. The running max starts at f32's lowest
// value and masked scores sit there too, with their probabilities forced to
// 0, exactly as the reference does, so a row whose every key is masked ends
// with l = 0 and emits 0 (the reference's finalize).
//
// Shapes: any T; any D that is a multiple of 8 up to 128 (the bench ViT's
// 80, the tiny config's 16). The reference pads T to its 256-row block and
// D to the TPU's 128 lanes in device memory; here nothing is padded in
// memory: D is rounded up to 16 in shared memory only (the zero columns add
// nothing to scores or outputs), and keys past T land as zeros and are
// masked. Tensors come with their strides (elements; D contiguous), so a
// [B, T, H, D] projection seen as [B, H, T, D] is read in place and the
// output can be written in the caller's layout.
//
// Bound: at the ViT's shape (16 heads of 80 over 256 patches, one image)
// the bytes (q, k, v read and out written once: 2.6 MB, 0.78 us at 3.35
// TB/s); causal over 2048 rows (12 heads of 128) the products (12.9 GFLOP,
// 13 us at 989 TFLOP/s in bf16).
//
// Design (mma.sync; wgmma, TMA and warp specialisation come later): a block
// of 4 warps owns 64 query rows of one (b, h), 16 rows a warp. Each warp reads
// its q rows once with ldmatrix into mma A fragments and keeps them in
// registers. K and V stream in BK-key tiles through a cp.async ring, rows
// padded by 16 bytes so the 8 rows an ldmatrix reads fall in distinct banks.
// S = Q K^T runs on mma.sync m16n8k16 with K row-major as the B operand
// (ldmatrix); the online softmax runs on the S accumulators in registers,
// each row's max and sum across the lane quad by shuffles. P stays in
// registers: two neighbouring n8 accumulator tiles of S are the A fragment
// of one k16 step of P.V, whose B operand is V read with ldmatrix.trans.
// The reference's p is f32, so P.V is two mma: one on hi = bf16(p), one on
// lo = bf16(p - hi), which keep 16 bits of p (V is exact in bf16); l sums
// the f32 p. The softmax runs in log2 units, exp2 with log2 e folded into
// the scale where the reference takes exp (the outputs sit as far from f64
// as the plain version's, PERF.md).
// Causal blocks stop at the last key tile their rows can see, mask only
// tiles that cross the diagonal or T, and the grid runs the last (heaviest)
// query tiles first.
#include "common.cuh"

constexpr int FD = 128;  // largest head_dim
constexpr float F_LOWEST = -3.402823466e38f;  // the reference's finfo(f32).min

// D16 the head_dim rounded up to 16; 4 warps of 16 query rows; BK keys a
// stage, in a ring of STAGES (two blocks an SM: 87 KB of shared memory at
// D16 128); rows of LD bf16 in shared memory (16-byte aligned, LD / 8 odd:
// conflict-free ldmatrix).
template <int D16_>
struct FlashCfg {
    static constexpr int D16 = D16_;
    static constexpr int BQ = 64, THREADS = 128, BK = 64;
    static constexpr int STAGES = D16 <= 64 ? 4 : 2;
    static constexpr int LD = D16 + 8;
    static constexpr int TILE = BK * LD;  // bf16 of one K or V stage
    static constexpr size_t SMEM = ((size_t)BQ * LD + (size_t)STAGES * 2 * TILE) * 2;
};

// Rows [r0, r0 + N) of one (b, h) plane (row stride st) into dst (row stride
// C::LD): 16-byte cp.async where `vec`, else element by element; rows at or
// past T and columns at or past D (whole 8-column chunks) land as zeros.
template <class C, int N>
static __device__ __forceinline__ void flash_rows(bf16* __restrict__ dst,
                                                  const bf16* __restrict__ src, long long st,
                                                  int r0, int T, int D, bool vec) {
    constexpr int CH = C::D16 / 8, ALL = N * CH;
    if (vec) {
#pragma unroll
        for (int i = 0; i < (ALL + C::THREADS - 1) / C::THREADS; ++i) {
            const int c = threadIdx.x + i * C::THREADS;
            if (ALL % C::THREADS && c >= ALL) break;
            const int r = c / CH, e = (c % CH) * 8, row = r0 + r;
            const bool live = row < T && e < D;
            cp_async16(dst + r * C::LD + e, live ? src + row * st + e : src, live);
        }
        return;
    }
    for (int c = threadIdx.x; c < ALL; c += C::THREADS) {
        const int r = c / CH, e = (c % CH) * 8, row = r0 + r;
        const bool live = row < T && e < D;
        for (int i = 0; i < 8; ++i)
            dst[r * C::LD + e + i] = live ? src[row * st + e + i] : __float2bfloat16(0.f);
    }
}

template <class C>
static __global__ void __launch_bounds__(C::THREADS, 2)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int H, int T, int D,
          long long qsb, long long qsh, long long qst, long long ksb, long long ksh,
          long long kst, long long vsb, long long vsh, long long vst, long long osb,
          long long osh, long long ost, int causal, float scale, int vec) {
    constexpr int D16 = C::D16, BK = C::BK, LD = C::LD, STAGES = C::STAGES;
    constexpr int NS = BK / 8, NO = D16 / 8;  // n8 tiles of S and of the output
    DORA_DYNAMIC_SMEM(smem);
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* KVs = Qs + C::BQ * LD;  // stage s: K at KVs + 2 s TILE, V after it
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
    const int bh = blockIdx.x, b = bh / H, h = bh % H;
    const int qt = causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
    const int q0 = qt * C::BQ;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;
    // Causal: the keys past the tile's last row contribute nothing.
    const int kend = causal ? min(T, q0 + C::BQ) : T;
    const int ntiles = (kend + BK - 1) / BK;

    auto load_kv = [&](int kt) {
        bf16* ks = KVs + (size_t)(kt % STAGES) * 2 * C::TILE;
        flash_rows<C, BK>(ks, kb, kst, kt * BK, T, D, vec);
        flash_rows<C, BK>(ks + C::TILE, vb, vst, kt * BK, T, D, vec);
    };
    flash_rows<C, C::BQ>(Qs, qb, qst, q0, T, D, vec);  // joins the first group
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        if (s < ntiles) load_kv(s);
        cp_async_commit();
    }

    // Lane l's ldmatrix row: l % 8 of matrix l / 8, whose rows start 8 down
    // for odd matrices (lr) and columns 8 right for the upper two (lh).
    const int lr = lane % 8 + 8 * (lane / 8 % 2), lh = lane / 16;
    const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;  // this lane's rows
    uint32_t qf[D16 / 16][4];
    float acc[NO][4];
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
    float m_r[2] = {F_LOWEST, F_LOWEST}, l_r[2] = {0.f, 0.f};  // in log2 units
    const float scale_log2 = scale * 1.4426950408889634f;

    for (int kt = 0; kt < ntiles; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // tile kt (and q) landed; every warp is done with tile kt - 1
        if (kt + STAGES - 1 < ntiles) load_kv(kt + STAGES - 1);
        cp_async_commit();
        if (kt == 0) {
#pragma unroll
            for (int ks = 0; ks < D16 / 16; ++ks)
                ldmatrix_x4<false>(qf[ks], Qs + (warp * 16 + lr) * LD + ks * 16 + 8 * lh);
        }
        const bf16* Ks = KVs + (size_t)(kt % STAGES) * 2 * C::TILE;
        const bf16* Vs = Ks + C::TILE;
        const int k0 = kt * BK;

        // S = Q K^T: K rows are the B operand's columns (ldmatrix, not .trans):
        // matrices 0-1 give n8 tile 2p (d 0-7, 8-15 of the k16 step), 2-3 tile
        // 2p + 1; a k step's fragments are all loaded before its mma.
        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
        for (int ks = 0; ks < D16 / 16; ++ks) {
            uint32_t kf[NS / 2][4];
#pragma unroll
            for (int p = 0; p < NS / 2; ++p)
                ldmatrix_x4<false>(kf[p], Ks + (16 * p + 8 * lh + lane % 8) * LD + ks * 16 +
                                              8 * (lane / 8 % 2));
#pragma unroll
            for (int p = 0; p < NS / 2; ++p) {
                const uint32_t b0[2] = {kf[p][0], kf[p][1]}, b1[2] = {kf[p][2], kf[p][3]};
                mma_bf16_16816(s[2 * p], qf[ks], b0);
                mma_bf16_16816(s[2 * p + 1], qf[ks], b1);
            }
        }

        // The online softmax on the accumulators, in log2 units: x = s log2 e
        // and m alike, so p = 2^(x - m) = e^(s - m / log2 e), the MUFU.EX2
        // that expf also ends in, without its range reduction. s[j][c] is
        // row row_a (c < 2) or row_b, key k0 + 8j + 2t + (c & 1). Only tiles
        // that cross T or the diagonal mask; the masked p is 0 exactly.
        const bool edge = k0 + BK > T || (causal && k0 + BK - 1 > q0);
        auto masked = [&](int j, int c) {
            const int key = k0 + 8 * j + 2 * t + (c & 1);
            return key >= T || (causal && key > (c < 2 ? row_a : row_b));
        };
        float mx[2] = {F_LOWEST, F_LOWEST};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float x = s[j][c] * scale_log2;
                if (edge && masked(j, c)) x = F_LOWEST;
                s[j][c] = x;
                mx[c / 2] = fmaxf(mx[c / 2], x);
            }
        float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 1));
            mx[r] = fmaxf(mx[r], shfl_xor(mx[r], 2));
            const float m_new = fmaxf(m_r[r], mx[r]);
            alpha[r] = exp2f(m_r[r] - m_new);
            m_r[r] = m_new;
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                float p = exp2f(s[j][c] - m_r[c / 2]);
                if (edge && masked(j, c)) p = 0.f;
                s[j][c] = p;
                sum[c / 2] += p;
            }
#pragma unroll
        for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[j][c] *= alpha[c / 2];

        // acc += P V: n8 tiles 2kk and 2kk + 1 of S are the A fragment of k16
        // step kk, split into hi + lo; V by ldmatrix.trans, matrices 0-1 the
        // B registers of output tile 2dp, 2-3 of tile 2dp + 1. Every hi mma
        // goes before the lo ones: no mma depends on the one before it.
#pragma unroll
        for (int kk = 0; kk < NS / 2; ++kk) {
            uint32_t vf[NO / 2][4];
#pragma unroll
            for (int dp = 0; dp < NO / 2; ++dp)
                ldmatrix_x4<true>(vf[dp], Vs + (16 * kk + lr) * LD + 16 * dp + 8 * lh);
            uint32_t hi[4], lo[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // a[i]: tile 2kk + i / 2, row g (+ 8 for odd i)
                const float x0 = s[2 * kk + i / 2][2 * (i % 2)];
                const float x1 = s[2 * kk + i / 2][2 * (i % 2) + 1];
                const bf16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
                hi[i] = pack_bf16(h0, h1);
                lo[i] = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
            }
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
#pragma unroll
                for (int dp = 0; dp < NO / 2; ++dp) {
                    const uint32_t b0[2] = {vf[dp][0], vf[dp][1]}, b1[2] = {vf[dp][2], vf[dp][3]};
                    mma_bf16_16816(acc[2 * dp], h2 ? lo : hi, b0);
                    mma_bf16_16816(acc[2 * dp + 1], h2 ? lo : hi, b1);
                }
        }
    }

    // l over the quad (each lane summed its own columns); rows past T and
    // columns past D are not written.
    bf16* ob = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_r[r] + shfl_xor(l_r[r], 1);
        l += shfl_xor(l, 2);
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        const int row = r ? row_b : row_a;
        if (row >= T) continue;
#pragma unroll
        for (int j = 0; j < NO; ++j)
#pragma unroll
            for (int c = 0; c < 2; ++c) {
                const int d = 8 * j + 2 * t + c;
                if (d < D) ob[row * ost + d] = __float2bfloat16(acc[j][2 * r + c] * inv);
            }
    }
}

template <class C>
static inline int flash_launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B,
                               int H, int T, int D, const long long* st, int causal,
                               float scale, int vec, void* stream) {
    auto kern = flash_fwd<C>;
    int err = tc_allow<C>(kern);
    if (err) return err;
    dim3 grid(B * H, (T + C::BQ - 1) / C::BQ);
    DORA_LAUNCH_SMEM(kern, grid, dim3(C::THREADS), C::SMEM, stream, q, k, v, o, H, T, D,
                     st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
                     st[10], st[11], causal, scale, vec);
    DORA_CHECK(err);
    return err;
}

template <class F>
static inline int flash_by_d16(int d16, F&& f) {
    switch (d16) {
        case 16: return f(FlashCfg<16>{});
        case 32: return f(FlashCfg<32>{});
        case 48: return f(FlashCfg<48>{});
        case 64: return f(FlashCfg<64>{});
        case 80: return f(FlashCfg<80>{});
        case 96: return f(FlashCfg<96>{});
        case 112: return f(FlashCfg<112>{});
        default: return f(FlashCfg<FD>{});
    }
}

static inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// q, k, v [B, H, T, D] bf16 and out [B, H, T, D] bf16, each given by its
// b, h and t strides in elements (D contiguous); 8 <= D <= 128, D % 8 == 0
// (checked by the wrapper). Returns the first cudaError_t of the launch.
extern "C" int dora_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H, int T,
    int D, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, int causal, float scale,
    void* stream) {
    if (D < 8 || D > FD || D % 8) return 1;  // cudaErrorInvalidValue, nothing launched
    const long long st[12] = {qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost};
    // 16-byte copies where every row of q, k and v starts on 16 bytes
    int vec = aligned16(q) && aligned16(k) && aligned16(v);
    for (int i = 0; i < 9; ++i) vec = vec && st[i] % 8 == 0;
    return flash_by_d16((D + 15) / 16 * 16, [&](auto c) {
        return flash_launch<decltype(c)>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                                         (bf16*)out, B, H, T, D, st, causal, scale, vec,
                                         stream);
    });
}
