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
// memory: the tiles are sized for D = 128 in shared memory, a smaller D
// uses the front of each row, and keys past T are masked. Tensors come with
// their strides (elements; D contiguous), so a [B, T, H, D] projection seen
// as [B, H, T, D] is read in place and the output can be written in the
// caller's layout.
//
// Bound: at the ViT's shape (16 heads of 80 over 256 patches, one image)
// the bytes (q, k, v read and out written once: 4 x 16 x 256 x 80 bf16
// values, 2.6 MB, 0.78 us at 3.35 TB/s) bound it before the products (4 x
// 16 x 256^2 x 80 flop, 0.34 GFLOP, 0.34 us at 989 TFLOP/s in bf16); both
// are tiny, so the launch and the per-tile latency dominate.
//
// Design (simple first; wgmma, TMA and warp specialisation come later): one
// block of 128 threads per (q tile of BQ rows, b * h). The q tile is staged
// in shared memory as f32 once; K/V stream through shared memory BK rows at
// a time; each thread takes 4 of the tile's BQ x BK scores (one column j per
// lane, so the K tile's rows are read conflict-free through a D + 1 stride),
// BQ threads run the online softmax of their row, and thread d owns output
// column d of every row of the tile in registers for P.V. Causal runs stop
// at the last K tile that holds a key <= the tile's last row.
#include "common.cuh"

constexpr int FQ = 16;    // query rows per block
constexpr int FK = 32;    // key rows per step
constexpr int FD = 128;   // largest head_dim (shared tiles are sized for it)
constexpr int FT = 128;   // threads per block
constexpr float F_LOWEST = -3.402823466e38f;  // the reference's finfo(f32).min

static __global__ void __launch_bounds__(FT)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ o, int H, int T, int D,
          long long qsb, long long qsh, long long qst, long long ksb, long long ksh,
          long long kst, long long vsb, long long vsh, long long vst, long long osb,
          long long osh, long long ost, int causal, float scale) {
    __shared__ float qs[FQ][FD];
    __shared__ float ks[FK][FD + 1];
    __shared__ float vs[FK][FD];
    __shared__ float sc[FQ][FK + 1];
    __shared__ float m_s[FQ], l_s[FQ], al_s[FQ];
    const int tid = threadIdx.x;
    const int q0 = blockIdx.x * FQ;
    const int bh = blockIdx.y, b = bh / H, h = bh % H;
    const bf16* qb = q + b * qsb + h * qsh;
    const bf16* kb = k + b * ksb + h * ksh;
    const bf16* vb = v + b * vsb + h * vsh;
    for (int idx = tid; idx < FQ * D; idx += FT) {
        int i = idx / D, e = idx % D;
        qs[i][e] = q0 + i < T ? __bfloat162float(qb[(q0 + i) * qst + e]) : 0.f;
    }
    if (tid < FQ) {
        m_s[tid] = F_LOWEST;
        l_s[tid] = 0.f;
    }
    float acc[FQ];
#pragma unroll
    for (int i = 0; i < FQ; ++i) acc[i] = 0.f;
    __syncthreads();
    // Causal: the keys past the tile's last row contribute nothing.
    const int kend = causal ? min(T, q0 + FQ) : T;
    for (int k0 = 0; k0 < kend; k0 += FK) {
        for (int idx = tid; idx < FK * D; idx += FT) {
            int j = idx / D, e = idx % D;
            const bool live = k0 + j < T;
            ks[j][e] = live ? __bfloat162float(kb[(k0 + j) * kst + e]) : 0.f;
            vs[j][e] = live ? __bfloat162float(vb[(k0 + j) * vst + e]) : 0.f;
        }
        __syncthreads();
        for (int t = tid; t < FQ * FK; t += FT) {
            int i = t / FK, j = t % FK;
            float s = 0.f;
            for (int e = 0; e < D; ++e) s += qs[i][e] * ks[j][e];
            const bool valid = k0 + j < T && (!causal || k0 + j <= q0 + i);
            sc[i][j] = valid ? s * scale : F_LOWEST;
        }
        __syncthreads();
        if (tid < FQ) {
            const int i = tid;
            float m_prev = m_s[i], m_cur = F_LOWEST;
            for (int j = 0; j < FK; ++j) m_cur = fmaxf(m_cur, sc[i][j]);
            const float m_new = fmaxf(m_prev, m_cur);
            const float alpha = expf(m_prev - m_new);
            float sum = 0.f;
            for (int j = 0; j < FK; ++j) {
                const bool valid = k0 + j < T && (!causal || k0 + j <= q0 + i);
                const float p = valid ? expf(sc[i][j] - m_new) : 0.f;
                sc[i][j] = p;
                sum += p;
            }
            l_s[i] = l_s[i] * alpha + sum;
            m_s[i] = m_new;
            al_s[i] = alpha;
        }
        __syncthreads();
        if (tid < D) {
#pragma unroll
            for (int i = 0; i < FQ; ++i) {
                float pv = 0.f;
                for (int j = 0; j < FK; ++j) pv += sc[i][j] * vs[j][tid];
                acc[i] = acc[i] * al_s[i] + pv;
            }
        }
        __syncthreads();
    }
    if (tid < D) {
        bf16* ob = o + b * osb + h * osh;
#pragma unroll
        for (int i = 0; i < FQ; ++i) {
            if (q0 + i < T) {
                const float l = l_s[i];
                ob[(q0 + i) * ost + tid] = __float2bfloat16(acc[i] / (l == 0.f ? 1.f : l));
            }
        }
    }
}

// q, k, v [B, H, T, D] bf16 and out [B, H, T, D] bf16, each given by its
// b, h and t strides in elements (D contiguous); 8 <= D <= 128, D % 8 == 0
// (checked by the wrapper). Returns cudaGetLastError() of the launch.
extern "C" int dora_flash_attention(
    const void* q, const void* k, const void* v, void* out, int B, int H, int T,
    int D, long long qsb, long long qsh, long long qst, long long ksb,
    long long ksh, long long kst, long long vsb, long long vsh, long long vst,
    long long osb, long long osh, long long ost, int causal, float scale,
    void* stream) {
    int err = 0;
    if (D < 1 || D > FD) return 1;  // cudaErrorInvalidValue, nothing launched
    dim3 grid((T + FQ - 1) / FQ, B * H);
    DORA_LAUNCH(flash_fwd, grid, dim3(FT), stream,
                (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, H, T, D,
                qsb, qsh, qst, ksb, ksh, kst, vsb, vsh, vst, osb, osh, ost, causal,
                scale);
    DORA_CHECK(err);
    return err;
}
