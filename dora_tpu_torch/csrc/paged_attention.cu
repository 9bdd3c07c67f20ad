// Paged attention sublayers: replace the Pallas kernels
// _attn_paged_batch_kernel / attention_paged_batch_step (decode: one row per
// stream) and _attn_paged_chunk_kernel / attention_paged_chunk_step (prefill:
// M rows of one stream) of dora_tpu/ops/decode_block.py, fp-KV form.
//
// Per row: RMSNorm -> int8 qkv + bias -> NeoX RoPE (full-width rows
// cos_full = [cos, cos], sin_signed = [-sin, sin]) -> K/V written into the
// pool page the block table names -> online-softmax GQA attention over the
// paged context -> int8 wo -> + residual. Pools are [P, KV, page, hd] bf16;
// page 0 is the null page.
//
// Bound: at decode width (16 rows) the wqkv + wo int8 stream (5.5 MB) plus
// each stream's K/V pages (16 KB per page per layer); at prefill (256 rows)
// the qkv/wo products (2.8 GFLOP).
//
// Design: the TPU kernels run as one sequential grid step carrying their
// scratch; here the sublayer is five launches in stream order: RMSNorm; the
// qkv product (K split over blocks, common.cuh); a per-row kernel that sums
// the splits, adds the bias, rotates q and k and writes the row's K/V into its
// page; the attention sweep, one block per (row band, kv head) walking the
// pages through the block table; the wo product and its epilogue.
//
// Numerics kept from the reference:
// * decode sweeps the PRIOR context (idx < pos) from the pool in bf16 with q
//   rounded to bf16, then folds the current row's K/V from f32 (the TPU
//   kernel's in-register merge), so the current row is never read back
//   rounded to bf16 from the pool;
// * prefill attends its own chunk from the bf16 values it wrote (the
//   reference casts the chunk's K/V to the compute dtype too), causally, with
//   the running max starting at -1e30;
// * probabilities are rounded to bf16 before the P.V product, the softmax
//   sums stay f32.
#include "common.cuh"

constexpr int HD = 128;       // head_dim the kernels take
constexpr int PAGE = 16;      // pool page size the kernels take
constexpr int MAXG = 8;       // most query heads per kv head
constexpr int MAXHEADS = 32;  // most q + k + v heads of one row
constexpr int BQ = 4;         // prefill query rows per block
constexpr int NQMAX = BQ * MAXG;
constexpr int CT = 256;       // prefill sweep threads

// Sum the qkv splits, scale, add the bias, rotate q and k, store q (and the
// current row's f32 K/V for the decode merge when k_out is given), and write
// the row's K/V into pool page bt[i * bt_stride + pos / PAGE], row pos % PAGE.
// Decode passes positions[] and the [B, max_pages] table; prefill passes
// pos0 (row i sits at pos0 + i) and its one table row with bt_stride 0.
//
// Frozen decode rows all sit at position 0 with a zeroed table row, so they
// all write row 0 of null page 0 at once. That race is harmless: no live row
// ever reads page 0.
static __global__ void __launch_bounds__(HD)
qkv_rope_write(const float* __restrict__ P, int splits, int M,
               const float* __restrict__ s, const float* __restrict__ b,
               const float* __restrict__ cosr, const float* __restrict__ sinr,
               const int* __restrict__ positions, int pos0,
               const int* __restrict__ bt, int bt_stride,
               bf16* __restrict__ k_pool, bf16* __restrict__ v_pool,
               float* __restrict__ q_out, float* __restrict__ k_out,
               float* __restrict__ v_out, int H, int KV) {
    __shared__ float buf[MAXHEADS][HD];
    const int i = blockIdx.x, d = threadIdx.x;
    const int nh = H + 2 * KV;
    const size_t N = (size_t)nh * HD;
    for (int h = 0; h < nh; ++h) {
        int col = h * HD + d;
        float acc = 0.f;
        for (int z = 0; z < splits; ++z) acc += P[((size_t)z * M + i) * N + col];
        buf[h][d] = acc * s[col] + (b ? b[col] : 0.f);
    }
    __syncthreads();
    const float c = cosr[(size_t)i * HD + d], sn = sinr[(size_t)i * HD + d];
    const int partner = d < HD / 2 ? d + HD / 2 : d - HD / 2;
    const int pos = positions ? positions[i] : pos0 + i;
    const int pg = bt[(size_t)i * bt_stride + pos / PAGE];
    for (int h = 0; h < H; ++h)
        q_out[((size_t)i * H + h) * HD + d] = buf[h][d] * c + buf[h][partner] * sn;
    for (int g = 0; g < KV; ++g) {
        float kr = buf[H + g][d] * c + buf[H + g][partner] * sn;
        float vv = buf[H + KV + g][d];
        if (k_out) {
            k_out[((size_t)i * KV + g) * HD + d] = kr;
            v_out[((size_t)i * KV + g) * HD + d] = vv;
        }
        size_t off = (((size_t)pg * KV + g) * PAGE + pos % PAGE) * HD + d;
        k_pool[off] = __float2bfloat16(kr);
        v_pool[off] = __float2bfloat16(vv);
    }
}

// Decode: one block per (stream b, kv head g), thread d owns dimension d of
// the group's G query heads.
static __global__ void __launch_bounds__(HD)
paged_decode_attn(const float* __restrict__ q_in, const float* __restrict__ k_in,
                  const float* __restrict__ v_in, const bf16* __restrict__ k_pool,
                  const bf16* __restrict__ v_pool, const int* __restrict__ positions,
                  const int* __restrict__ bt, int max_pages, bf16* __restrict__ attn,
                  int H, int KV, float scale) {
    __shared__ float qs[MAXG][HD];
    __shared__ float ks[PAGE][HD + 1];
    __shared__ float vs[PAGE][HD];
    __shared__ float sc[MAXG][PAGE];
    __shared__ float m_s[MAXG], l_s[MAXG], al_s[MAXG];
    __shared__ float red[HD];
    const int b = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
    const int G = H / KV;
    const int pos = positions[b];
    float qf[MAXG], acc[MAXG];
#pragma unroll
    for (int h = 0; h < MAXG; ++h) {
        qf[h] = 0.f;
        acc[h] = 0.f;
        if (h < G) {
            qf[h] = q_in[((size_t)b * H + g * G + h) * HD + d];
            qs[h][d] = bf16_round(qf[h]);
        }
    }
    if (d < MAXG) {
        m_s[d] = -INFINITY;
        l_s[d] = 0.f;
    }
    __syncthreads();
    const int nblocks = (pos + PAGE - 1) / PAGE;  // prior context, partial page included
    for (int blk = 0; blk < nblocks; ++blk) {
        const int pg = bt[(size_t)b * max_pages + blk];
        const bf16* kp = k_pool + ((size_t)pg * KV + g) * PAGE * HD;
        const bf16* vp = v_pool + ((size_t)pg * KV + g) * PAGE * HD;
        for (int j = 0; j < PAGE; ++j) {
            ks[j][d] = __bfloat162float(kp[j * HD + d]);
            vs[j][d] = __bfloat162float(vp[j * HD + d]);
        }
        __syncthreads();
        for (int t = d; t < G * PAGE; t += HD) {
            int h = t / PAGE, j = t % PAGE;
            float sacc = 0.f;
            for (int e = 0; e < HD; ++e) sacc += qs[h][e] * ks[j][e];
            sc[h][j] = (blk * PAGE + j < pos) ? sacc * scale : -INFINITY;
        }
        __syncthreads();
        if (d < G) {
            float mo = m_s[d], mx = -INFINITY;
            for (int j = 0; j < PAGE; ++j) mx = fmaxf(mx, sc[d][j]);
            float mn = fmaxf(mo, mx);
            float al = expf(mo - mn);
            float sum = 0.f;
            for (int j = 0; j < PAGE; ++j) {
                float p = expf(sc[d][j] - mn);
                sum += p;
                sc[d][j] = bf16_round(p);
            }
            l_s[d] = l_s[d] * al + sum;
            m_s[d] = mn;
            al_s[d] = al;
        }
        __syncthreads();
#pragma unroll
        for (int h = 0; h < MAXG; ++h) {
            if (h < G) {
                float pv = 0.f;
                for (int j = 0; j < PAGE; ++j) pv += sc[h][j] * vs[j][d];
                acc[h] = acc[h] * al_s[h] + pv;
            }
        }
        __syncthreads();
    }
    // Fold in the current position from f32 (the exact merge).
    const float kc = k_in[((size_t)b * KV + g) * HD + d];
    const float vc = v_in[((size_t)b * KV + g) * HD + d];
#pragma unroll
    for (int h = 0; h < MAXG; ++h) {
        if (h < G) {  // G is the same for the whole block
            float snew = block_sum<HD>(qf[h] * kc, red) * scale;
            float mf = m_s[h], lf = l_s[h];
            float m2 = fmaxf(mf, snew);
            float al = expf(mf - m2);
            float w = expf(snew - m2);
            float l2 = lf * al + w;
            attn[((size_t)b * H + g * G + h) * HD + d] =
                __float2bfloat16((acc[h] * al + w * vc) / l2);
        }
    }
}

// Prefill: one block per (BQ query rows, kv head g) walks the slot's pages
// up to its last row's position, its own chunk pages included (causal mask
// key <= pos0 + i).
static __global__ void __launch_bounds__(CT)
paged_chunk_attn(const float* __restrict__ q_in, const bf16* __restrict__ k_pool,
                 const bf16* __restrict__ v_pool, int pos0,
                 const int* __restrict__ bt, bf16* __restrict__ attn,
                 int M, int H, int KV, float scale) {
    __shared__ bf16 qs[NQMAX][HD];
    __shared__ float ks[PAGE][HD + 1];
    __shared__ float vs[PAGE][HD];
    __shared__ float sc[NQMAX][PAGE];
    __shared__ float m_s[NQMAX], l_s[NQMAX], al_s[NQMAX];
    constexpr int NACC = NQMAX * HD / CT;
    constexpr int QSTEP = CT / HD;
    const int tid = threadIdx.x, g = blockIdx.y, i0 = blockIdx.x * BQ;
    const int G = H / KV, NQ = BQ * G;
    for (int idx = tid; idx < NQ * HD; idx += CT) {
        int qv = idx / HD, e = idx % HD;
        int i = i0 + qv / G, h = qv % G;
        qs[qv][e] = __float2bfloat16(
            i < M ? q_in[((size_t)i * H + g * G + h) * HD + e] : 0.f);
    }
    if (tid < NQ) {
        m_s[tid] = -1e30f;
        l_s[tid] = 0.f;
    }
    const int d = tid % HD, qv0 = tid / HD;
    float acc[NACC];
#pragma unroll
    for (int u = 0; u < NACC; ++u) acc[u] = 0.f;
    __syncthreads();
    const int i_last = min(i0 + BQ, M) - 1;
    const int npages = (pos0 + i_last) / PAGE + 1;
    for (int blk = 0; blk < npages; ++blk) {
        const int pg = bt[blk];
        const bf16* kp = k_pool + ((size_t)pg * KV + g) * PAGE * HD;
        const bf16* vp = v_pool + ((size_t)pg * KV + g) * PAGE * HD;
        for (int idx = tid; idx < PAGE * HD; idx += CT) {
            int j = idx / HD, e = idx % HD;
            ks[j][e] = __bfloat162float(kp[idx]);
            vs[j][e] = __bfloat162float(vp[idx]);
        }
        __syncthreads();
        for (int t = tid; t < NQ * PAGE; t += CT) {
            int qv = t / PAGE, j = t % PAGE;
            int i = i0 + qv / G;
            float sacc = 0.f;
            for (int e = 0; e < HD; ++e) sacc += __bfloat162float(qs[qv][e]) * ks[j][e];
            sc[qv][j] = (blk * PAGE + j <= pos0 + i) ? sacc * scale : -INFINITY;
        }
        __syncthreads();
        if (tid < NQ) {
            float mo = m_s[tid], mx = -INFINITY;
            for (int j = 0; j < PAGE; ++j) mx = fmaxf(mx, sc[tid][j]);
            float mn = fmaxf(mo, mx);
            float al = expf(mo - mn);
            float sum = 0.f;
            for (int j = 0; j < PAGE; ++j) {
                float p = expf(sc[tid][j] - mn);
                sum += p;
                sc[tid][j] = bf16_round(p);
            }
            l_s[tid] = l_s[tid] * al + sum;
            m_s[tid] = mn;
            al_s[tid] = al;
        }
        __syncthreads();
#pragma unroll
        for (int u = 0; u < NACC; ++u) {
            int qv = qv0 + QSTEP * u;
            if (qv < NQ) {
                float pv = 0.f;
                for (int j = 0; j < PAGE; ++j) pv += sc[qv][j] * vs[j][d];
                acc[u] = acc[u] * al_s[qv] + pv;
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < NACC; ++u) {
        int qv = qv0 + QSTEP * u;
        if (qv < NQ) {
            int i = i0 + qv / G, h = qv % G;
            if (i < M)
                attn[((size_t)i * H + g * G + h) * HD + d] =
                    __float2bfloat16(acc[u] / l_s[qv]);
        }
    }
}

extern "C" int dora_gemm_splits(int M, int N, int K) {
    return gemm_splits(M, N, K);
}

// Shared tail of both entry points: wo product, scale, residual.
static void out_projection(const void* x, const void* wo, const void* swo,
                           void* out, int residual, int M, int D, int H,
                           void* p, void* attn, void* stream, int& err) {
    launch_gemm((const bf16*)attn, (const int8_t*)wo, (float*)p, M, D, H * HD,
                stream, err);
    launch_epilogue((const float*)p, gemm_splits(M, D, H * HD), M, D,
                    (const float*)swo, nullptr,
                    residual ? (const bf16*)x : nullptr,
                    residual ? (bf16*)out : nullptr,
                    residual ? nullptr : (float*)out, stream, err);
}

// x [B, D] bf16; norm_w [D] f32; wqkv int8 [D, (H+2KV)*HD]; sqkv f32;
// bqkv f32 or null; cos/sin [B, HD] f32; pools bf16 [P, KV, PAGE, HD]
// (updated in place); wo int8 [H*HD, D]; swo [D] f32; positions [B] int32;
// block_tables [B, max_pages] int32. out [B, D] bf16 (residual) or f32.
// Scratch: h bf16 [B, D]; p f32 (max of the two products' splits*M*N);
// q f32 [B, H, HD]; kcur, vcur f32 [B, KV, HD]; attn bf16 [B, H*HD].
extern "C" int dora_attention_paged_batch_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, const void* wo, const void* swo, const void* positions,
    const void* block_tables, void* out, int residual, int B, int D, int H,
    int KV, int max_pages, float eps, float scale, void* h, void* p, void* q,
    void* kcur, void* vcur, void* attn, void* stream) {
    int err = 0;
    const int N = (H + 2 * KV) * HD;
    DORA_LAUNCH(rmsnorm_rows, dim3(B), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    launch_gemm((const bf16*)h, (const int8_t*)wqkv, (float*)p, B, N, D, stream, err);
    DORA_LAUNCH(qkv_rope_write, dim3(B), dim3(HD), stream,
                (const float*)p, gemm_splits(B, N, D), B, (const float*)sqkv,
                (const float*)bqkv, (const float*)cosr, (const float*)sinr,
                (const int*)positions, 0, (const int*)block_tables, max_pages,
                (bf16*)k_pool, (bf16*)v_pool, (float*)q, (float*)kcur,
                (float*)vcur, H, KV);
    DORA_CHECK(err);
    DORA_LAUNCH(paged_decode_attn, dim3(B, KV), dim3(HD), stream,
                (const float*)q, (const float*)kcur, (const float*)vcur,
                (const bf16*)k_pool, (const bf16*)v_pool, (const int*)positions,
                (const int*)block_tables, max_pages, (bf16*)attn, H, KV, scale);
    DORA_CHECK(err);
    out_projection(x, wo, swo, out, residual, B, D, H, p, attn, stream, err);
    return err;
}

// As above for M rows of one stream at positions position..position+M-1;
// block_table [max_pages] int32 is that stream's row. Scratch as above
// without kcur/vcur.
extern "C" int dora_attention_paged_chunk_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, const void* wo, const void* swo, int position,
    const void* block_table, void* out, int residual, int M, int D, int H,
    int KV, float eps, float scale, void* h, void* p, void* q, void* attn,
    void* stream) {
    int err = 0;
    const int N = (H + 2 * KV) * HD;
    DORA_LAUNCH(rmsnorm_rows, dim3(M), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    launch_gemm((const bf16*)h, (const int8_t*)wqkv, (float*)p, M, N, D, stream, err);
    DORA_LAUNCH(qkv_rope_write, dim3(M), dim3(HD), stream,
                (const float*)p, gemm_splits(M, N, D), M, (const float*)sqkv,
                (const float*)bqkv, (const float*)cosr, (const float*)sinr,
                (const int*)nullptr, position, (const int*)block_table, 0,
                (bf16*)k_pool, (bf16*)v_pool, (float*)q, (float*)nullptr,
                (float*)nullptr, H, KV);
    DORA_CHECK(err);
    DORA_LAUNCH(paged_chunk_attn, dim3((M + BQ - 1) / BQ, KV), dim3(CT), stream,
                (const float*)q, (const bf16*)k_pool, (const bf16*)v_pool,
                position, (const int*)block_table, (bf16*)attn, M, H, KV, scale);
    DORA_CHECK(err);
    out_projection(x, wo, swo, out, residual, M, D, H, p, attn, stream, err);
    return err;
}
