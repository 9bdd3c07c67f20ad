// Attention sublayers over a KV cache: replace the Pallas kernels of
// dora_tpu/ops/decode_block.py, in two cache layouts.
//
// Paged pools [P, KV, page, hd] through block tables, in their fp-KV and
// int8-KV forms (one template flag, Q8, on the same kernels):
// _attn_paged_batch_kernel / attention_paged_batch_step (decode: one row per
// stream), _attn_paged_chunk_kernel / attention_paged_chunk_step (prefill: M
// rows of one stream) and _attn_paged_spec_kernel / attention_paged_spec_step
// (speculative verify: m candidate rows for each of B streams).
//
// Dense caches, one [KV, S, hd] plane per stream ([B, KV, S, hd], or
// [KV, S, hd] for batch 1), bf16: _attn_batch_kernel / attention_batch_step
// (the dense engine's decode: B rows, row b at positions[b] of plane b),
// _attn_kernel / attention_step (batch-1 decode: one row at `position`) and
// _attn_chunk_kernel / attention_chunk_step (batch-1 speculative verify: M
// rows at position..position+M-1).
//
// Shapes: head_dim 64 or 128 (a template parameter, HD: Qwen2-0.5B's 64,
// the larger Qwen2 models' 128); any page size that is a multiple of the
// 16-row sweep tile (16, 32, ...); any number of query and kv heads with
// whole groups (heads % kv_heads == 0); any number of candidate rows. The
// per-block shared arrays do not grow with these: the per-row kernel walks
// the q, k and v heads one at a time, the decode and prefill sweeps take
// the group's query heads MAXG at a time (grid z), and the verify sweep its
// m x group query rows SQ at a time (grid z), folding its own rows 16 at a
// time.
//
// The two layouts share every kernel below through a row-addressing template
// parameter (PagedRows, DenseRows): where row `pos` of stream sb's kv head g
// lives. A dense plane is not a pool of pages (KV sits between the stream and
// the row), so it is addressed as itself, never through a made-up table.
// Decode runs decode_sweep, batch-1 verify spec_sweep with one stream;
// prefill (paged only) its own sweep.
//
// Per row: RMSNorm -> int8 qkv + bias -> NeoX RoPE (full-width rows
// cos_full = [cos, cos], sin_signed = [-sin, sin]) -> K/V written at the
// row's place in the cache -> online-softmax GQA attention over the prior
// context -> int8 wo -> + residual. In the paged pools page 0 is the null
// page; int8 pools carry f32 scale planes [P, KV, page] beside them.
//
// Bound: at decode width (16 rows) and at spec width (16 streams x 5 rows)
// the wqkv + wo int8 stream (5.5 MB at Qwen2-1.5B) plus each stream's K/V
// rows (4 KB per row per layer in bf16 at 2 kv heads of 128: a 2048-row
// plane is 8 MB per layer, of which a stream reads only its rows < pos; int8
// pages 2 KB + 16 B of scales); at prefill (256 rows) the qkv/wo products
// (2.8 GFLOP). int8 KV halves the context bytes, which matter only at long
// contexts; the kernels do not exploit it yet (each page is dequantized into
// the same f32 shared tiles as bf16 pages).
//
// Design: the TPU kernels run as one sequential grid step carrying their
// scratch; here the sublayer is five launches in stream order: RMSNorm; the
// qkv product (K split over blocks, common.cuh), which reads the weights once
// for all rows, so a spec verify of 80 rows streams them once as decode does;
// a per-row kernel that sums the splits, adds the bias, rotates q and k and
// writes the row's K/V at its place (exactly the new rows: the TPU kernels'
// 8-row read-modify-write is not repeated); the attention sweep, one block
// per (row band or stream, kv head, head or row tile) walking the context 16
// rows at a time; the wo product and its epilogue. The spec sweep puts up to
// SQ of the m x G query rows of a (stream, kv head) in one block, so each
// context tile is read once for them.
//
// Numerics kept from the reference:
// * decode (paged and dense, batch and batch 1) sweeps the PRIOR context
//   (idx < pos) from the cache in bf16 with q rounded to bf16, then folds the
//   current row's K/V from f32 (the TPU kernel's in-register merge), so the
//   current row is never read back rounded to bf16 from the cache;
// * paged prefill attends its own chunk from the bf16 values it wrote (the
//   reference casts the chunk's K/V to the compute dtype too), causally, with
//   the running max starting at -1e30;
// * spec verify (paged, and the dense batch-1 chunk) sweeps the prior context
//   like decode but folds its m rows from bf16-rounded values, as its
//   reference does (unlike decode), with the running max starting at -1e30;
// * probabilities are rounded to bf16 before the P.V product, the softmax
//   sums stay f32;
// * the decode and spec sweeps never read a cache row at or past the
//   stream's position: those rows load as zeros (a dense plane's rows past
//   the written ones may hold anything, NaN included).
//
// int8 KV (decode_block.kv_quant_rows / kv_dequant): each written row is
// quantized per (row, kv head) in registers before the pool write, scale =
// max(amax / 127, 1e-8) and q = clamp(rint(x / scale), -127, 127) with the
// IEEE divide, and the scale lands in the parallel plane under the same page
// id; the sweeps dequantize each page as bf16(q * scale). What the reference
// folds from registers never goes through int8: decode folds its current row
// from f32, prefill and spec verify fold their own chunk rows from the
// bf16-rounded f32 scratch (prefill reads its own pages from the pool in the
// fp form only, where they hold exactly those bf16 values).
#include "common.cuh"

constexpr int TILE = 16;      // context rows per sweep step (divides the page)
constexpr int MAXG = 8;       // query heads of one kv head per decode / prefill block
constexpr int BQ = 4;         // prefill query rows per block
constexpr int NQMAX = BQ * MAXG;
constexpr int CT = 256;       // prefill sweep threads
constexpr int SQ = 64;        // spec verify: candidate rows x group heads per block
constexpr int ST = 256;       // spec verify sweep threads

// Where row `pos` of stream sb's kv head g lives, as a row index of the
// cache's [rows, HD] view. Rows pos .. pos + TILE - 1 from a multiple of
// TILE are consecutive in both layouts (inside one page; a stretch of the
// plane).

// Paged pools [P, KV, page, HD]: page bt[sb * stride + pos / page]. Decode
// and spec verify pass the [B, max_pages] table (stride max_pages), prefill
// its one table row (stride 0).
struct PagedRows {
    const int* bt;
    int stride;
    int page;
    __device__ __forceinline__ size_t row(int sb, int g, int pos, int KV) const {
        return ((size_t)bt[(size_t)sb * stride + pos / page] * KV + g) * page + pos % page;
    }
};

// Dense caches [B, KV, S, HD]: stream sb's own plane (B = 1 for the batch-1
// entries, whose caches are [KV, S, HD]).
struct DenseRows {
    int S;
    __device__ __forceinline__ size_t row(int sb, int g, int pos, int KV) const {
        return ((size_t)sb * KV + g) * S + pos;
    }
};

// Sum the qkv splits, scale, add the bias, rotate q and k, store q (and the
// row's f32 K/V when k_out is given: the decode merge and the spec fold read
// them from there), and write the row's K/V into the cache. Rows come in
// streams of `per_stream` rows: row i belongs to stream sb = i / per_stream
// and sits at position (positions ? positions[sb] : pos0) + i % per_stream,
// written to rows.row(sb, g, pos). Decode passes positions[] and one row per
// stream (batch 1: pos0); paged prefill passes pos0 and all M rows as one
// stream; the spec verify passes positions[] (each stream's chunk start; the
// dense batch-1 chunk: pos0) and m rows per stream, so a stream's m rows may
// straddle a page and each row routes through its own table entry. Exactly
// the new rows are written. The H + 2 KV heads go through one at a time
// (thread d owns dimension d; the rotation reads the partner dimension
// through one head's shared row).
//
// Frozen paged decode and spec streams all sit at position 0 with a zeroed
// table row, so they all write rows 0 .. per_stream - 1 of null page 0 at
// once (in int8 KV their scales too). That race is harmless: no live row
// ever reads page 0. Idle dense rows write row 0 of their own plane.
template <int HD>
static __device__ __forceinline__ float kv_row_scale(float v, float* red) {
    return fmaxf(block_max<HD>(fabsf(v), red) / 127.f, 1e-8f);
}

static __device__ __forceinline__ int8_t kv_quant(float v, float scale) {
    return (int8_t)fminf(fmaxf(rintf(v / scale), -127.f), 127.f);
}

// One pool value of row `row` = (page * KV + kv head) * page + in-page row,
// in the compute dtype's values (bf16, widened to f32).
template <bool Q8, int HD>
static __device__ __forceinline__ float kv_load(const void* __restrict__ pool,
                                                const float* __restrict__ scale,
                                                size_t row, int e) {
    if constexpr (Q8)
        return bf16_round((float)((const int8_t*)pool)[row * HD + e] * scale[row]);
    else
        return __bfloat162float(((const bf16*)pool)[row * HD + e]);
}

template <bool Q8, class Rows, int HD>
static __global__ void __launch_bounds__(HD)
qkv_rope_write(const float* __restrict__ P, int splits, int M,
               const float* __restrict__ s, const float* __restrict__ b,
               const float* __restrict__ cosr, const float* __restrict__ sinr,
               const int* __restrict__ positions, int pos0, int per_stream,
               Rows rows, void* __restrict__ k_pool, void* __restrict__ v_pool,
               float* __restrict__ k_scale, float* __restrict__ v_scale,
               float* __restrict__ q_out, float* __restrict__ k_out,
               float* __restrict__ v_out, int H, int KV) {
    __shared__ float buf[HD];
    __shared__ float red[HD];
    const int i = blockIdx.x, d = threadIdx.x;
    const int nh = H + 2 * KV;
    const size_t N = (size_t)nh * HD;
    const float c = cosr[(size_t)i * HD + d], sn = sinr[(size_t)i * HD + d];
    const int partner = d < HD / 2 ? d + HD / 2 : d - HD / 2;
    const int sb = i / per_stream;
    const int pos = (positions ? positions[sb] : pos0) + i % per_stream;
    for (int h = 0; h < nh; ++h) {  // uniform over the block
        const int col = h * HD + d;
        float acc = 0.f;
        for (int z = 0; z < splits; ++z) acc += P[((size_t)z * M + i) * N + col];
        const float val = acc * s[col] + (b ? b[col] : 0.f);
        buf[d] = val;
        __syncthreads();
        const float rot = val * c + buf[partner] * sn;
        __syncthreads();  // buf is rewritten by the next head
        if (h < H) {
            q_out[((size_t)i * H + h) * HD + d] = rot;
            continue;
        }
        const bool is_k = h < H + KV;
        const int g = is_k ? h - H : h - H - KV;
        const float vv = is_k ? rot : val;  // v is not rotated
        if (k_out) (is_k ? k_out : v_out)[((size_t)i * KV + g) * HD + d] = vv;
        const size_t row = rows.row(sb, g, pos, KV);
        if constexpr (Q8) {
            const float sc = kv_row_scale<HD>(vv, red);
            ((int8_t*)(is_k ? k_pool : v_pool))[row * HD + d] = kv_quant(vv, sc);
            if (d == 0) (is_k ? k_scale : v_scale)[row] = sc;
        } else {
            ((bf16*)(is_k ? k_pool : v_pool))[row * HD + d] = __float2bfloat16(vv);
        }
    }
}

// Decode: one block per (stream b, kv head g, tile of up to MAXG of the
// group's query heads), thread d owns dimension d of the tile's heads.
// Stream b sits at positions[b] (batch 1: pos0) and sweeps its rows 0 ..
// pos - 1, TILE at a time.
template <bool Q8, class Rows, int HD>
static __global__ void __launch_bounds__(HD)
decode_sweep(const float* __restrict__ q_in, const float* __restrict__ k_in,
             const float* __restrict__ v_in, const void* __restrict__ k_pool,
             const void* __restrict__ v_pool, const float* __restrict__ k_scale,
             const float* __restrict__ v_scale, const int* __restrict__ positions,
             int pos0, Rows rows, bf16* __restrict__ attn, int H, int KV, float scale) {
    __shared__ float qs[MAXG][HD];
    __shared__ float ks[TILE][HD + 1];
    __shared__ float vs[TILE][HD];
    __shared__ float sc[MAXG][TILE];
    __shared__ float m_s[MAXG], l_s[MAXG], al_s[MAXG];
    __shared__ float red[HD];
    const int b = blockIdx.x, g = blockIdx.y, d = threadIdx.x;
    const int G = H / KV, h0 = g * G + blockIdx.z * MAXG;
    const int Gt = min(MAXG, G - (int)blockIdx.z * MAXG);  // this block's heads
    const int pos = positions ? positions[b] : pos0;
    float qf[MAXG], acc[MAXG];
#pragma unroll
    for (int h = 0; h < MAXG; ++h) {
        qf[h] = 0.f;
        acc[h] = 0.f;
        if (h < Gt) {
            qf[h] = q_in[((size_t)b * H + h0 + h) * HD + d];
            qs[h][d] = bf16_round(qf[h]);
        }
    }
    if (d < MAXG) {
        m_s[d] = -INFINITY;
        l_s[d] = 0.f;
    }
    __syncthreads();
    const int nblocks = (pos + TILE - 1) / TILE;  // prior context, partial tile included
    for (int blk = 0; blk < nblocks; ++blk) {
        const size_t row0 = rows.row(b, g, blk * TILE, KV);
        for (int j = 0; j < TILE; ++j) {  // rows >= pos are never read
            const bool live = blk * TILE + j < pos;
            ks[j][d] = live ? kv_load<Q8, HD>(k_pool, k_scale, row0 + j, d) : 0.f;
            vs[j][d] = live ? kv_load<Q8, HD>(v_pool, v_scale, row0 + j, d) : 0.f;
        }
        __syncthreads();
        for (int t = d; t < Gt * TILE; t += HD) {
            int h = t / TILE, j = t % TILE;
            float sacc = 0.f;
            for (int e = 0; e < HD; ++e) sacc += qs[h][e] * ks[j][e];
            sc[h][j] = (blk * TILE + j < pos) ? sacc * scale : -INFINITY;
        }
        __syncthreads();
        if (d < Gt) {
            float mo = m_s[d], mx = -INFINITY;
            for (int j = 0; j < TILE; ++j) mx = fmaxf(mx, sc[d][j]);
            float mn = fmaxf(mo, mx);
            float al = expf(mo - mn);
            float sum = 0.f;
            for (int j = 0; j < TILE; ++j) {
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
            if (h < Gt) {
                float pv = 0.f;
                for (int j = 0; j < TILE; ++j) pv += sc[h][j] * vs[j][d];
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
        if (h < Gt) {  // Gt is the same for the whole block
            float snew = block_sum<HD>(qf[h] * kc, red) * scale;
            float mf = m_s[h], lf = l_s[h];
            float m2 = fmaxf(mf, snew);
            float al = expf(mf - m2);
            float w = expf(snew - m2);
            float l2 = lf * al + w;
            attn[((size_t)b * H + h0 + h) * HD + d] =
                __float2bfloat16((acc[h] * al + w * vc) / l2);
        }
    }
}

// Prefill: one block per (BQ query rows, kv head g, tile of up to MAXG of
// the group's query heads) walks the slot's rows up to its last row's
// position, TILE at a time, its own chunk rows included (causal mask key <=
// pos0 + i). The prior rows come from the pool; the chunk's own rows too in
// the fp form, from the f32 scratch rows k_in/v_in rounded to bf16 in the
// int8 form (the pool holds them quantized). pos0 is a multiple of the page,
// hence of TILE, so a tile is either prior context or the chunk's own.
template <bool Q8, int HD>
static __global__ void __launch_bounds__(CT)
paged_chunk_attn(const float* __restrict__ q_in, const float* __restrict__ k_in,
                 const float* __restrict__ v_in, const void* __restrict__ k_pool,
                 const void* __restrict__ v_pool, const float* __restrict__ k_scale,
                 const float* __restrict__ v_scale, int pos0, PagedRows rows,
                 bf16* __restrict__ attn, int M, int H, int KV, float scale) {
    __shared__ bf16 qs[NQMAX][HD];
    __shared__ float ks[TILE][HD + 1];
    __shared__ float vs[TILE][HD];
    __shared__ float sc[NQMAX][TILE];
    __shared__ float m_s[NQMAX], l_s[NQMAX], al_s[NQMAX];
    constexpr int NACC = NQMAX * HD / CT;
    constexpr int QSTEP = CT / HD;
    const int tid = threadIdx.x, g = blockIdx.y, i0 = blockIdx.x * BQ;
    const int G = H / KV, h0 = g * G + blockIdx.z * MAXG;
    const int Gt = min(MAXG, G - (int)blockIdx.z * MAXG), NQ = BQ * Gt;
    for (int idx = tid; idx < NQ * HD; idx += CT) {
        int qv = idx / HD, e = idx % HD;
        int i = i0 + qv / Gt, h = qv % Gt;
        qs[qv][e] = __float2bfloat16(
            i < M ? q_in[((size_t)i * H + h0 + h) * HD + e] : 0.f);
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
    const int ntiles = (pos0 + i_last) / TILE + 1;
    for (int blk = 0; blk < ntiles; ++blk) {
        const size_t row0 = rows.row(0, g, blk * TILE, KV);
        const bool own = Q8 && blk * TILE >= pos0;  // a tile of this chunk
        for (int idx = tid; idx < TILE * HD; idx += CT) {
            int j = idx / HD, e = idx % HD;
            if (own) {
                size_t off = ((size_t)(blk * TILE + j - pos0) * KV + g) * HD + e;
                ks[j][e] = bf16_round(k_in[off]);
                vs[j][e] = bf16_round(v_in[off]);
            } else {
                ks[j][e] = kv_load<Q8, HD>(k_pool, k_scale, row0 + j, e);
                vs[j][e] = kv_load<Q8, HD>(v_pool, v_scale, row0 + j, e);
            }
        }
        __syncthreads();
        for (int t = tid; t < NQ * TILE; t += CT) {
            int qv = t / TILE, j = t % TILE;
            int i = i0 + qv / Gt;
            float sacc = 0.f;
            for (int e = 0; e < HD; ++e) sacc += __bfloat162float(qs[qv][e]) * ks[j][e];
            sc[qv][j] = (blk * TILE + j <= pos0 + i) ? sacc * scale : -INFINITY;
        }
        __syncthreads();
        if (tid < NQ) {
            float mo = m_s[tid], mx = -INFINITY;
            for (int j = 0; j < TILE; ++j) mx = fmaxf(mx, sc[tid][j]);
            float mn = fmaxf(mo, mx);
            float al = expf(mo - mn);
            float sum = 0.f;
            for (int j = 0; j < TILE; ++j) {
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
                for (int j = 0; j < TILE; ++j) pv += sc[qv][j] * vs[j][d];
                acc[u] = acc[u] * al_s[qv] + pv;
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < NACC; ++u) {
        int qv = qv0 + QSTEP * u;
        if (qv < NQ) {
            int i = i0 + qv / Gt, h = qv % Gt;
            if (i < M)
                attn[((size_t)i * H + h0 + h) * HD + d] =
                    __float2bfloat16(acc[u] / l_s[qv]);
        }
    }
}

// Spec verify: one block per (stream b, kv head g, tile z of SQ query
// rows). The stream's m candidate rows times the group's G query heads are
// ordered (candidate i, head h), r = i * G + h, and block z holds rows z*SQ
// .. z*SQ + SQ - 1 of them. It sweeps the PRIOR context, rows 0 .. pos - 1
// in tiles of TILE with key idx < pos live (pos is each stream's chunk
// start, positions[b], or pos0 for the dense batch-1 chunk, and need not be
// a multiple of TILE; the rows this call wrote sit at idx >= pos and are not
// read), then folds the stream's own m rows, TILE at a time, as more
// online-softmax steps, causally (candidate i sees rows j <= i) and from the
// bf16-rounded K/V of the scratch rows, never from the cache: frozen streams
// race on null page 0, and the reference folds bf16 values (its
// k_s.astype(dtype) / k_m.astype(dtype)). Another stream's rows are never
// seen.
template <bool Q8, class Rows, int HD>
static __global__ void __launch_bounds__(ST)
spec_sweep(const float* __restrict__ q_in, const float* __restrict__ k_in,
           const float* __restrict__ v_in, const void* __restrict__ k_pool,
           const void* __restrict__ v_pool, const float* __restrict__ k_scale,
           const float* __restrict__ v_scale, const int* __restrict__ positions,
           int pos0, Rows rows, bf16* __restrict__ attn, int m, int H, int KV,
           float scale) {
    __shared__ bf16 qs[SQ][HD];
    __shared__ float ks[TILE][HD + 1];
    __shared__ float vs[TILE][HD];
    __shared__ float sc[SQ][TILE];
    __shared__ float m_s[SQ], l_s[SQ], al_s[SQ];
    constexpr int NACC = SQ * HD / ST;
    constexpr int QSTEP = ST / HD;
    const int tid = threadIdx.x, b = blockIdx.x, g = blockIdx.y;
    const int G = H / KV, r0 = blockIdx.z * SQ;
    const int NQ = min(SQ, m * G - r0);  // this block's query rows
    const int pos = positions ? positions[b] : pos0;
    for (int idx = tid; idx < NQ * HD; idx += ST) {
        int qv = idx / HD, e = idx % HD;
        int i = (r0 + qv) / G, h = (r0 + qv) % G;
        qs[qv][e] = __float2bfloat16(q_in[(((size_t)b * m + i) * H + g * G + h) * HD + e]);
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
    const int ntiles = (pos + TILE - 1) / TILE;  // prior context
    const int nfold = (m + TILE - 1) / TILE;     // the stream's own rows
    for (int blk = 0; blk < ntiles + nfold; ++blk) {
        const bool fold = blk >= ntiles;
        const int j0 = (blk - ntiles) * TILE;  // first own row of a fold step
        if (!fold) {
            const size_t row0 = rows.row(b, g, blk * TILE, KV);
            for (int idx = tid; idx < TILE * HD; idx += ST) {
                int j = idx / HD, e = idx % HD;
                const bool live = blk * TILE + j < pos;  // rows >= pos are never read
                ks[j][e] = live ? kv_load<Q8, HD>(k_pool, k_scale, row0 + j, e) : 0.f;
                vs[j][e] = live ? kv_load<Q8, HD>(v_pool, v_scale, row0 + j, e) : 0.f;
            }
        } else {
            for (int idx = tid; idx < TILE * HD; idx += ST) {
                int j = idx / HD, e = idx % HD;
                size_t off = (((size_t)b * m + j0 + j) * KV + g) * HD + e;
                ks[j][e] = j0 + j < m ? bf16_round(k_in[off]) : 0.f;
                vs[j][e] = j0 + j < m ? bf16_round(v_in[off]) : 0.f;
            }
        }
        __syncthreads();
        for (int t = tid; t < NQ * TILE; t += ST) {
            int qv = t / TILE, j = t % TILE;
            bool live = fold ? (j0 + j <= (r0 + qv) / G) : (blk * TILE + j < pos);
            float sacc = 0.f;
            for (int e = 0; e < HD; ++e) sacc += __bfloat162float(qs[qv][e]) * ks[j][e];
            sc[qv][j] = live ? sacc * scale : -INFINITY;
        }
        __syncthreads();
        if (tid < NQ) {
            float mo = m_s[tid], mx = -INFINITY;
            for (int j = 0; j < TILE; ++j) mx = fmaxf(mx, sc[tid][j]);
            float mn = fmaxf(mo, mx);
            float al = expf(mo - mn);
            float sum = 0.f;
            for (int j = 0; j < TILE; ++j) {
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
                for (int j = 0; j < TILE; ++j) pv += sc[qv][j] * vs[j][d];
                acc[u] = acc[u] * al_s[qv] + pv;
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < NACC; ++u) {
        int qv = qv0 + QSTEP * u;
        if (qv < NQ) {
            int i = (r0 + qv) / G, h = (r0 + qv) % G;
            attn[(((size_t)b * m + i) * H + g * G + h) * HD + d] =
                __float2bfloat16(acc[u] / l_s[qv]);
        }
    }
}

extern "C" int dora_gemm_splits(int M, int N, int K) {
    return gemm_splits(M, N, K);
}

static inline int group_tiles(int H, int KV) {
    return (H / KV + MAXG - 1) / MAXG;
}

// Shared tail of every entry point: wo product, scale, residual.
static void out_projection(const void* x, const void* wo, const void* swo,
                           void* out, int residual, int M, int D, int H, int hd,
                           void* p, void* attn, void* stream, int& err) {
    launch_gemm((const bf16*)attn, (const int8_t*)wo, (float*)p, M, D, H * hd,
                stream, err);
    launch_epilogue((const float*)p, gemm_splits(M, D, H * hd), M, D,
                    (const float*)swo, nullptr,
                    residual ? (const bf16*)x : nullptr,
                    residual ? (bf16*)out : nullptr,
                    residual ? nullptr : (float*)out, stream, err);
}


// The front of every entry point: RMSNorm, the qkv product, and the per-row
// kernel that rotates q and k and writes the rows' K/V (quantized in the
// int8 form) at their places. Rows come in streams of `per_stream` rows at
// (positions ? positions[sb] : pos0) + i % per_stream (see qkv_rope_write).
template <bool Q8, class Rows, int HD>
static void project_and_write(const void* x, const void* norm_w, const void* wqkv,
                              const void* sqkv, const void* bqkv, const void* cosr,
                              const void* sinr, void* k_pool, void* v_pool,
                              void* k_scale, void* v_scale, const void* positions,
                              int pos0, int per_stream, Rows rows, int M, int D,
                              int H, int KV, float eps, void* h, void* p, void* q,
                              void* kcur, void* vcur, void* stream, int& err) {
    const int N = (H + 2 * KV) * HD;
    DORA_LAUNCH(rmsnorm_rows, dim3(M), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    launch_gemm((const bf16*)h, (const int8_t*)wqkv, (float*)p, M, N, D, stream, err);
    auto kern = qkv_rope_write<Q8, Rows, HD>;
    DORA_LAUNCH(kern, dim3(M), dim3(HD), stream,
                (const float*)p, gemm_splits(M, N, D), M, (const float*)sqkv,
                (const float*)bqkv, (const float*)cosr, (const float*)sinr,
                (const int*)positions, pos0, per_stream, rows,
                k_pool, v_pool, (float*)k_scale, (float*)v_scale, (float*)q,
                (float*)kcur, (float*)vcur, H, KV);
    DORA_CHECK(err);
}

// Decode: B rows, row b of stream b at positions[b] (null: every row at
// pos0, batch 1).
template <bool Q8, class Rows, int HD>
static int decode_step(const void* x, const void* norm_w, const void* wqkv,
                       const void* sqkv, const void* bqkv, const void* cosr,
                       const void* sinr, void* k_pool, void* v_pool, void* k_scale,
                       void* v_scale, const void* wo, const void* swo,
                       const void* positions, int pos0, Rows rows, void* out,
                       int residual, int B, int D, int H, int KV, float eps,
                       float scale, void* h, void* p, void* q, void* kcur, void* vcur,
                       void* attn, void* stream) {
    int err = 0;
    project_and_write<Q8, Rows, HD>(x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool,
                                    v_pool, k_scale, v_scale, positions, pos0, 1, rows,
                                    B, D, H, KV, eps, h, p, q, kcur, vcur, stream, err);
    auto kern = decode_sweep<Q8, Rows, HD>;
    DORA_LAUNCH(kern, dim3(B, KV, group_tiles(H, KV)), dim3(HD), stream,
                (const float*)q, (const float*)kcur, (const float*)vcur,
                (const void*)k_pool, (const void*)v_pool, (const float*)k_scale,
                (const float*)v_scale, (const int*)positions, pos0, rows,
                (bf16*)attn, H, KV, scale);
    DORA_CHECK(err);
    out_projection(x, wo, swo, out, residual, B, D, H, HD, p, attn, stream, err);
    return err;
}

template <bool Q8, int HD>
static int chunk_step(const void* x, const void* norm_w, const void* wqkv,
                      const void* sqkv, const void* bqkv, const void* cosr,
                      const void* sinr, void* k_pool, void* v_pool, void* k_scale,
                      void* v_scale, const void* wo, const void* swo, int position,
                      PagedRows rows, void* out, int residual, int M, int D, int H,
                      int KV, float eps, float scale, void* h, void* p, void* q,
                      void* kcur, void* vcur, void* attn, void* stream) {
    int err = 0;
    project_and_write<Q8, PagedRows, HD>(x, norm_w, wqkv, sqkv, bqkv, cosr, sinr,
                                         k_pool, v_pool, k_scale, v_scale, nullptr,
                                         position, M, rows, M, D, H, KV, eps, h, p, q,
                                         kcur, vcur, stream, err);
    auto kern = paged_chunk_attn<Q8, HD>;
    DORA_LAUNCH(kern, dim3((M + BQ - 1) / BQ, KV, group_tiles(H, KV)), dim3(CT), stream,
                (const float*)q, (const float*)kcur, (const float*)vcur,
                (const void*)k_pool, (const void*)v_pool, (const float*)k_scale,
                (const float*)v_scale, position, rows, (bf16*)attn, M, H, KV, scale);
    DORA_CHECK(err);
    out_projection(x, wo, swo, out, residual, M, D, H, HD, p, attn, stream, err);
    return err;
}

// Spec verify: B streams of m rows, stream b's from positions[b] (null: one
// stream from pos0, the dense batch-1 chunk).
template <bool Q8, class Rows, int HD>
static int spec_step(const void* x, const void* norm_w, const void* wqkv,
                     const void* sqkv, const void* bqkv, const void* cosr,
                     const void* sinr, void* k_pool, void* v_pool, void* k_scale,
                     void* v_scale, const void* wo, const void* swo,
                     const void* positions, int pos0, Rows rows, void* out,
                     int residual, int B, int m, int D, int H, int KV, float eps,
                     float scale, void* h, void* p, void* q, void* kcur, void* vcur,
                     void* attn, void* stream) {
    int err = 0;
    const int M = B * m;
    project_and_write<Q8, Rows, HD>(x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool,
                                    v_pool, k_scale, v_scale, positions, pos0, m, rows,
                                    M, D, H, KV, eps, h, p, q, kcur, vcur, stream, err);
    auto kern = spec_sweep<Q8, Rows, HD>;
    const int row_tiles = (m * (H / KV) + SQ - 1) / SQ;
    DORA_LAUNCH(kern, dim3(B, KV, row_tiles), dim3(ST), stream,
                (const float*)q, (const float*)kcur, (const float*)vcur,
                (const void*)k_pool, (const void*)v_pool, (const float*)k_scale,
                (const float*)v_scale, (const int*)positions, pos0, rows,
                (bf16*)attn, m, H, KV, scale);
    DORA_CHECK(err);
    out_projection(x, wo, swo, out, residual, M, D, H, HD, p, attn, stream, err);
    return err;
}

// The head_dim an entry takes: 64 or 128, each its own instantiation. Any
// other returns cudaErrorInvalidValue (1) before anything launches; the
// wrappers refuse it first.
#define DORA_BY_HEAD_DIM(hd, call)                   \
    do {                                             \
        if ((hd) == 64) { constexpr int HD = 64; return call; }   \
        if ((hd) == 128) { constexpr int HD = 128; return call; } \
        return 1;                                    \
    } while (0)

// Every paged entry takes the pools and, for int8 KV, their f32 scale planes
// k_scale / v_scale [P, KV, page] (null for bf16 pools, which selects the fp
// form). Pools and planes are updated in place. The page is a multiple of 16
// (checked by the wrappers).
//
// x [B, D] bf16; norm_w [D] f32; wqkv int8 [D, (H+2KV)*hd]; sqkv f32;
// bqkv f32 or null; cos/sin [B, hd] f32; pools bf16 or int8 [P, KV, page, hd];
// wo int8 [H*hd, D]; swo [D] f32; positions [B] int32; block_tables
// [B, max_pages] int32. out [B, D] bf16 (residual) or f32.
// Scratch: h bf16 [B, D]; p f32 (max of the two products' splits*M*N);
// q f32 [B, H, hd]; kcur, vcur f32 [B, KV, hd]; attn bf16 [B, H*hd].
extern "C" int dora_attention_paged_batch_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* wo, const void* swo,
    const void* positions, const void* block_tables, void* out, int residual,
    int B, int D, int H, int KV, int hd, int page, int max_pages, float eps,
    float scale, void* h, void* p, void* q, void* kcur, void* vcur, void* attn,
    void* stream) {
    const PagedRows rows{(const int*)block_tables, max_pages, page};
    DORA_BY_HEAD_DIM(hd, (k_scale ? decode_step<true, PagedRows, HD>
                                  : decode_step<false, PagedRows, HD>)(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool, v_pool, k_scale, v_scale,
        wo, swo, positions, 0, rows, out, residual, B, D, H, KV, eps, scale, h, p, q,
        kcur, vcur, attn, stream));
}

// As above for M rows of one stream at positions position..position+M-1
// (position and M multiples of the page); block_table [max_pages] int32 is
// that stream's row. Scratch as above; kcur and vcur [M, KV, hd] are needed
// in the int8 form only (null in fp).
extern "C" int dora_attention_paged_chunk_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* wo, const void* swo,
    int position, const void* block_table, void* out, int residual, int M, int D,
    int H, int KV, int hd, int page, float eps, float scale, void* h, void* p,
    void* q, void* kcur, void* vcur, void* attn, void* stream) {
    const PagedRows rows{(const int*)block_table, 0, page};
    DORA_BY_HEAD_DIM(hd, (k_scale ? chunk_step<true, HD> : chunk_step<false, HD>)(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool, v_pool, k_scale, v_scale,
        wo, swo, position, rows, out, residual, M, D, H, KV, eps, scale, h, p, q,
        kcur, vcur, attn, stream));
}

// Spec verify: B streams of m candidate rows each, x [B*m, D] stream-major;
// stream b's rows sit at positions[b] .. positions[b] + m - 1 and route
// through block_tables row b. The caller keeps positions[b] + m <= max_seq
// (the engine's spec headroom); it is not checked here. Scratch as the
// decode entry, for B*m rows.
extern "C" int dora_attention_paged_spec_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* wo, const void* swo,
    const void* positions, const void* block_tables, void* out, int residual,
    int B, int m, int D, int H, int KV, int hd, int page, int max_pages, float eps,
    float scale, void* h, void* p, void* q, void* kcur, void* vcur, void* attn,
    void* stream) {
    const PagedRows rows{(const int*)block_tables, max_pages, page};
    DORA_BY_HEAD_DIM(hd, (k_scale ? spec_step<true, PagedRows, HD>
                                  : spec_step<false, PagedRows, HD>)(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool, v_pool, k_scale, v_scale,
        wo, swo, positions, 0, rows, out, residual, B, m, D, H, KV, eps, scale, h, p,
        q, kcur, vcur, attn, stream));
}

// Dense decode (attention_batch_step, and attention_step with B = 1): bf16
// caches [B, KV, S, hd], row b written at and attending below positions[b]
// (positions null: the one row at `position`). The caller keeps every
// position in [0, S); it is checked on the host only. Other arguments and
// scratch as the paged decode entry.
extern "C" int dora_attention_dense_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_cache,
    void* v_cache, const void* wo, const void* swo, const void* positions,
    int position, void* out, int residual, int B, int D, int H, int KV, int hd,
    int S, float eps, float scale, void* h, void* p, void* q, void* kcur,
    void* vcur, void* attn, void* stream) {
    DORA_BY_HEAD_DIM(hd, (decode_step<false, DenseRows, HD>(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_cache, v_cache, nullptr, nullptr,
        wo, swo, positions, position, DenseRows{S}, out, residual, B, D, H, KV, eps,
        scale, h, p, q, kcur, vcur, attn, stream)));
}

// Dense batch-1 chunk (attention_chunk_step): M rows at position ..
// position + M - 1 of bf16 caches [KV, S, hd]; position + M <= S (the
// speculation headroom, checked by the wrapper). Scratch as the spec entry
// for M rows.
extern "C" int dora_attention_dense_chunk_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_cache,
    void* v_cache, const void* wo, const void* swo, int position, void* out,
    int residual, int M, int D, int H, int KV, int hd, int S, float eps,
    float scale, void* h, void* p, void* q, void* kcur, void* vcur, void* attn,
    void* stream) {
    DORA_BY_HEAD_DIM(hd, (spec_step<false, DenseRows, HD>(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_cache, v_cache, nullptr, nullptr,
        wo, swo, nullptr, position, DenseRows{S}, out, residual, 1, M, D, H, KV, eps,
        scale, h, p, q, kcur, vcur, attn, stream)));
}
