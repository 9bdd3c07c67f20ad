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
// the larger Qwen2 models' 128); any page size that is a multiple of 16
// (16, 32, ...); any number of query and kv heads with
// whole groups (heads % kv_heads == 0); any number of candidate rows. The
// per-block shared arrays do not grow with these: the per-row kernel walks
// the q, k and v heads one at a time, and the tensor-core sweep takes 16
// packed query rows a warp, up to MAXW warps a block (grid z).
//
// The two layouts share every kernel below through a row-addressing template
// parameter (PagedRows, DenseRows): where row `pos` of stream sb's kv head g
// lives. A dense plane is not a pool of pages (KV sits between the stream and
// the row), so it is addressed as itself, never through a made-up table.
// Every kernel runs one sweep: the tensor-core sweep tc_sweep over keys
// split across the card, then sweep_combine. The paged prefill (kernel 4)
// and the dense batch-1 verify (kernel 10) take one stream each; the paged
// spec verify (kernel 5), the paged batch decode (kernel 3), the dense batch
// decode (kernel 8) and the dense batch-1 decode (kernel 9) take B streams
// in one launch, each block reading its stream's position on the device.
// The three decode kernels share decode_step and run the same arithmetic for
// a row in either layout, so the dense engine and batch-1 decode keep
// agreeing token for token, and the paged decode rounds where its plain
// version does.
//
// Per row: RMSNorm -> int8 qkv + bias -> NeoX RoPE (full-width rows
// cos_full = [cos, cos], sin_signed = [-sin, sin]) -> K/V written at the
// row's place in the cache -> online-softmax GQA attention over the prior
// context -> int8 wo -> + residual. In the paged pools page 0 is the null
// page; int8 pools carry f32 scale planes [P, KV, page] beside them.
//
// int4 weights (the TPU kernels' branch on wqkv.dtype == uint8): wqkv and wo
// packed as dora_tpu/ops/int4.py packs them, with group scales, 2.75 MB at
// Qwen2-1.5B against int8's 5.5. Their products run the int4 form of the
// tensor-core product of kernels 1 and 2 (tc_gemm, common.cuh) into the same
// partials, split as it splits them (dora_gemm_splits with the group), and
// the per-row kernel and the epilogue take no per-column scale: the sums
// come scaled. The int8 products stay on the SIMT launch_gemm.
//
// Bound: at decode width (16 rows) and at spec width (16 streams x 5 rows)
// the wqkv + wo int8 stream (5.5 MB at Qwen2-1.5B) plus each stream's K/V
// rows (4 KB per row per layer in bf16 at 2 kv heads of 128: a 2048-row
// plane is 8 MB per layer, of which a stream reads only its rows < pos; int8
// pages 2 KB + 16 B of scales); at prefill (256 rows) the qkv/wo products
// (2.8 GFLOP). int8 KV halves the context bytes, which matter only at long
// contexts; the kernels do not exploit it yet (each page is dequantized into
// the same shared tiles as bf16 pages).
//
// Design: the TPU kernels run as one sequential grid step carrying their
// scratch; here the sublayer is five launches in stream order: RMSNorm; the
// qkv product (K split over blocks, common.cuh), which reads the weights once
// for all rows, so a spec verify of 80 rows streams them once as decode does;
// a per-row kernel that sums the splits, adds the bias, rotates q and k and
// writes the row's K/V at its place (exactly the new rows: the TPU kernels'
// 8-row read-modify-write is not repeated); the attention sweep; the wo
// product and its epilogue. The tensor-core sweep (tc_sweep, below) runs
// one block per (key split, kv head, stream and tile of its packed query
// rows), in two passes (the rows' maxima, then the sums), and an eighth
// launch sums the splits (and, for a decode, folds each row's own key).
//
// Numerics kept from the reference:
// * decode (paged and dense, batch and batch 1) sweeps the PRIOR context
//   (idx < pos) from the cache in bf16 with q rounded to bf16, then folds the
//   current row's K/V from f32 (the TPU kernel's in-register merge), so the
//   current row is never read back rounded to bf16 from the cache;
// * paged prefill attends its own chunk from the bf16 values it wrote (the
//   reference casts the chunk's K/V to the compute dtype too), causally;
// * spec verify (paged, and the dense batch-1 chunk) sweeps the prior context
//   like decode but folds its m rows from bf16-rounded values, as its
//   reference does (unlike decode);
// * probabilities are rounded to bf16 before the P.V product, the softmax
//   sums stay f32. Every sweep rounds them against each row's final maximum
//   over all its keys (from -1e30; a decode row's over its prior context, as
//   _decode_attend takes it), taken by a first pass before any probability
//   is rounded, as the plain versions round;
// * no sweep reads a cache row at or past the stream's position: those rows
//   load as zeros (a dense plane's rows past the written ones may hold
//   anything, NaN included).
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

// Where row `pos` of stream sb's kv head g lives, as a row index of the
// cache's [rows, HD] view.

// Paged pools [P, KV, page, HD]: page bt[sb * stride + pos / page]. Decode
// and spec verify pass the [B, max_pages] table (stride max_pages), prefill
// its one table row (stride 0, so any sb reads it).
struct PagedRows {
    static constexpr bool indirect = true;  // a row costs a block-table read
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
    static constexpr bool indirect = false;
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
// stream (batch 1: pos0); the prefill and the dense batch-1 verify pass pos0
// and all M rows as one stream; the paged verify passes positions[] (each
// stream's chunk start) and m rows per stream, so a stream's m rows may
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

// Eight f32 values as bf16 in one 16-byte word (the tensor-core sweep's
// own chunk rows), and eight int8 values times their row's scale as
// bf16(q * scale), as decode_block.kv_dequant dequantizes.
static __device__ __forceinline__ uint4 bf16x8(const float* __restrict__ f) {
    const float4 a = *(const float4*)f, b = *(const float4*)(f + 4);
    uint4 r;
    r.x = pack_bf16(a.x, a.y);
    r.y = pack_bf16(a.z, a.w);
    r.z = pack_bf16(b.x, b.y);
    r.w = pack_bf16(b.z, b.w);
    return r;
}

static __device__ __forceinline__ uint4 widen8(const int8_t* q, float sc) {
    uint4 r;
    r.x = pack_bf16((float)q[0] * sc, (float)q[1] * sc);
    r.y = pack_bf16((float)q[2] * sc, (float)q[3] * sc);
    r.z = pack_bf16((float)q[4] * sc, (float)q[5] * sc);
    r.w = pack_bf16((float)q[6] * sc, (float)q[7] * sc);
    return r;
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
        const float val = col_scale(s, col, acc) + (b ? b[col] : 0.f);
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

// ---------------------------------------------------------------------------
// The tensor-core sweep of kernels 3-5 and 8-10: the query rows of B
// streams against each stream's stretch of context
// ---------------------------------------------------------------------------
//
// A stream's query rows for kv head g are (row i, group head h) pairs packed
// as r = i * G + h (NQ = m x G of them for m rows a stream); over all B
// streams they are R = sb * NQ + r, and since NQ = m x G, R / G = sb * m + i
// is the row's index in q_in and attn. A block of nw warps holds 16 nw rows
// of ONE stream (grid z = B x row tiles: stream sb = z / row_tiles), a warp
// 16: its A fragments of q (rounded to bf16) stay in registers for the whole
// sweep. The block walks key tiles of KT keys [t0, t1) (grid x: one split of
// its stream's keys) through shared memory, double-buffered: tile t + 1 is
// copied with cp.async while the warps compute on tile t. Per tile and warp,
// S = q K^T and O += P V run on mma.sync m16n8k16 (bf16 in, f32
// accumulators); each lane holds two query rows (g, g + 8) of the warp's 16.
//
// Positions stay on the device: each block reads its stream's position and
// derives what it sees (below) and its split's tiles. The host fixes the
// number of splits from B, KV, the row tiles and the widest context a stream
// can have (max_pages x page, or S); a block cuts its own stream's key tiles
// into that many near-even ranges, so a short stream leaves its last splits
// empty (maximum -1e30, l 0, O 0) and the grid never depends on positions.
//
// Two passes over the same grid. The first (MAXPASS) computes S only and
// writes each split's row maxima, reduced over the 4 lanes of a quad with
// shuffles; the second takes every row's maximum over all splits, M (from
// -1e30: a row that sees no key keeps it), and accumulates p = exp(s - M)
// into l (f32, unrounded) and p rounded to bf16 into O += P V, writing its
// split's (l, O) [splits, KV, B x NQ(, HD)]; sweep_combine sums the splits
// in index order and writes bf16(O / l). Every p is rounded against the
// row's final maximum, where the plain versions (_verify_attend,
// _decode_attend) round it: the online form (a running maximum, rescaled)
// rounds each tile's p against a different maximum, whose bf16 errors are
// as large as the plain version's but independent of them. Scores are f32 x
// scale, q and K/V bf16.
//
// Row i of stream sb at pos sees keys < pos + inc + i (SweepRows): the
// causal chunk (inc 1) of the prefill, the dense verify and the paged spec
// verify, over the prior context and the chunk's own rows; or a decode row's
// prior context alone (inc 0, one row a stream), whose own key the combine
// folds from f32 (FOLD). A warp skips a tile all of whose keys its rows
// cannot see, and a block the tiles past its last row's limit. Keys at or
// past the block's limit are never read: cp.async zero-fills them (src-size
// 0), so a dense plane's NaN rows past the position never reach P V (NaN x 0
// is NaN). With `own`, keys >= pos (the verify chunks' own rows, and the
// prefill's in the int8 form) come from the f32 scratch k_in / v_in rounded
// to bf16, never from the cache: frozen spec streams race on null page 0,
// and the references fold bf16 of their f32 rows; the fp prefill reads its
// own rows from the pool, which holds exactly those bf16 values. Context
// rows are gathered row by row through the stream's table (a page of one kv
// head is page x HD contiguous values), so a stream's rows may straddle
// pages. The int8 form copies int8 rows and their scales into a staging
// buffer and widens them in shared memory to bf16(q * scale), as
// decode_block.kv_dequant does.
//
// Why mma.sync and not wgmma + TMA: the dense verify does ~30 query rows of
// work per K/V row read (~60 FLOP a byte, far under the card's ~295), the
// spec verify 30 per stream and decode 6, so they are bound by bytes and
// latency, which the split keys and the double-buffered copies address; the
// prefill's sweep is ~1 GFLOP at 256 rows, a few microseconds on mma.sync.
// None needs the 64-row warpgroup tiles.
constexpr int KT = 32;    // keys per tile
constexpr int KPAD = 8;   // bf16 padding of a shared K/V row: rows 272 B apart hit other banks
constexpr int MAXW = 8;   // warps per sweep block (16 query rows each)
constexpr int SMS = 132;  // the H100's SMs: sweep grids aim at two blocks an SM

template <bool Q8, int HD>
struct SweepSmem {
    static constexpr int LD = HD + KPAD;
    static constexpr size_t TILE_BF = (size_t)KT * LD;  // bf16 values of one tile
    static constexpr size_t bytes = 4 * TILE_BF * sizeof(bf16) +
                                    (Q8 ? 4 * (size_t)KT * HD + 4 * KT * sizeof(float) : 0);
    bf16* kb;     // [2][KT][LD]
    bf16* vb;     // [2][KT][LD]
    int8_t* k8;   // [2][KT][HD], int8 form only
    int8_t* v8;
    float* ks;    // [2][KT]
    float* vs;
    __device__ explicit SweepSmem(unsigned char* p)
        : kb((bf16*)p), vb((bf16*)p + 2 * TILE_BF),
          k8((int8_t*)(p + 4 * TILE_BF * sizeof(bf16))),
          v8(k8 + 2 * KT * HD),
          ks((float*)(v8 + 2 * KT * HD)),
          vs(ks + 2 * KT) {}
};

// The query rows of a sweep: m rows a stream, stream sb's first at
// positions[sb] (null: every stream at pos0, batch 1), read on the device.
// Row i sees keys < pos + inc + i; with own, keys >= pos come from the f32
// scratch rows [B * m, KV, HD]. Grid z holds row_tiles tiles a stream.
struct SweepRows {
    const int* positions;
    int pos0, m, inc, own, row_tiles;
    __device__ __forceinline__ int pos(int sb) const { return positions ? positions[sb] : pos0; }
};

// part: the row maxima [splits, KV, B x NQ] (written by the first pass,
// read by the second and by a FOLD combine), then l [splits, KV, B x NQ]
// and O [splits, KV, B x NQ, HD].
template <bool Q8, bool MAXPASS, class Rows, int HD>
static __global__ void __launch_bounds__(MAXW * 32)
tc_sweep(const float* __restrict__ q_in, const float* __restrict__ k_in,
         const float* __restrict__ v_in, const void* __restrict__ k_pool,
         const void* __restrict__ v_pool, const float* __restrict__ k_scale,
         const float* __restrict__ v_scale, Rows rows, SweepRows sr, int H, int KV,
         float scale, float* __restrict__ part) {
    DORA_DYNAMIC_SMEM(smem_raw);
    using Sm = SweepSmem<Q8, HD>;
    constexpr int LD = Sm::LD, CH = HD / 8;  // 16-byte chunks of a bf16 row
    const Sm sm(smem_raw);
    const int tid = threadIdx.x, nthreads = blockDim.x;
    const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
    const int g = blockIdx.y, G = H / KV, NQ = sr.m * G;
    const int sb = blockIdx.z / sr.row_tiles;  // this block's stream
    const int r0 = (blockIdx.z % sr.row_tiles) * nthreads / 2;  // 16 rows a warp
    const int pos = sr.pos(sb);
    const int lim0 = pos + sr.inc;             // row r sees keys < lim0 + r / G
    const int own0 = sr.own ? pos : INT_MAX;
    const int rw = r0 + warp * 16;             // this warp's first row
    const int rlast = min(r0 + nthreads / 2, NQ) - 1;
    const int maxlim = lim0 + rlast / G;       // keys this block may read
    const bool wactive = rw < NQ;
    const int wlim = wactive ? lim0 + min(rw + 15, NQ - 1) / G : 0;
    const int S = gridDim.x;
    const size_t NQT = (size_t)(gridDim.z / sr.row_tiles) * NQ;  // rows of all streams
    const size_t n_ml = (size_t)S * KV * NQT, R0 = (size_t)sb * NQ;

    // this lane's two query rows and what each may see
    const int ra = rw + gq, rb = rw + gq + 8;
    const int lima = ra < NQ ? lim0 + ra / G : 0;
    const int limb = rb < NQ ? lim0 + rb / G : 0;
    auto qrow = [&](int r) -> const float* {
        const size_t R = R0 + r;
        return r < NQ ? q_in + ((R / G) * H + g * G + R % G) * HD : nullptr;
    };
    const float* qa_row = qrow(ra);
    const float* qb_row = qrow(rb);
    uint32_t qa[HD / 16][4];
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
        const int c = k * 16 + 2 * t4;
        qa[k][0] = qa_row ? pack_bf16(qa_row[c], qa_row[c + 1]) : 0u;
        qa[k][1] = qb_row ? pack_bf16(qb_row[c], qb_row[c + 1]) : 0u;
        qa[k][2] = qa_row ? pack_bf16(qa_row[c + 8], qa_row[c + 9]) : 0u;
        qa[k][3] = qb_row ? pack_bf16(qb_row[c + 8], qb_row[c + 9]) : 0u;
    }
    // the rows' maxima: this split's (first pass) or over every split's
    float ma = -1e30f, mb = -1e30f;
    if constexpr (!MAXPASS) {
        for (int z = 0; z < S; ++z) {
            const size_t zb = ((size_t)z * KV + g) * NQT + R0;
            if (ra < NQ) ma = fmaxf(ma, part[zb + ra]);
            if (rb < NQ) mb = fmaxf(mb, part[zb + rb]);
        }
    }
    float o[MAXPASS ? 1 : HD / 8][4];
#pragma unroll
    for (int j = 0; j < (MAXPASS ? 1 : HD / 8); ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    float la = 0.f, lb = 0.f;

    // this split's tiles: the stream's key tiles (up to its last row's
    // limit) in S near-even ranges, cut at the block's own last limit
    const int ntiles = (lim0 + sr.m - 1 + KT - 1) / KT;
    const int per = (ntiles + S - 1) / S;
    const int t0 = blockIdx.x * per;
    const int t1 = min(min(ntiles, t0 + per), (maxlim + KT - 1) / KT);

    // Issue the copies of tile t into buffer `slot` (K only in the first pass).
    // Through a block table the tile's cache rows are resolved first, one key
    // a thread, so no copy waits on a table read (cp.async orders the reads
    // around it); a dense plane's rows are arithmetic.
    __shared__ size_t krow[Rows::indirect ? 2 : 1][KT];
    auto cache_row = [&](int slot, int j, int key) -> size_t {
        if constexpr (Rows::indirect) return krow[slot][j];
        return key < maxlim && key < own0 ? rows.row(sb, g, key, KV) : 0;
    };
    auto load = [&](int t, int slot) {
        const int key0 = t * KT;
        bf16* kd = sm.kb + slot * Sm::TILE_BF;
        bf16* vd = sm.vb + slot * Sm::TILE_BF;
        if constexpr (Rows::indirect) {
            for (int j = tid; j < KT; j += nthreads) {
                const int key = key0 + j;
                krow[slot][j] = key < maxlim && key < own0 ? rows.row(sb, g, key, KV) : 0;
            }
            __syncthreads();  // load is called uniformly over the block
        }
        for (int idx = tid; idx < KT * CH; idx += nthreads) {
            const int j = idx / CH, c = idx % CH, key = key0 + j;
            const bool live = key < maxlim;
            if (live && key >= own0) {  // the chunk's own row, from f32
                const size_t off = ((size_t)(sb * sr.m + key - pos) * KV + g) * HD + c * 8;
                *(uint4*)(kd + j * LD + c * 8) = bf16x8(k_in + off);
                if (!MAXPASS) *(uint4*)(vd + j * LD + c * 8) = bf16x8(v_in + off);
            } else if (Q8) {
                if (c < HD / 16) {  // 16 int8 values a chunk
                    const size_t row = cache_row(slot, j, key);
                    const size_t so = (size_t)(slot * KT + j) * HD + c * 16;
                    cp_async16(sm.k8 + so, (const int8_t*)k_pool + row * HD + c * 16, live);
                    if (!MAXPASS)
                        cp_async16(sm.v8 + so, (const int8_t*)v_pool + row * HD + c * 16, live);
                }
            } else {
                const size_t row = cache_row(slot, j, key);
                cp_async16(kd + j * LD + c * 8, (const bf16*)k_pool + row * HD + c * 8, live);
                if (!MAXPASS)
                    cp_async16(vd + j * LD + c * 8, (const bf16*)v_pool + row * HD + c * 8, live);
            }
        }
        if constexpr (Q8) {
            for (int j = tid; j < KT; j += nthreads) {
                const int key = key0 + j;
                const bool live = key < maxlim && key < own0;
                const size_t row = cache_row(slot, j, key);
                sm.ks[slot * KT + j] = live ? k_scale[row] : 0.f;
                if (!MAXPASS) sm.vs[slot * KT + j] = live ? v_scale[row] : 0.f;
            }
        }
    };

    if (t0 < t1) load(t0, 0);
    cp_async_commit();
    for (int t = t0; t < t1; ++t) {
        const int slot = (t - t0) & 1, key0 = t * KT;
        if (t + 1 < t1) load(t + 1, slot ^ 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const bf16* kt = sm.kb + slot * Sm::TILE_BF;
        const bf16* vt = sm.vb + slot * Sm::TILE_BF;
        if constexpr (Q8) {  // widen the int8 rows, 8 values a step: bf16(q * scale)
            bf16* kd = sm.kb + slot * Sm::TILE_BF;
            bf16* vd = sm.vb + slot * Sm::TILE_BF;
            for (int idx = tid; idx < KT * CH; idx += nthreads) {
                const int j = idx / CH, c = idx % CH, key = key0 + j;
                if (key >= own0 && key < maxlim) continue;  // own rows are bf16 already
                const size_t so = (size_t)(slot * KT + j) * HD + c * 8;
                *(uint4*)(kd + j * LD + c * 8) = widen8(sm.k8 + so, sm.ks[slot * KT + j]);
                if (!MAXPASS)
                    *(uint4*)(vd + j * LD + c * 8) = widen8(sm.v8 + so, sm.vs[slot * KT + j]);
            }
            __syncthreads();
        }
        if (wactive && key0 < wlim) {  // uniform over the warp
            float s[KT / 8][4];
#pragma unroll
            for (int n = 0; n < KT / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
            for (int k = 0; k < HD / 16; ++k) {
#pragma unroll
                for (int n = 0; n < KT / 8; ++n) {
                    const bf16* kr = kt + (n * 8 + gq) * LD + k * 16 + 2 * t4;
                    const uint32_t b[2] = {*(const uint32_t*)kr, *(const uint32_t*)(kr + 8)};
                    mma_bf16_16816(s[n], qa[k], b);
                }
            }
#pragma unroll
            for (int n = 0; n < KT / 8; ++n) {
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const int key = key0 + n * 8 + 2 * t4 + (c & 1);
                    const bool see = key < (c < 2 ? lima : limb);
                    s[n][c] = see ? s[n][c] * scale : -INFINITY;
                }
            }
            if constexpr (MAXPASS) {
#pragma unroll
                for (int n = 0; n < KT / 8; ++n) {
                    ma = fmaxf(ma, fmaxf(s[n][0], s[n][1]));
                    mb = fmaxf(mb, fmaxf(s[n][2], s[n][3]));
                }
            } else {
                uint32_t pa[KT / 16][4];
#pragma unroll
                for (int n = 0; n < KT / 8; ++n) {
                    const float p0 = expf(s[n][0] - ma), p1 = expf(s[n][1] - ma);
                    const float p2 = expf(s[n][2] - mb), p3 = expf(s[n][3] - mb);
                    la += p0 + p1;
                    lb += p2 + p3;
                    pa[n / 2][(n & 1) * 2] = pack_bf16(p0, p1);      // row g
                    pa[n / 2][(n & 1) * 2 + 1] = pack_bf16(p2, p3);  // row g + 8
                }
#pragma unroll
                for (int kk = 0; kk < KT / 16; ++kk) {
                    const bf16* v0 = vt + (kk * 16 + 2 * t4) * LD + gq;
#pragma unroll
                    for (int j = 0; j < HD / 8; ++j) {
                        const bf16* vr = v0 + j * 8;
                        const uint32_t b[2] = {pack_bf16(vr[0], vr[LD]),
                                               pack_bf16(vr[8 * LD], vr[9 * LD])};
                        mma_bf16_16816(o[j], pa[kk], b);
                    }
                }
            }
        }
        __syncthreads();  // the next iteration's copies overwrite this buffer
    }

    if (!wactive) return;  // no barrier below
    for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        float v = half ? (MAXPASS ? mb : lb) : (MAXPASS ? ma : la);
        v = MAXPASS ? fmaxf(v, shfl_xor(v, 1)) : v + shfl_xor(v, 1);
        v = MAXPASS ? fmaxf(v, shfl_xor(v, 2)) : v + shfl_xor(v, 2);
        if (r >= NQ) continue;
        const size_t base = ((size_t)blockIdx.x * KV + g) * NQT + R0 + r;
        if (t4 == 0) part[(MAXPASS ? 0 : n_ml) + base] = v;
        if constexpr (!MAXPASS) {
            float* acc = part + 2 * n_ml + base * HD + 2 * t4;
#pragma unroll
            for (int j = 0; j < HD / 8; ++j)
                *(float2*)(acc + j * 8) = make_float2(o[j][2 * half], o[j][2 * half + 1]);
        }
    }
}

// The sweep's last launch: one warp per (rows_per_block packed rows R of
// all streams, kv head g), each lane V = HD / 32 neighbouring dimensions.
// Sums the second pass's splits of l and O in index order 0 .. splits - 1
// (the result does not depend on scheduling) and writes bf16(O / l) for
// query head g * G + R % G of row R / G. FOLD (decode, one row a stream)
// first folds each row's own key in from f32, the exact merge of the
// decode reference: s = q . k x scale of the f32 scratch rows, against the
// row's maximum over every split's (the first pass's, -1e30 for a row with
// no context, which then yields v).
template <int HD, bool FOLD>
static __global__ void __launch_bounds__(32)
sweep_combine(const float* __restrict__ part, int splits, int rows_per_block,
              bf16* __restrict__ attn, int NQT, int H, int KV,
              const float* __restrict__ q_in, const float* __restrict__ k_in,
              const float* __restrict__ v_in, float scale) {
    constexpr int V = HD / 32;
    const int g = blockIdx.y, G = H / KV, d0 = threadIdx.x * V;
    const size_t n_ml = (size_t)splits * KV * NQT;
    const int r1 = min(NQT, (int)(blockIdx.x + 1) * rows_per_block);
    for (int r = blockIdx.x * rows_per_block; r < r1; ++r) {  // uniform over the warp
        float l = 0.f, mx = -1e30f, acc[V];
#pragma unroll
        for (int e = 0; e < V; ++e) acc[e] = 0.f;
        for (int z = 0; z < splits; ++z) {
            const size_t base = ((size_t)z * KV + g) * NQT + r;
            const float* a = part + 2 * n_ml + base * HD + d0;
            l += part[n_ml + base];
            if (FOLD) mx = fmaxf(mx, part[base]);
#pragma unroll
            for (int e = 0; e < V; ++e) acc[e] += a[e];
        }
        const size_t row = (size_t)(r / G) * H + g * G + r % G;
        bf16* out = attn + row * HD + d0;
        if constexpr (FOLD) {
            const size_t kvr = ((size_t)(r / G) * KV + g) * HD + d0;
            float s = 0.f;
#pragma unroll
            for (int e = 0; e < V; ++e) s += q_in[row * HD + d0 + e] * k_in[kvr + e];
            for (int mask = 16; mask; mask >>= 1) s += shfl_xor(s, mask);
            s *= scale;
            const float m2 = fmaxf(mx, s), al = expf(mx - m2), w = expf(s - m2);
#pragma unroll
            for (int e = 0; e < V; ++e)
                out[e] = __float2bfloat16((acc[e] * al + w * v_in[kvr + e]) / (l * al + w));
        } else {
#pragma unroll
            for (int e = 0; e < V; ++e) out[e] = __float2bfloat16(acc[e] / l);
        }
    }
}

// A sweep's launch shape for B streams of NQ packed query rows per kv head
// over at most `ctx` keys each: warps per block (16 rows each, at most
// `maxw`), row tiles a stream (grid z: B x row tiles), and key splits (grid
// x): about 264 / (B x KV x row tiles) of them (two blocks an SM), none
// shorter than 2 tiles of the widest context. Nothing here depends on
// where the streams are: each block cuts its own stream's keys.
struct SweepShape {
    int nw, row_tiles, splits;
    SweepShape(int B, int NQ, int KV, int ctx, int maxw) {
        nw = max(1, min(maxw, (NQ + 15) / 16));
        row_tiles = (NQ + 16 * nw - 1) / (16 * nw);
        const int ntiles = (ctx + KT - 1) / KT;
        const int blocks = B * KV * row_tiles;
        const int s = max(1, min((2 * SMS + blocks - 1) / blocks, ntiles / 2));
        const int per = max(1, (ntiles + s - 1) / s);
        splits = max(1, (ntiles + per - 1) / per);
    }
};
// Warps a block: the verify chunks and decode hold all of a stream's few
// rows in one block; the prefill takes 4 (3 blocks an SM fit in registers),
// so 4 warps share each K/V tile.
constexpr int VERIFY_WARPS = MAXW;
constexpr int PREFILL_WARPS = 4;

// The multi-stream sweep's shape: B streams of m rows (the spec verify's m,
// decode's 1) over at most `ctx` keys a stream (the table's max_pages x
// page, or S), all of a stream's m x G query rows of a kv head in one block.
static inline SweepShape stream_shape(int B, int m, int H, int KV, int ctx) {
    return SweepShape(B, m * (H / KV), KV, ctx, VERIFY_WARPS);
}

// The two passes of the sweep over `shape`'s grid into the partials `part`,
// then the combine into attn (FOLD: with each decode row's own key). B
// streams of m rows from positions[sb] (null: pos0); row i sees keys < pos +
// inc + i, keys >= pos from the scratch rows kcur / vcur with `own`.
template <bool Q8, bool FOLD, class Rows, int HD>
static void launch_sweep(const SweepShape& shape, const void* q, const void* kcur,
                         const void* vcur, const void* k_pool, const void* v_pool,
                         const void* k_scale, const void* v_scale, Rows rows, int B, int m,
                         const void* positions, int pos0, int inc, int own, int H, int KV,
                         float scale, void* attn, void* part, void* stream, int& err) {
    auto first = tc_sweep<Q8, true, Rows, HD>;
    auto second = tc_sweep<Q8, false, Rows, HD>;
    constexpr size_t smem = SweepSmem<Q8, HD>::bytes;
    static const int attr = allow_dynamic_smem(first, smem) | allow_dynamic_smem(second, smem);
    if (attr) {
        if (!err) err = attr;
        return;
    }
    const SweepRows sr{(const int*)positions, pos0, m, inc, own, shape.row_tiles};
    const dim3 grid(shape.splits, KV, B * shape.row_tiles), block(32 * shape.nw);
    for (auto kern : {first, second}) {
        DORA_LAUNCH_SMEM(kern, grid, block, smem, stream, (const float*)q, (const float*)kcur,
                         (const float*)vcur, k_pool, v_pool, (const float*)k_scale,
                         (const float*)v_scale, rows, sr, H, KV, scale, (float*)part);
        DORA_CHECK(err);
    }
    // two warps an SM, up to 16 rows each
    const int NQT = B * m * (H / KV);
    const int per = max(1, min(16, NQT * KV / (2 * SMS)));
    auto comb = sweep_combine<HD, FOLD>;
    DORA_LAUNCH(comb, dim3((NQT + per - 1) / per, KV), dim3(32), stream,
                (const float*)part, shape.splits, per, (bf16*)attn, NQT, H, KV,
                (const float*)q, (const float*)kcur, (const float*)vcur, scale);
    DORA_CHECK(err);
}

// The K splits of a weight product of the sublayers: the SIMT int8 product
// (G 0), or the tensor-core int4 product of group G.
extern "C" int dora_gemm_splits(int M, int N, int K, int G) {
    return G ? tc_splits(M, N, K, G) : gemm_splits(M, N, K);
}

// One weight product of a sublayer into the partials p: int8 w (G 0) on the
// SIMT launch_gemm, whose epilogue applies the per-column scale s; int4 (G
// its group) on the tensor-core product, which applies the group scales s
// itself. Returns the epilogue's scale (null for int4) and sets `splits`.
static const float* weight_product(const bf16* A, const void* w, const void* s, int G,
                                   float* p, int M, int N, int K, int& splits, void* stream,
                                   int& err) {
    splits = dora_gemm_splits(M, N, K, G);
    if (!G) {
        launch_gemm(A, (const int8_t*)w, p, M, N, K, stream, err);
        return (const float*)s;
    }
    const int e = tc_gemm(A, QWeight(w, (const float*)s, G), p, M, N, K, stream);
    if (!err) err = e;
    return nullptr;
}

// Shared tail of every entry point: wo product, scale, residual.
static void out_projection(const void* x, const void* wo, const void* swo, int g_o,
                           void* out, int residual, int M, int D, int H, int hd,
                           void* p, void* attn, void* stream, int& err) {
    int splits;
    const float* s = weight_product((const bf16*)attn, wo, swo, g_o, (float*)p, M, D, H * hd,
                                    splits, stream, err);
    launch_epilogue((const float*)p, splits, M, D, s, nullptr,
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
                              const void* sqkv, int g_qkv, const void* bqkv, const void* cosr,
                              const void* sinr, void* k_pool, void* v_pool,
                              void* k_scale, void* v_scale, const void* positions,
                              int pos0, int per_stream, Rows rows, int M, int D,
                              int H, int KV, float eps, void* h, void* p, void* q,
                              void* kcur, void* vcur, void* stream, int& err) {
    const int N = (H + 2 * KV) * HD;
    DORA_LAUNCH(rmsnorm_rows, dim3(M), dim3(256), stream,
                (const bf16*)x, (const float*)norm_w, (bf16*)h, D, eps);
    DORA_CHECK(err);
    int splits;
    const float* s = weight_product((const bf16*)h, wqkv, sqkv, g_qkv, (float*)p, M, N, D,
                                    splits, stream, err);
    auto kern = qkv_rope_write<Q8, Rows, HD>;
    DORA_LAUNCH(kern, dim3(M), dim3(HD), stream,
                (const float*)p, splits, M, s,
                (const float*)bqkv, (const float*)cosr, (const float*)sinr,
                (const int*)positions, pos0, per_stream, rows,
                k_pool, v_pool, (float*)k_scale, (float*)v_scale, (float*)q,
                (float*)kcur, (float*)vcur, H, KV);
    DORA_CHECK(err);
}

// Decode (kernels 3, 8 and 9): B rows, row b of stream b at positions[b]
// (null: every row at pos0, batch 1). The rows sweep their prior context on
// the tensor cores over split keys (one query row a stream: its G heads
// pack into one warp's 16 rows) into the partials `part`, positions read on
// the device, and the combine folds each row's own key from f32; the split
// count comes from B, KV and `ctx`, the widest context a stream can have
// (the table's max_pages x page, or S).
template <bool Q8, class Rows, int HD>
static int decode_step(const void* x, const void* norm_w, const void* wqkv,
                       const void* sqkv, const void* bqkv, const void* cosr,
                       const void* sinr, void* k_pool, void* v_pool, void* k_scale,
                       void* v_scale, const void* wo, const void* swo, int g_qkv,
                       int g_o, const void* positions, int pos0, Rows rows, int ctx, void* out,
                       int residual, int B, int D, int H, int KV, float eps,
                       float scale, void* h, void* p, void* q, void* kcur, void* vcur,
                       void* attn, void* part, void* stream) {
    int err = 0;
    project_and_write<Q8, Rows, HD>(x, norm_w, wqkv, sqkv, g_qkv, bqkv, cosr, sinr, k_pool,
                                    v_pool, k_scale, v_scale, positions, pos0, 1, rows,
                                    B, D, H, KV, eps, h, p, q, kcur, vcur, stream, err);
    launch_sweep<Q8, true, Rows, HD>(stream_shape(B, 1, H, KV, ctx), q, kcur, vcur, k_pool,
                                     v_pool, k_scale, v_scale, rows, B, 1, positions, pos0, 0,
                                     0, H, KV, scale, attn, part, stream, err);
    out_projection(x, wo, swo, g_o, out, residual, B, D, H, HD, p, attn, stream, err);
    return err;
}

// Prefill: M rows of one stream at pos0 .. pos0 + M - 1 (pos0 and M
// multiples of the page). The sweep holds the chunk's M x G query rows of a
// kv head in tiles of 64 (4 warps sharing each K/V tile) and splits the keys
// [0, pos0 + M) over grid x so the grid holds about two blocks an SM (6
// splits of 4 tiles at 256 rows of 12 / 2 heads from 512); a block walks
// only the tiles its last row sees, causally (row i sees keys <= pos0 + i):
// the prior pages from the pool, its own chunk from the pool in the fp form
// (the bf16 values just written) and from the f32 scratch rounded to bf16 in
// the int8 form. The combine sums the splits.
static inline SweepShape prefill_shape(int M, int H, int KV, int position) {
    return SweepShape(1, M * (H / KV), KV, position + M, PREFILL_WARPS);
}

template <bool Q8, int HD>
static int chunk_step(const void* x, const void* norm_w, const void* wqkv,
                      const void* sqkv, const void* bqkv, const void* cosr,
                      const void* sinr, void* k_pool, void* v_pool, void* k_scale,
                      void* v_scale, const void* wo, const void* swo, int g_qkv, int g_o,
                      int position, PagedRows rows, void* out, int residual, int M, int D, int H,
                      int KV, float eps, float scale, void* h, void* p, void* q,
                      void* kcur, void* vcur, void* attn, void* part, void* stream) {
    int err = 0;
    project_and_write<Q8, PagedRows, HD>(x, norm_w, wqkv, sqkv, g_qkv, bqkv, cosr, sinr,
                                         k_pool, v_pool, k_scale, v_scale, nullptr,
                                         position, M, rows, M, D, H, KV, eps, h, p, q,
                                         kcur, vcur, stream, err);
    launch_sweep<Q8, false, PagedRows, HD>(prefill_shape(M, H, KV, position), q, kcur, vcur,
                                           k_pool, v_pool, k_scale, v_scale, rows, 1, M,
                                           nullptr, position, 1, Q8, H, KV, scale, attn, part,
                                           stream, err);
    out_projection(x, wo, swo, g_o, out, residual, M, D, H, HD, p, attn, stream, err);
    return err;
}

// Dense verify (kernel 10): M rows of one stream at pos0 .. pos0 + M - 1 of
// [KV, S, HD] planes. One row tile holds the M x G query rows of a kv head
// (up to 128); the sweep splits the keys [0, pos0 + M) over grid x (32
// splits of 2 tiles at 2043): the prior context from the cache, the M own
// rows causally from bf16 of the f32 scratch, never from the cache.
static inline SweepShape verify_shape(int M, int H, int KV, int position) {
    return SweepShape(1, M * (H / KV), KV, position + M, VERIFY_WARPS);
}

template <int HD>
static int dense_chunk_step(const void* x, const void* norm_w, const void* wqkv,
                            const void* sqkv, const void* bqkv, const void* cosr,
                            const void* sinr, void* k_cache, void* v_cache, const void* wo,
                            const void* swo, int g_qkv, int g_o, int position, void* out,
                            int residual, int M,
                            int D, int H, int KV, int S, float eps, float scale, void* h,
                            void* p, void* q, void* kcur, void* vcur, void* attn, void* part,
                            void* stream) {
    int err = 0;
    const DenseRows rows{S};
    project_and_write<false, DenseRows, HD>(x, norm_w, wqkv, sqkv, g_qkv, bqkv, cosr, sinr,
                                            k_cache, v_cache, nullptr, nullptr, nullptr,
                                            position, M, rows, M, D, H, KV, eps, h, p, q,
                                            kcur, vcur, stream, err);
    launch_sweep<false, false, DenseRows, HD>(verify_shape(M, H, KV, position), q, kcur, vcur,
                                              k_cache, v_cache, nullptr, nullptr, rows, 1, M,
                                              nullptr, position, 1, 1, H, KV, scale, attn,
                                              part, stream, err);
    out_projection(x, wo, swo, g_o, out, residual, M, D, H, HD, p, attn, stream, err);
    return err;
}

// Paged spec verify (kernel 5): B streams of m rows, stream b's from
// positions[b], read on the device. One row tile a stream holds its m x G
// query rows of a kv head (30 at Qwen2-1.5B's m = 5: two warps); the keys of
// the widest table, max_pages x page, set the splits (8 at 16 streams of
// 2048 rows), and each block cuts its own stream's keys [0, pos + m) into
// them: the prior context through the stream's table row, its m own rows
// causally from bf16 of the f32 scratch, never from the pool.

template <bool Q8, int HD>
static int spec_step(const void* x, const void* norm_w, const void* wqkv,
                     const void* sqkv, const void* bqkv, const void* cosr,
                     const void* sinr, void* k_pool, void* v_pool, void* k_scale,
                     void* v_scale, const void* wo, const void* swo, int g_qkv, int g_o,
                     const void* positions, PagedRows rows, int ctx, void* out,
                     int residual, int B, int m, int D, int H, int KV, float eps,
                     float scale, void* h, void* p, void* q, void* kcur, void* vcur,
                     void* attn, void* part, void* stream) {
    int err = 0;
    const int M = B * m;
    project_and_write<Q8, PagedRows, HD>(x, norm_w, wqkv, sqkv, g_qkv, bqkv, cosr, sinr, k_pool,
                                         v_pool, k_scale, v_scale, positions, 0, m, rows,
                                         M, D, H, KV, eps, h, p, q, kcur, vcur, stream, err);
    launch_sweep<Q8, false, PagedRows, HD>(stream_shape(B, m, H, KV, ctx), q, kcur, vcur, k_pool,
                                           v_pool, k_scale, v_scale, rows, B, m, positions, 0,
                                           1, 1, H, KV, scale, attn, part, stream, err);
    out_projection(x, wo, swo, g_o, out, residual, M, D, H, HD, p, attn, stream, err);
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
// x [B, D] bf16; norm_w [D] f32; wqkv int8 [D, (H+2KV)*hd] with sqkv f32
// [(H+2KV)*hd]; bqkv f32 or null; cos/sin [B, hd] f32; pools bf16 or int8
// [P, KV, page, hd]; wo int8 [H*hd, D] with swo [D] f32; positions [B] int32;
// block_tables [B, max_pages] int32. out [B, D] bf16 (residual) or f32.
// g_qkv and g_o select int4 weights (0: int8): wqkv [D/2, (H+2KV)*hd] with
// group scales sqkv [D/g_qkv, (H+2KV)*hd], wo [H*hd/2, D] with swo
// [H*hd/g_o, D], each group a multiple of TC_MAX_BK.
// Scratch: h bf16 [B, D]; p f32 (max of the two products' splits*M*N, the
// splits of dora_gemm_splits);
// q f32 [B, H, hd]; kcur, vcur f32 [B, KV, hd]; attn bf16 [B, H*hd]; part
// f32 [splits, B * H, hd + 2] for the sweep's partials, splits =
// dora_batch_sweep_splits(B, 1, H, KV, max_pages * page).
extern "C" int dora_attention_paged_batch_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* wo, const void* swo,
    const void* positions, const void* block_tables, void* out, int residual,
    int B, int D, int H, int KV, int hd, int page, int max_pages, int g_qkv, int g_o,
    float eps, float scale, void* h, void* p, void* q, void* kcur, void* vcur, void* attn,
    void* part, void* stream) {
    const PagedRows rows{(const int*)block_tables, max_pages, page};
    DORA_BY_HEAD_DIM(hd, (k_scale ? decode_step<true, PagedRows, HD>
                                  : decode_step<false, PagedRows, HD>)(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool, v_pool, k_scale, v_scale,
        wo, swo, g_qkv, g_o, positions, 0, rows, max_pages * page, out, residual, B, D, H, KV, eps, scale,
        h, p, q, kcur, vcur, attn, part, stream));
}

// As above for M rows of one stream at positions position..position+M-1
// (position and M multiples of the page); block_table [max_pages] int32 is
// that stream's row. Scratch as above; kcur and vcur [M, KV, hd] are needed
// in the int8 form only (null in fp); part f32 [splits, KV, M * H / KV,
// hd + 2] for the sweep's partials, splits = dora_sweep_splits(0, M, H, KV,
// position).
extern "C" int dora_attention_paged_chunk_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* wo, const void* swo,
    int position, const void* block_table, void* out, int residual, int M, int D,
    int H, int KV, int hd, int page, int g_qkv, int g_o, float eps, float scale, void* h,
    void* p, void* q, void* kcur, void* vcur, void* attn, void* part, void* stream) {
    const PagedRows rows{(const int*)block_table, 0, page};
    DORA_BY_HEAD_DIM(hd, (k_scale ? chunk_step<true, HD> : chunk_step<false, HD>)(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool, v_pool, k_scale, v_scale,
        wo, swo, g_qkv, g_o, position, rows, out, residual, M, D, H, KV, eps, scale, h, p, q,
        kcur, vcur, attn, part, stream));
}

// The context splits of a tensor-core sweep, hence its partials' size: the
// prefill's (dense 0) or the dense verify's (dense 1) at M rows from
// `position`.
extern "C" int dora_sweep_splits(int dense, int M, int H, int KV, int position) {
    return (dense ? verify_shape(M, H, KV, position) : prefill_shape(M, H, KV, position))
        .splits;
}

// The context splits of the multi-stream sweep of B streams of `rows` rows
// each (the spec verify's m, decode's 1) over at most `ctx` keys a stream:
// the partials take splits x B x rows x H x (hd + 2) floats.
extern "C" int dora_batch_sweep_splits(int B, int rows, int H, int KV, int ctx) {
    return stream_shape(B, rows, H, KV, ctx).splits;
}

// Spec verify: B streams of m candidate rows each, x [B*m, D] stream-major;
// stream b's rows sit at positions[b] .. positions[b] + m - 1 and route
// through block_tables row b. The caller keeps positions[b] + m <= max_seq
// (the engine's spec headroom); it is not checked here. Scratch as the
// decode entry, for B*m rows; part f32 [splits, B * m * H, hd + 2] for the
// sweep's partials, splits = dora_batch_sweep_splits(B, m, H, KV,
// max_pages * page).
extern "C" int dora_attention_paged_spec_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_pool,
    void* v_pool, void* k_scale, void* v_scale, const void* wo, const void* swo,
    const void* positions, const void* block_tables, void* out, int residual,
    int B, int m, int D, int H, int KV, int hd, int page, int max_pages, int g_qkv, int g_o,
    float eps, float scale, void* h, void* p, void* q, void* kcur, void* vcur, void* attn,
    void* part, void* stream) {
    const PagedRows rows{(const int*)block_tables, max_pages, page};
    DORA_BY_HEAD_DIM(hd, (k_scale ? spec_step<true, HD> : spec_step<false, HD>)(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_pool, v_pool, k_scale, v_scale,
        wo, swo, g_qkv, g_o, positions, rows, max_pages * page, out, residual, B, m, D, H, KV, eps,
        scale, h, p, q, kcur, vcur, attn, part, stream));
}

// Dense decode (attention_batch_step, and attention_step with B = 1): bf16
// caches [B, KV, S, hd], row b written at and attending below positions[b]
// (positions null: the one row at `position`). The caller keeps every
// position in [0, S); it is checked on the host only. Other arguments and
// scratch as the paged decode entry; part f32 [splits, B * H, hd + 2] for
// the sweep's partials, splits = dora_batch_sweep_splits(B, 1, H, KV, S).
extern "C" int dora_attention_dense_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_cache,
    void* v_cache, const void* wo, const void* swo, const void* positions,
    int position, void* out, int residual, int B, int D, int H, int KV, int hd,
    int S, int g_qkv, int g_o, float eps, float scale, void* h, void* p, void* q, void* kcur,
    void* vcur, void* attn, void* part, void* stream) {
    DORA_BY_HEAD_DIM(hd, (decode_step<false, DenseRows, HD>(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_cache, v_cache, nullptr, nullptr,
        wo, swo, g_qkv, g_o, positions, position, DenseRows{S}, S, out, residual, B, D, H, KV, eps,
        scale, h, p, q, kcur, vcur, attn, part, stream)));
}

// Dense batch-1 chunk (attention_chunk_step): M rows at position ..
// position + M - 1 of bf16 caches [KV, S, hd]; position + M <= S (the
// speculation headroom, checked by the wrapper). Scratch as the spec entry
// for M rows, and part as the prefill entry's (dora_sweep_splits(1, ...)).
extern "C" int dora_attention_dense_chunk_step(
    const void* x, const void* norm_w, const void* wqkv, const void* sqkv,
    const void* bqkv, const void* cosr, const void* sinr, void* k_cache,
    void* v_cache, const void* wo, const void* swo, int position, void* out,
    int residual, int M, int D, int H, int KV, int hd, int S, int g_qkv, int g_o,
    float eps, float scale, void* h, void* p, void* q, void* kcur, void* vcur, void* attn,
    void* part, void* stream) {
    DORA_BY_HEAD_DIM(hd, (dense_chunk_step<HD>(
        x, norm_w, wqkv, sqkv, bqkv, cosr, sinr, k_cache, v_cache, wo, swo, g_qkv, g_o,
        position,
        out, residual, M, D, H, KV, S, eps, scale, h, p, q, kcur, vcur, attn, part,
        stream)));
}

// One 16 x 8 x 16 tile through mma_bf16_16816 (one warp): D = A B for bf16
// A [16, 16] and B [16, 8] (k-major), f32 D [16, 8]; every lane builds its
// fragments by the layout the sweep uses. Checks that layout against a
// plain product, on the card and in the emulated build.
static __global__ void __launch_bounds__(32)
mma_tile(const bf16* __restrict__ A, const bf16* __restrict__ B, float* __restrict__ D) {
    const int lane = threadIdx.x, g = lane / 4, t = lane % 4;
    const uint32_t a[4] = {pack_bf16(A[g * 16 + 2 * t], A[g * 16 + 2 * t + 1]),
                           pack_bf16(A[(g + 8) * 16 + 2 * t], A[(g + 8) * 16 + 2 * t + 1]),
                           pack_bf16(A[g * 16 + 2 * t + 8], A[g * 16 + 2 * t + 9]),
                           pack_bf16(A[(g + 8) * 16 + 2 * t + 8], A[(g + 8) * 16 + 2 * t + 9])};
    const uint32_t b[2] = {pack_bf16(B[2 * t * 8 + g], B[(2 * t + 1) * 8 + g]),
                           pack_bf16(B[(2 * t + 8) * 8 + g], B[(2 * t + 9) * 8 + g])};
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    mma_bf16_16816(d, a, b);
    D[g * 8 + 2 * t] = d[0];
    D[g * 8 + 2 * t + 1] = d[1];
    D[(g + 8) * 8 + 2 * t] = d[2];
    D[(g + 8) * 8 + 2 * t + 1] = d[3];
}

extern "C" int dora_mma_tile(const void* A, const void* B, void* D, void* stream) {
    int err = 0;
    DORA_LAUNCH(mma_tile, dim3(1), dim3(32), stream, (const bf16*)A, (const bf16*)B,
                (float*)D);
    DORA_CHECK(err);
    return err;
}
