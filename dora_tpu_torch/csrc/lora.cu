// Grouped (multi-tenant) LoRA delta: replaces the Pallas kernel
// lora_gather_matmul of dora_tpu/ops/lora.py.
//
// y[i] = bf16((f32(x[i]) @ f32(A[g[i]])) @ f32(B[g[i]])) for every row i,
// gathered by adapter id g[i] out of the resident stacks A [S, D, r] /
// B [S, r, N] (one layer's slice of the [S, L, ...] stacks, so consecutive
// slots sit `a_slot` / `b_slot` elements apart); t = x @ A stays f32 between
// the two products, as the reference keeps it. Slot 0 is the all-zeros base
// adapter by contract: its rows get exact zeros, which is what the
// reference's product of zeros gives.
//
// Bound: bytes. The work is 4 * R * D * r operations against the distinct
// slabs of A and B (2 * D * r bf16 each) plus x and y: at decode width (16
// rows, D 1536, rank 32, up to 8 adapters) a few microseconds of HBM time
// and far less of tensor-core time; at rank 256 the slabs are 1.5 MB an
// adapter.
//
// Design: rows are grouped by adapter on the device, so each distinct slab
// is read from device memory once per launch (a slot with more than 64 rows
// rereads it from L2), and both products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, f32 sums). Nothing is read back to the host and
// nothing depends on scheduling: no atomics, every sum in a fixed order.
// The grids follow only the shapes (D, S, R, N), never the ids.
// * Each block takes one slot s and one window of 64 of that slot's rows
//   (grid z: window q holds the slot's rows of rank 64q .. 64q + 63 in
//   ascending row order). It scans groups[] with warp ballots for them into
//   shared memory; a block whose window is empty leaves at once.
// * lora_down, grid (D splits, slots 1..S-1, windows): T_s = X_s @ A_s over
//   one chunk of D. The chunk's A rows (all r columns) and the window's x
//   rows (gathered by index) go to shared memory in one group of cp.async
//   copies; warps take (16-row tile, 16-column group) items, x read with
//   ldmatrix and A with ldmatrix.trans, and write f32 partials [splits, R,
//   r]. The split count follows D, S, r and R only: about two blocks an
//   SM over the resident slots, at most 8 above 32 rows (chunks up to 256
//   deep), so that lora_up sums few splits of many rows. An mma chain sums
//   at most 64 rows of D before its sums are added in f32 (the mma's own
//   sums truncate).
// * lora_up, grid (64-column tiles of N, slots 0..S-1, windows): Y_s =
//   T_s @ B_s. Slot 0's blocks write the zeros. Others copy their B tile
//   [r, 64] with cp.async, sum the D splits of their rows' T in index order
//   in f32 (eight splits' loads in flight at a time), and feed T to the mma
//   as hi + lo bf16 (about 16 bits of t where the reference keeps f32),
//   fresh mma sums every 64 of r added in f32, one bf16 rounding, rows
//   scattered back by index.
// Ranks that are not multiples of 16 (1..256), widths that are not
// multiples of 8 and rows past a tile load as zeros; unaligned rows are
// copied element by element.
#include "common.cuh"

constexpr int LT = 128;        // threads a block: 4 warps
constexpr int LW = LT / 32;
constexpr int LMAXD = 8192;    // most model width the wrapper takes (ops/lora.py KERNEL_MAX_DIM)
constexpr int LMAXR = 256;     // most adapter rank (KERNEL_MAX_RANK)
constexpr int LDC = 256;       // deepest D chunk of a lora_down block
constexpr int LKS = 64;        // D rows an mma chain sums before its sums go to f32
constexpr int LRC = 64;        // rows a block takes at a time (4 tiles of 16)
constexpr int LNB = 64;        // output columns of a lora_up block
constexpr int LSMS = 132;      // the H100's SMs

static_assert(LMAXR % 16 == 0 && LDC % 16 == 0 && LNB % 16 == 0, "whole mma tiles");

static __host__ __device__ inline int lora_rank_pad(int r) { return (r + 15) / 16 * 16; }

// D rows of one lora_down block (16-row steps), so splits = D / dc: about
// two blocks an SM over the S - 1 resident slots; above 32 rows at most 8
// splits, since each lora_up block sums its rows' splits (a prefill chunk
// has 256 rows, mostly of one adapter); at least 32 rows, at most LDC and
// D, and no more than keeps the chunk of A within LDOWN_A bytes.
constexpr int LDOWN_A = 32768;
static inline int lora_chunk(int D, int S, int r, int R) {
    const int slots = max(1, S - 1);
    int want = (2 * LSMS + slots - 1) / slots;
    if (R > 32) want = min(want, 8);
    const int dc = max(32, ((D + want - 1) / want + 15) / 16 * 16);
    const int cap = max(32, LDOWN_A / ((lora_rank_pad(r) + 8) * 2) / 16 * 16);
    return min(min(dc, cap), min(LDC, (D + 15) / 16 * 16));
}

// Window q of slot s's rows: the rows i < R with groups[i] == s whose rank
// among them (ascending i) lies in [64q, 64q + 64), into rl[rank - 64q].
// Returns how many (the same in every thread; rl is complete for the whole
// block on return).
static __device__ int gather_slot_rows(const int* __restrict__ groups, int R, int s, int q,
                                       int* __restrict__ rl) {
    __shared__ int wcnt[LW];
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, lo = q * LRC;
    int base = 0;
    for (int c0 = 0; c0 < R && base < lo + LRC; c0 += LT) {  // uniform over the block
        const int i = c0 + tid;
        const bool hit = i < R && groups[i] == s;
        const unsigned m = warp_ballot(hit);
        if (lane == 0) wcnt[warp] = __popc(m);
        __syncthreads();
        int off = base, tot = base;
        for (int w = 0; w < LW; ++w) {
            off += w < warp ? wcnt[w] : 0;
            tot += wcnt[w];
        }
        const int rank = off + __popc(m & ((1u << lane) - 1u));
        if (hit && rank >= lo && rank < lo + LRC) rl[rank - lo] = i;
        __syncthreads();  // wcnt is rewritten next round; rl complete after the last
        base = tot;
    }
    return min(LRC, max(0, base - lo));
}

// Dynamic shared memory of the two kernels at padded rank RP (and D chunk
// dc).
static inline size_t down_smem(int RP, int dc) {
    return (size_t)dc * (RP + 8) * 2 + (size_t)LRC * (dc + 8) * 2;
}
static inline size_t up_smem(int RP) {
    return (size_t)RP * (LNB + 8) * 2 + 2 * (size_t)LRC * (RP + 8) * 2;
}

// T partials: part[(z * R + i) * r + c] = sum over d in split z of
// x[i, d] * A[s, d, c] for the rows i of window blockIdx.z of slot s =
// blockIdx.y + 1.
static __global__ void __launch_bounds__(LT)
lora_down(const bf16* __restrict__ x, const int* __restrict__ groups,
          const bf16* __restrict__ a, long long a_slot, float* __restrict__ part,
          int R, int D, int r, int dc) {
    DORA_DYNAMIC_SMEM(smem);
    __shared__ int rl[LRC];
    const int s = blockIdx.y + 1, z = blockIdx.x;
    const int RP = lora_rank_pad(r), LDA = RP + 8, LDX = dc + 8;
    bf16* As = (bf16*)smem;            // [dc][LDA]: the chunk's D rows of A
    bf16* Xs = As + (size_t)dc * LDA;  // [LRC][LDX]: the window's x over the chunk
    const int nr = gather_slot_rows(groups, R, s, blockIdx.z, rl);
    if (nr == 0) return;  // uniform: no barrier below is reached
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int lr = lane % 8 + 8 * (lane / 8 % 2), lh = lane / 16;
    const int d0 = z * dc, dn = min(dc, D - d0), nrt = (nr + 15) / 16;
    const bf16* as = a + (size_t)s * a_slot + (size_t)d0 * r;
    const bf16 zero = __float2bfloat16(0.f);
    const bool a_vec = r % 8 == 0 && a_slot % 8 == 0 && ((uintptr_t)a & 15) == 0;
    const bool x_vec = D % 8 == 0 && ((uintptr_t)x & 15) == 0;
    for (int idx = tid; idx < dc * (RP / 8); idx += LT) {
        const int k = idx / (RP / 8), c = idx % (RP / 8) * 8;
        bf16* dst = As + k * LDA + c;
        if (a_vec) {
            const bool live = k < dn && c < r;
            cp_async16(dst, live ? as + (size_t)k * r + c : as, live);
        } else {
            for (int e = 0; e < 8; ++e)
                dst[e] = k < dn && c + e < r ? as[(size_t)k * r + c + e] : zero;
        }
    }
    for (int idx = tid; idx < nrt * 16 * (dc / 8); idx += LT) {
        const int j = idx / (dc / 8), c = idx % (dc / 8) * 8;
        bf16* dst = Xs + j * LDX + c;
        const bf16* src = x + (size_t)(j < nr ? rl[j] : 0) * D + d0 + c;
        if (x_vec) {
            const bool live = j < nr && c < dn;
            cp_async16(dst, live ? src : x, live);
        } else {
            for (int e = 0; e < 8; ++e) dst[e] = j < nr && c + e < dn ? src[e] : zero;
        }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int ncg = RP / 16, dk = (dn + 15) / 16 * 16;
    for (int item = warp; item < nrt * ncg; item += LW) {  // uniform over the warp
        const int rt = item / ncg, cg = item % ncg;
        float tot[2][4] = {};
        for (int k0 = 0; k0 < dk; k0 += LKS) {  // fresh mma sums every LKS rows of D
            float acc[2][4] = {};
            for (int ks = k0 / 16; ks < min(dk, k0 + LKS) / 16; ++ks) {
                uint32_t af[4], bf[4];
                ldmatrix_x4<false>(af, Xs + (rt * 16 + lr) * LDX + ks * 16 + 8 * lh);
                ldmatrix_x4<true>(bf, As + (ks * 16 + lr) * LDA + cg * 16 + 8 * lh);
                const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
                mma_bf16_16816(acc[0], af, b0);
                mma_bf16_16816(acc[1], af, b1);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) tot[j][c] += acc[j][c];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int row = rt * 16 + g + (c >= 2 ? 8 : 0);
                const int col = cg * 16 + j * 8 + 2 * t4 + (c & 1);
                if (row < nr && col < r) part[((size_t)z * R + rl[row]) * r + col] = tot[j][c];
            }
    }
}

// y[i, n0 .. n0 + 63] for the rows i of window blockIdx.z of slot s =
// blockIdx.y: zeros for slot 0, else bf16(T[i] @ B[s]) with T[i] the sum of
// the splits' partials.
static __global__ void __launch_bounds__(LT)
lora_up(const float* __restrict__ part, int splits, const int* __restrict__ groups,
        const bf16* __restrict__ b, long long b_slot, bf16* __restrict__ y, int R, int r,
        int N) {
    DORA_DYNAMIC_SMEM(smem);
    __shared__ int rl[LRC];
    const int s = blockIdx.y, n0 = blockIdx.x * LNB, nn = min(LNB, N - n0);
    const int RP = lora_rank_pad(r), LDB = LNB + 8, LDT = RP + 8;
    bf16* Bs = (bf16*)smem;             // [RP][LDB]: the B tile
    bf16* Th = Bs + (size_t)RP * LDB;   // [LRC][LDT]: hi of the rows' t
    bf16* Tl = Th + (size_t)LRC * LDT;  // [LRC][LDT]: lo of the rows' t
    const int nr = gather_slot_rows(groups, R, s, blockIdx.z, rl);
    if (nr == 0) return;  // uniform: no barrier below is reached
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
    const int lr = lane % 8 + 8 * (lane / 8 % 2), lh = lane / 16;
    const int nrt = (nr + 15) / 16;
    const bf16 zero = __float2bfloat16(0.f);
    if (s == 0) {  // the base slot: an exactly zero delta
        for (int idx = tid; idx < nr * LNB; idx += LT) {
            const int j = idx / LNB, c = idx % LNB;
            if (c < nn) y[(size_t)rl[j] * N + n0 + c] = zero;
        }
        return;
    }
    const bf16* bs = b + (size_t)s * b_slot + n0;
    const bool b_vec = N % 8 == 0 && b_slot % 8 == 0 && ((uintptr_t)b & 15) == 0;
    for (int idx = tid; idx < RP * (LNB / 8); idx += LT) {
        const int k = idx / (LNB / 8), c = idx % (LNB / 8) * 8;
        bf16* dst = Bs + k * LDB + c;
        if (b_vec) {
            const bool live = k < r && c < nn;
            cp_async16(dst, live ? bs + (size_t)k * N + c : bs, live);
        } else {
            for (int e = 0; e < 8; ++e)
                dst[e] = k < r && c + e < nn ? bs[(size_t)k * N + c + e] : zero;
        }
    }
    cp_async_commit();
    const size_t zstride = (size_t)R * r;
    for (int idx = tid; idx < nrt * 16 * RP; idx += LT) {
        const int j = idx / RP, c = idx % RP;
        float tv = 0.f;
        if (j < nr && c < r) {  // eight splits' loads in flight, summed in index order
            const float* p = part + (size_t)rl[j] * r + c;
            for (int z0 = 0; z0 < splits; z0 += 8) {
                float v[8];
#pragma unroll
                for (int u = 0; u < 8; ++u) v[u] = z0 + u < splits ? p[(z0 + u) * zstride] : 0.f;
#pragma unroll
                for (int u = 0; u < 8; ++u) tv += v[u];
            }
        }
        const bf16 hi = __float2bfloat16(tv);
        Th[j * LDT + c] = hi;
        Tl[j * LDT + c] = __float2bfloat16(tv - __bfloat162float(hi));
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int item = warp; item < nrt * (LNB / 16); item += LW) {  // uniform over the warp
        const int rt = item / (LNB / 16), cg = item % (LNB / 16);
        float tot[2][4] = {};
        for (int k0 = 0; k0 < RP; k0 += 64) {
            float acc[2][4] = {};
            for (int ks = k0 / 16; ks < min(RP, k0 + 64) / 16; ++ks) {
                uint32_t ah[4], al[4], bf[4];
                ldmatrix_x4<false>(ah, Th + (rt * 16 + lr) * LDT + ks * 16 + 8 * lh);
                ldmatrix_x4<false>(al, Tl + (rt * 16 + lr) * LDT + ks * 16 + 8 * lh);
                ldmatrix_x4<true>(bf, Bs + (ks * 16 + lr) * LDB + cg * 16 + 8 * lh);
                const uint32_t b0[2] = {bf[0], bf[1]}, b1[2] = {bf[2], bf[3]};
                mma_bf16_16816(acc[0], ah, b0);
                mma_bf16_16816(acc[0], al, b0);
                mma_bf16_16816(acc[1], ah, b1);
                mma_bf16_16816(acc[1], al, b1);
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
#pragma unroll
                for (int c = 0; c < 4; ++c) tot[j][c] += acc[j][c];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int row = rt * 16 + g + (c >= 2 ? 8 : 0);
                const int col = cg * 16 + j * 8 + 2 * t4 + (c & 1);
                if (row < nr && col < nn)
                    y[(size_t)rl[row] * N + n0 + col] = __float2bfloat16(tot[j][c]);
            }
    }
}

// The D splits of the first product, hence the partials' size: splits x
// rows x r floats.
extern "C" int dora_lora_splits(int D, int S, int r, int rows) {
    const int dc = lora_chunk(D, S, r, rows);
    return (D + dc - 1) / dc;
}

// x [rows, D] bf16; groups [rows] int32 in [0, S) (the caller's contract:
// not checked on the card); a: slot s's [D, r] bf16 block at a + s * a_slot;
// b: slot s's [r, N] bf16 block at b + s * b_slot; y [rows, N] bf16; part
// f32 [dora_lora_splits(D, S, r, rows), rows, r] scratch. 1 <= r <= LMAXR,
// D <= LMAXD, rows >= 1.
extern "C" int dora_lora_gather_matmul(const void* x, const void* groups,
                                       const void* a, const void* b,
                                       long long a_slot, long long b_slot, void* y,
                                       void* part, int rows, int D, int r, int N, int S,
                                       void* stream) {
    // the most either kernel takes (lora_down: the largest chunk of A and
    // the deepest of x; lora_up: rank 256), asked for once
    static const int attr =
        allow_dynamic_smem(lora_down, LDOWN_A + (size_t)LRC * (LDC + 8) * 2) |
        allow_dynamic_smem(lora_up, up_smem(LMAXR));
    if (attr) return attr;
    if (r < 1 || r > LMAXR || D > LMAXD) return 1;  // cudaErrorInvalidValue
    int err = 0;
    const int RP = lora_rank_pad(r), dc = lora_chunk(D, S, r, rows);
    const int splits = (D + dc - 1) / dc;
    const int windows = (rows + LRC - 1) / LRC;
    if (S > 1) {
        DORA_LAUNCH_SMEM(lora_down, dim3(splits, S - 1, windows), dim3(LT), down_smem(RP, dc),
                         stream, (const bf16*)x, (const int*)groups, (const bf16*)a, a_slot,
                         (float*)part, rows, D, r, dc);
        DORA_CHECK(err);
    }
    DORA_LAUNCH_SMEM(lora_up, dim3((N + LNB - 1) / LNB, S, windows), dim3(LT), up_smem(RP),
                     stream, (const float*)part, splits, (const int*)groups, (const bf16*)b,
                     b_slot, (bf16*)y, rows, r, N);
    DORA_CHECK(err);
    return err;
}
