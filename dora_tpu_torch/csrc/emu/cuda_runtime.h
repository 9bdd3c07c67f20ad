// Host stand-in for the CUDA runtime, for the emulated build of the kernels
// (ops/_build.py, compiler="host"): the same sources compiled by a C++20
// host compiler with -DDORA_EMULATE, so their indexing and arithmetic can be
// checked against the plain PyTorch versions on a machine without a card.
// Each block runs in turn, and each of its threads is a fiber (a context of
// its own stack, ucontext) on the launching OS thread: a thread runs until it
// waits at a barrier, then the next runnable one resumes, in a fixed round
// robin, so a launch takes one core and its schedule is the same on a loaded
// machine as on an idle one. __syncthreads() is a barrier over the block's
// threads. __shared__ arrays become statics
// and dynamic shared memory one buffer per block, which is sound because
// only one block runs at a time. Warp collectives (__shfl_xor_sync, the
// ballot, and the m16n8k16 bf16 mma and ldmatrix of common.cuh) meet at a
// barrier of the warp's 32 threads and trade values through the warp's
// exchange buffers;
// the mma computes each lane's C elements from the fragments of all 32
// lanes, and ldmatrix each lane's registers from the row addresses of all
// 32, by the PTX ISA's layouts. A barrier that some thread never reaches
// (a hang on the card) aborts the process. It checks nothing that is
// particular to the card (memory model, launch limits, speed).
#pragma once

#include <sys/mman.h>
#include <ucontext.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static

struct dim3 {
    unsigned x, y, z;
    dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};

// A barrier over n fibers: the last to arrive opens it (a new generation)
// and runs on; the others yield to the scheduler until it is open.
struct DoraEmuBarrier {
    unsigned n, arrived = 0, gen = 0;
    explicit DoraEmuBarrier(unsigned count) : n(count) {}
    void arrive_and_wait();
};

struct DoraEmuWarp;

// One CUDA thread: its context and what the kernel reads of it. The
// scheduler loads a fiber's fields into the globals below before resuming
// it and takes back what the fiber changes (its turn, its block) when it
// yields.
struct DoraEmuFiber {
    ucontext_t ctx;
    dim3 tid, bid;
    DoraEmuWarp* warp = nullptr;
    unsigned lane = 0, turn = 0;
    const DoraEmuBarrier* wait = nullptr;  // the barrier it waits at, if any
    unsigned wait_gen = 0;
    bool done = false;
};

inline dim3 threadIdx;
inline dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;
inline DoraEmuBarrier* dora_emu_barrier = nullptr;
inline unsigned char* dora_emu_smem = nullptr;  // the block's dynamic shared memory
inline DoraEmuFiber* dora_emu_fiber = nullptr;  // the running thread
inline ucontext_t dora_emu_sched;               // the launch's scheduler

inline void __syncthreads() { dora_emu_barrier->arrive_and_wait(); }

// One warp's meeting place: a barrier over its threads and the values they
// trade, in two buffers used by turns: a lane writes its value for the
// warp's k-th collective into buffer k % 2, meets the others, and reads;
// it writes that buffer again only at collective k + 2, after every lane
// has met at k + 1 and so has read what it needed of k.
struct DoraEmuWarp {
    DoraEmuBarrier bar;
    uint64_t x[2][32];
    uint32_t a[2][32][4];
    uint32_t b[2][32][2];
    explicit DoraEmuWarp(unsigned n) : bar(n) {}
};
inline DoraEmuWarp* dora_emu_warp = nullptr;
inline unsigned dora_emu_lane = 0;
inline unsigned dora_emu_turn = 0;  // this lane's collectives, mod 2

inline void DoraEmuBarrier::arrive_and_wait() {
    if (++arrived == n) {
        arrived = 0;
        ++gen;
        return;
    }
    DoraEmuFiber* f = dora_emu_fiber;
    f->wait = this;
    f->wait_gen = gen;
    f->turn = dora_emu_turn;
    f->bid = blockIdx;
    swapcontext(&f->ctx, &dora_emu_sched);
}

template <class T>
inline T __shfl_xor_sync(unsigned, T v, int lane_mask) {
    static_assert(sizeof(T) <= sizeof(uint64_t), "one register");
    DoraEmuWarp* w = dora_emu_warp;
    const unsigned k = dora_emu_turn ^= 1;
    uint64_t bits = 0;
    std::memcpy(&bits, &v, sizeof(T));
    w->x[k][dora_emu_lane] = bits;
    w->bar.arrive_and_wait();
    bits = w->x[k][dora_emu_lane ^ (unsigned)lane_mask];
    T r;
    std::memcpy(&r, &bits, sizeof(T));
    return r;
}

// __ballot_sync over the whole warp: bit l set where lane l's p holds.
inline unsigned dora_emu_ballot(bool p) {
    DoraEmuWarp* w = dora_emu_warp;
    const unsigned k = dora_emu_turn ^= 1;
    w->x[k][dora_emu_lane] = p ? 1u : 0u;
    w->bar.arrive_and_wait();
    unsigned m = 0;
    for (unsigned l = 0; l < 32; ++l) m |= (unsigned)(w->x[k][l] & 1u) << l;
    return m;
}

inline int __popc(unsigned v) { return __builtin_popcount(v); }

inline float dora_emu_bf16_half(uint32_t reg, int hi) {
    uint32_t u = hi ? (reg & 0xffff0000u) : (reg << 16);
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, D = A B + C. With
// g = lane / 4 and t = lane % 4: A (16 x 16) a[0] holds (g, 2t..2t+1), a[1]
// (g+8, 2t..), a[2] (g, 2t+8..), a[3] (g+8, 2t+8..); B (16 x 8) b[0] holds
// (k 2t..2t+1, n g), b[1] (k 2t+8.., n g); C and D d[0..1] (g, 2t..2t+1),
// d[2..3] (g+8, 2t..); the lower half of each register is the lower index.
inline void dora_emu_mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
    DoraEmuWarp* w = dora_emu_warp;
    const unsigned l = dora_emu_lane, k = dora_emu_turn ^= 1;
    for (int i = 0; i < 4; ++i) w->a[k][l][i] = a[i];
    w->b[k][l][0] = b[0];
    w->b[k][l][1] = b[1];
    w->bar.arrive_and_wait();
    const int g = (int)l / 4, t = (int)l % 4;
    for (int c = 0; c < 4; ++c) {
        const int row = g + (c >= 2 ? 8 : 0), col = 2 * t + (c & 1);
        float sum = 0.f;
        for (int kk = 0; kk < 16; ++kk) {
            const int kl = (kk % 8) / 2, half = kk & 1;
            const float av = dora_emu_bf16_half(
                w->a[k][(row % 8) * 4 + kl][(row >= 8 ? 1 : 0) + (kk >= 8 ? 2 : 0)], half);
            const float bv = dora_emu_bf16_half(w->b[k][col * 4 + kl][kk >= 8 ? 1 : 0], half);
            sum += av * bv;
        }
        d[c] += sum;
    }
}

// ldmatrix.sync.aligned.m8n8.x4(.trans).shared.b16: lane l gives the address
// of row l % 8 of matrix l / 8; of matrix i a lane gets r[i] = row g, columns
// 2t, 2t + 1, or with trans column g, rows 2t, 2t + 1 (g = lane / 4, t =
// lane % 4), the lower index in the lower half.
inline void dora_emu_ldmatrix_x4(uint32_t (&r)[4], const void* row, bool trans) {
    DoraEmuWarp* w = dora_emu_warp;
    const unsigned l = dora_emu_lane, k = dora_emu_turn ^= 1;
    w->x[k][l] = (uint64_t)(uintptr_t)row;
    w->bar.arrive_and_wait();
    const int g = (int)l / 4, t = (int)l % 4;
    for (int i = 0; i < 4; ++i) {
        uint16_t lo, hi;
        if (trans) {
            lo = reinterpret_cast<const uint16_t*>((uintptr_t)w->x[k][8 * i + 2 * t])[g];
            hi = reinterpret_cast<const uint16_t*>((uintptr_t)w->x[k][8 * i + 2 * t + 1])[g];
        } else {
            const uint16_t* p = reinterpret_cast<const uint16_t*>((uintptr_t)w->x[k][8 * i + g]);
            lo = p[2 * t];
            hi = p[2 * t + 1];
        }
        r[i] = (uint32_t)lo | ((uint32_t)hi << 16);
    }
}

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <class F>
inline cudaError_t cudaFuncSetAttribute(F, int, int) { return cudaSuccess; }

struct int4 {
    int x, y, z, w;
};
struct uint4 {
    unsigned x, y, z, w;
};
struct float2 {
    float x, y;
};
struct float4 {
    float x, y, z, w;
};
inline float2 make_float2(float x, float y) { return {x, y}; }

using std::max;
using std::min;

inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }
inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
// __byte_perm without the sign-replicating selectors (bit 3 of a nibble).
inline unsigned __byte_perm(unsigned x, unsigned y, unsigned s) {
    const uint64_t v = ((uint64_t)y << 32) | x;
    unsigned r = 0;
    for (int i = 0; i < 4; ++i) r |= (unsigned)((v >> (8 * ((s >> (4 * i)) & 7))) & 0xff) << (8 * i);
    return r;
}
inline unsigned __float_as_uint(float f) {
    unsigned u;
    std::memcpy(&u, &f, 4);
    return u;
}

// The launch: one fiber per thread of a block, made once and run over every
// block in turn; a block ends for all of them (a barrier of its own, apart
// from __syncthreads') before any starts the next, so the next block finds
// the shared arrays and the warps' exchange buffers free.
inline std::function<void()>* dora_emu_body = nullptr;
inline DoraEmuBarrier* dora_emu_block_end = nullptr;

inline void dora_emu_fiber_main() {
    for (unsigned bz = 0; bz < gridDim.z; ++bz)
        for (unsigned by = 0; by < gridDim.y; ++by)
            for (unsigned bx = 0; bx < gridDim.x; ++bx) {
                blockIdx = dim3(bx, by, bz);
                dora_emu_turn = 0;
                (*dora_emu_body)();
                dora_emu_block_end->arrive_and_wait();
            }
    dora_emu_fiber->done = true;  // and back to the scheduler (uc_link)
}

// Each fiber's stack: ample for the kernels' register arrays; pages are
// committed only where touched.
constexpr size_t DORA_EMU_STACK = size_t(1) << 20;

template <class F>
void dora_emu_launch(dim3 grid, dim3 block, F&& body, size_t smem = 0) {
    const unsigned nt = block.x * block.y * block.z;
    blockDim = block;
    gridDim = grid;
    std::vector<uint4> dyn((smem + sizeof(uint4) - 1) / sizeof(uint4) + 1);
    dora_emu_smem = reinterpret_cast<unsigned char*>(dyn.data());
    DoraEmuBarrier bar(nt), block_end(nt);
    dora_emu_barrier = &bar;
    dora_emu_block_end = &block_end;
    std::function<void()> fn(body);
    dora_emu_body = &fn;
    std::vector<std::unique_ptr<DoraEmuWarp>> warps;
    for (unsigned w = 0; w * 32 < nt; ++w)
        warps.push_back(std::make_unique<DoraEmuWarp>(std::min(32u, nt - w * 32)));
    const size_t bytes = DORA_EMU_STACK * nt;
    void* stacks = mmap(nullptr, bytes, PROT_READ | PROT_WRITE,
                        MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (stacks == MAP_FAILED) abort();
    std::vector<DoraEmuFiber> fibers(nt);
    for (unsigned t = 0; t < nt; ++t) {
        DoraEmuFiber& f = fibers[t];
        f.tid = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
        f.warp = warps[t / 32].get();
        f.lane = t % 32;
        getcontext(&f.ctx);
        f.ctx.uc_stack.ss_sp = static_cast<char*>(stacks) + DORA_EMU_STACK * t;
        f.ctx.uc_stack.ss_size = DORA_EMU_STACK;
        f.ctx.uc_link = &dora_emu_sched;
        makecontext(&f.ctx, dora_emu_fiber_main, 0);
    }
    // Round robin over the runnable fibers until all are done; a pass in
    // which none can run is a deadlock.
    for (unsigned live = nt; live;) {
        bool ran = false;
        for (DoraEmuFiber& f : fibers) {
            if (f.done || (f.wait != nullptr && f.wait->gen == f.wait_gen)) continue;
            f.wait = nullptr;
            dora_emu_fiber = &f;
            threadIdx = f.tid;
            blockIdx = f.bid;
            dora_emu_warp = f.warp;
            dora_emu_lane = f.lane;
            dora_emu_turn = f.turn;
            swapcontext(&dora_emu_sched, &f.ctx);
            ran = true;
            live -= f.done;
        }
        if (!ran) abort();
    }
    munmap(stacks, bytes);
}
