// Host stand-in for the CUDA runtime, for the emulated build of the kernels
// (ops/_build.py, compiler="host"): the same sources compiled by a C++20
// host compiler with -DDORA_EMULATE, so their indexing and arithmetic can be
// checked against the plain PyTorch versions on a machine without a card.
// Each block runs in turn; each of its threads is one OS thread, and
// __syncthreads() is a barrier over them. __shared__ arrays become statics,
// which is sound because only one block runs at a time. It checks nothing
// that is particular to the card (memory model, launch limits, speed).
#pragma once

#include <algorithm>
#include <barrier>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
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

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;
inline std::barrier<>* dora_emu_barrier = nullptr;

inline void __syncthreads() { dora_emu_barrier->arrive_and_wait(); }

typedef int cudaError_t;
typedef void* cudaStream_t;
constexpr cudaError_t cudaSuccess = 0;
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

struct int4 {
    int x, y, z, w;
};

using std::max;
using std::min;

inline float rsqrtf(float v) { return 1.0f / std::sqrt(v); }

template <class F>
void dora_emu_launch(dim3 grid, dim3 block, F&& body) {
    const unsigned nt = block.x * block.y * block.z;
    blockDim = block;
    gridDim = grid;
    for (unsigned bz = 0; bz < grid.z; ++bz)
        for (unsigned by = 0; by < grid.y; ++by)
            for (unsigned bx = 0; bx < grid.x; ++bx) {
                std::barrier<> bar(nt);
                dora_emu_barrier = &bar;
                std::vector<std::thread> threads;
                threads.reserve(nt);
                for (unsigned t = 0; t < nt; ++t)
                    threads.emplace_back([&, t] {
                        threadIdx = dim3(t % block.x, (t / block.x) % block.y,
                                         t / (block.x * block.y));
                        blockIdx = dim3(bx, by, bz);
                        body();
                    });
                for (auto& th : threads) th.join();
            }
}
