// Host stand-in for cuda_bf16.h (see cuda_runtime.h in this directory):
// bf16 storage with round-to-nearest-even conversion from f32.
#pragma once

#include <cstdint>
#include <cstring>

struct __nv_bfloat16 {
    uint16_t x;
};

inline __nv_bfloat16 __float2bfloat16(float f) {
    uint32_t u;
    std::memcpy(&u, &f, 4);
    __nv_bfloat16 r;
    if ((u & 0x7f800000u) == 0x7f800000u && (u & 0x007fffffu)) {
        r.x = (uint16_t)((u >> 16) | 0x40);  // quiet NaN
        return r;
    }
    u += 0x7fffu + ((u >> 16) & 1u);
    r.x = (uint16_t)(u >> 16);
    return r;
}

inline float __bfloat162float(__nv_bfloat16 b) {
    uint32_t u = (uint32_t)b.x << 16;
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}

inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
