// Counter-based Gaussian noise for the rollout kernels (rollout.cu,
// rollout3d.cu): Philox4x32-10 (Salmon et al., SC'11) keyed by a seed the
// caller draws from its torch.Generator, one call per (env, step, block
// of four uniforms), no state carried between steps; paired Box-Muller
// in the layout of the TPU kernels' _normals.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
        uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
        ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
        key.x += 0x9E3779B9u;
        key.y += 0xBB67AE85u;
    }
    return ctr;
}

// bits -> uniform in (0, 1): 23 bits plus half an ulp, never 0 (log-safe)
__device__ __forceinline__ float uniform01(uint32_t bits) {
    return (float)(bits >> 9) * 1.1920928955078125e-07f
           + 5.9604644775390625e-08f;
}

// NJ standard normals: rows [0, half) are the cos halves, [half, 2 half)
// the sin halves of the same Box-Muller pairs.
template <int NJ>
__device__ __forceinline__ void normals(uint2 key, uint32_t env, uint32_t t,
                                        float* z) {
    constexpr int HALF = (NJ + 1) / 2;
    float u[2 * HALF + 3];
#pragma unroll
    for (int b = 0; b < (2 * HALF + 3) / 4; ++b) {
        uint4 r = philox4x32_10(make_uint4(env, t, (uint32_t)b, 0u), key);
        u[4 * b + 0] = uniform01(r.x);
        u[4 * b + 1] = uniform01(r.y);
        u[4 * b + 2] = uniform01(r.z);
        u[4 * b + 3] = uniform01(r.w);
    }
#pragma unroll
    for (int p = 0; p < HALF; ++p) {
        float rad = sqrtf(-2.f * logf(u[p]));
        float s, cs;
        sincosf(6.283185307179586f * u[HALF + p], &s, &cs);
        z[p] = rad * cs;
        if (HALF + p < NJ) z[HALF + p] = rad * s;
    }
}
