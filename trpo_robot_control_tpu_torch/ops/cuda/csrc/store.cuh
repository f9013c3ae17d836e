// The rollout kernels' stores of obs and actions (rollout.cu,
// rollout3d.cu): fp32 as computed, or bf16 rounded to nearest even once at
// the store, so the trajectory itself stays fp32.
#pragma once

#include <cuda_bf16.h>

template <typename Out>
__device__ __forceinline__ Out store_cast(float x);
template <>
__device__ __forceinline__ float store_cast<float>(float x) {
    return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store_cast<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}
