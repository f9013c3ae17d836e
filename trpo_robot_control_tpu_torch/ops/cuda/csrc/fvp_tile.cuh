// What the two Gauss-Newton FVP kernels, the batch-major one (fvp.cu) and
// the feature-first one (fvp_ff.cu), share: the split of an fp32 operand
// into the three bf16 planes of their plane products, and the fixed-order
// reduce pass. Each block writes its share of the weight gradient to a
// per-block partial, and reduce_kernel sums the partials in a fixed order
// with the logstd block 2 v and the damping. No float atomics, so two
// calls on the same inputs return bit-identical Fv.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Not in an unnamed namespace: with the includers' own unnamed namespaces
// that makes nvcc's kernel stubs ambiguous. Every library that includes
// this header builds the same code.
namespace fvp_tile {

constexpr int NT = 256;        // threads per block of the reduce pass
constexpr int RED_OUT = 32;
constexpr int RED_GROUPS = NT / RED_OUT;

// (a, b) -> the bf16x2 registers of their planes hi, mid, lo (a in the low
// half), with a = hi + mid + lo exactly and b the same
// (pg_kernel.split3 states the split)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& mid, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const float ra = a - hf.x, rb = b - hf.y;
    const __nv_bfloat162 m = __floats2bfloat162_rn(ra, rb);
    const float2 mf = __bfloat1622float2(m);
    const __nv_bfloat162 l = __floats2bfloat162_rn(ra - mf.x, rb - mf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    mid = *reinterpret_cast<const uint32_t*>(&m);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// w = p[0] + p[1] + p[2] exactly: split_pair's low halves
__device__ __forceinline__ void split3(float w, __nv_bfloat16 (&p)[3]) {
    uint32_t r[3];
    split_pair(w, 0.f, r[0], r[1], r[2]);
#pragma unroll
    for (int q = 0; q < 3; ++q)
        p[q] = __ushort_as_bfloat16(static_cast<unsigned short>(r[q]));
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < C; ++j) a[i][j] = 0.f;
}

// out[i] = sum over blocks of partial[blk, i] + damping v[i] for the
// weight/bias entries, 2 v[i] + damping v[i] for logstd. Fixed order:
// group g sums blocks g, g + 8, ...; the group sums add in group order.
__global__ void __launch_bounds__(NT) reduce_kernel(
    const float* __restrict__ partial, const float* __restrict__ v,
    float* __restrict__ out, int G, int Pg, int P, float damping) {
    __shared__ float part[RED_GROUPS][RED_OUT];
    const int lane = threadIdx.x % RED_OUT, g = threadIdx.x / RED_OUT;
    const int i = blockIdx.x * RED_OUT + lane;
    float s = 0.f;
    if (i < Pg)
        for (int b = g; b < G; b += RED_GROUPS) s += partial[(size_t)b * Pg + i];
    part[g][lane] = s;
    __syncthreads();
    if (g == 0 && i < P) {
        const float vi = v[i];
        if (i < Pg) {
            float tot = part[0][lane];
            for (int k = 1; k < RED_GROUPS; ++k) tot += part[k][lane];
            out[i] = tot + damping * vi;
        } else {
            out[i] = 2.f * vi + damping * vi;
        }
    }
}

// Launches reduce_kernel over the P entries of v: the Pg of the weight
// gradient (every block's partial), then the da of logstd.
inline cudaError_t reduce(const float* partial, const float* v, float* out,
                          int n_blocks, int Pg, int P, float damping,
                          cudaStream_t st) {
    reduce_kernel<<<(P + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, v, out, n_blocks, Pg, P, damping);
    return cudaGetLastError();
}

}  // namespace fvp_tile
