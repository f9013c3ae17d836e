// Baseline normal-equation moments: one read of obs_ff, one extended Gram.
//
// Replaces `pallas_baseline_moments` / `_moments_kernel` in
// trpo_robot_control_tpu/ops/pallas/moments_kernel.py (fp32 and bf16
// storage). Per sample (t, n) the kernel forms
//     v_ext = [obs; obs^2; y; tau_t]        (R = 2 do + 5 values)
// and accumulates the symmetric R x R Gram sum v_ext v_ext^T in fp32. Its
// blocks give every moment of the ridge fit; the caller assembles (A, b)
// and the exact A_tt = N tau^T tau outside, as the TPU wrapper does. In
// bf16 mode obs is read as stored (bf16), obs^2 and y are rounded to bf16
// (as the JAX package's normal_eq_ff rounds them) and tau stays fp32.
//
// What bounds it on an H100: bytes at c2, where it reads 5.3 MB (obs and
// y once, ~1.6 us at 3.35 TB/s) against ~0.09 GFLOP of fp32 FMA (the upper
// triangle, ~1.3 us at 67 TFLOP/s); operations at c3 (bf16), 2.35 GFLOP
// (35 us) against 42.6 MB (13 us). The design reads each obs/y element
// once, coalesced along the env axis, into a shared tile of v_ext rows
// (row stride padded by one word so threads on different rows hit
// different banks); each thread owns fixed upper-triangle entries, sums
// each tile's 128 products on its own and adds the tile sums over the
// block's tiles in registers (at c5 a block holds 400 tiles, 51,200
// samples: a small tile sum loses less to rounding than one product
// added at a time to the block's large running total). Blocks write
// per-block partials and a second pass sums them in a fixed order: no
// float atomics, so the result is bit-identical from call to call.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int S = 128;                  // samples (envs of one step) per tile
constexpr int SP = S + 1;               // padded row stride
constexpr int DO_MAX = 32;
constexpr int R_MAX = 2 * DO_MAX + 5;
constexpr int E_MAX = R_MAX * (R_MAX + 1) / 2;
constexpr int PER_THREAD = (E_MAX + NT - 1) / NT;
constexpr int RED_OUT = 32;             // outputs per reduce block
constexpr int RED_GROUPS = NT / RED_OUT;

// upper-triangle entry e -> (a, b), a <= b, row-major
__device__ __forceinline__ void entry(int e, int R, int& a, int& b) {
    a = 0;
    while (e >= R - a) {
        e -= R - a;
        ++a;
    }
    b = a + e;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
// the storage rounding of a value formed in fp32: none for fp32 storage
__device__ __forceinline__ float store_round(float x, const float*) {
    return x;
}
__device__ __forceinline__ float store_round(float x, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename In>
__global__ void __launch_bounds__(NT) moments_partial_kernel(
    const In* __restrict__ obs, const float* __restrict__ y,
    const float* __restrict__ tau, float* __restrict__ partial, int T,
    int DO, int N) {
    extern __shared__ float sV[];            // R rows of SP
    const int R = 2 * DO + 5;
    const int E = R * (R + 1) / 2;
    const int tid = threadIdx.x;
    int ea[PER_THREAD], eb[PER_THREAD];
    float acc[PER_THREAD];
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
        const int e = tid + r * NT;
        if (e < E) entry(e, R, ea[r], eb[r]);
        acc[r] = 0.f;
    }
    const int tiles_per_t = (N + S - 1) / S;
    const int n_tiles = T * tiles_per_t;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int t = tile / tiles_per_t;
        const int n0 = (tile % tiles_per_t) * S;
        __syncthreads();
        for (int i = tid; i < DO * S; i += NT) {
            const int d = i / S, j = i % S, n = n0 + j;
            const float x =
                (n < N) ? load_f32(obs + ((size_t)t * DO + d) * N + n) : 0.f;
            sV[d * SP + j] = x;
            sV[(DO + d) * SP + j] = store_round(x * x, obs);
        }
        for (int j = tid; j < S; j += NT) {
            const bool ok = n0 + j < N;
            sV[2 * DO * SP + j] =
                ok ? store_round(y[(size_t)t * N + n0 + j], obs) : 0.f;
#pragma unroll
            for (int k = 0; k < 4; ++k)
                sV[(2 * DO + 1 + k) * SP + j] = ok ? tau[t * 4 + k] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int r = 0; r < PER_THREAD; ++r) {
            if (tid + r * NT < E) {
                const float* va = sV + ea[r] * SP;
                const float* vb = sV + eb[r] * SP;
                float s = 0.f;         // the tile's sum, then the block's
                for (int j = 0; j < S; ++j) s = fmaf(va[j], vb[j], s);
                acc[r] += s;
            }
        }
    }
#pragma unroll
    for (int r = 0; r < PER_THREAD; ++r) {
        const int e = tid + r * NT;
        if (e < E) partial[(size_t)blockIdx.x * E + e] = acc[r];
    }
}

// gram[a, b] = gram[b, a] = sum over blocks of partial[blk, e], in block
// order: group g of each reduce block sums blocks g, g + 8, ...; the eight
// group sums are then added in group order.
__global__ void __launch_bounds__(NT) moments_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ gram, int G,
    int DO) {
    __shared__ float part[RED_GROUPS][RED_OUT];
    const int R = 2 * DO + 5;
    const int E = R * (R + 1) / 2;
    const int lane = threadIdx.x % RED_OUT, g = threadIdx.x / RED_OUT;
    const int e = blockIdx.x * RED_OUT + lane;
    float s = 0.f;
    if (e < E)
        for (int b = g; b < G; b += RED_GROUPS) s += partial[(size_t)b * E + e];
    part[g][lane] = s;
    __syncthreads();
    if (g == 0 && e < E) {
        float tot = part[0][lane];
        for (int k = 1; k < RED_GROUPS; ++k) tot += part[k][lane];
        int a, b;
        entry(e, R, a, b);
        gram[a * R + b] = tot;
        gram[b * R + a] = tot;
    }
}

}  // namespace

// obs (T, do, N) fp32, or bf16 when obs_bf16 != 0; y (T, N) and
// tau (T, 4) fp32, all on the device; partial: n_blocks * E floats of
// scratch; gram: (2do+5)^2 floats out.
extern "C" int trpo_moments_launch(const void* obs, const float* y,
                                   const float* tau, float* partial,
                                   float* gram, int T, int DO, int N,
                                   int n_blocks, int obs_bf16, void* stream) {
    if (DO > DO_MAX || DO < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int R = 2 * DO + 5;
    const int E = R * (R + 1) / 2;
    const size_t smem = (size_t)R * SP * sizeof(float);
    if (obs_bf16)
        moments_partial_kernel<<<n_blocks, NT, smem, st>>>(
            static_cast<const __nv_bfloat16*>(obs), y, tau, partial, T, DO, N);
    else
        moments_partial_kernel<<<n_blocks, NT, smem, st>>>(
            static_cast<const float*>(obs), y, tau, partial, T, DO, N);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    moments_reduce_kernel<<<(E + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, gram, n_blocks, DO);
    return (int)cudaGetLastError();
}
