// Gauss-Newton Fisher-vector product for the 2-hidden-layer tanh policy
// on batch-major samples.
//
// Replaces `make_pallas_gn_fvp` / `_fvp_kernel` (and its pair-packed twin
// `_fvp_kernel_packed`) in trpo_robot_control_tpu/ops/pallas/fvp_kernel.py.
// One pass over the (B, do) samples per CG call: the forward tangent, the
// Fisher scaling and the reverse accumulation of fvp_tile.cuh, out of a
// shared tile of 64 samples. The activations X, h0, h1 are computed once
// per update outside (they are the same for every CG call). The logstd
// block 2 v and the damping are added in the reduce pass.
//
// What bounds it on an H100: fp32 FMAs. At c2 (B' = 25,600 samples,
// do 12, H 64, da 3) one call is ~0.96 GFLOP (~14 us at 67 TFLOP/s)
// against 14.3 MB of activations read (~4.3 us at 3.35 TB/s). The design
// reads each activation once into the shared tile and runs every product
// of the forward and reverse passes out of shared memory; see
// fvp_tile.cuh for the accumulation and the fixed-order reduction (no
// float atomics, so two calls on the same inputs return bit-identical Fv:
// CG's acceptance at the KL boundary is sensitive to noise of order 1e-5
// on Fv).
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>

#include "fvp_tile.cuh"

namespace {

using namespace fvp_tile;

constexpr int S = 64;          // samples per tile

__host__ __device__ inline int smem_floats(int DO, int DA) {
    return 2 * H * HP + 2 * H * DA + DO * H + 2 * H + 2 * DA + S * DO
           + 4 * S * HP + S * DA;
}

__global__ void __launch_bounds__(NT) fvp_partial_kernel(
    const float* __restrict__ X, const float* __restrict__ h0,
    const float* __restrict__ h1, const float* __restrict__ W1,
    const float* __restrict__ W2, const float* __restrict__ scale,
    const float* __restrict__ v, float* __restrict__ partial, int B, int DO,
    int DA) {
    extern __shared__ float sm[];
    float* sW1 = sm;                   // (H, HP)
    float* sdW1 = sW1 + H * HP;        // (H, HP)
    float* sW2 = sdW1 + H * HP;        // (H, DA)
    float* sdW2 = sW2 + H * DA;        // (H, DA)
    float* sdW0 = sdW2 + H * DA;       // (DO, H)
    float* sdb0 = sdW0 + DO * H;
    float* sdb1 = sdb0 + H;
    float* sdb2 = sdb1 + H;
    float* sscale = sdb2 + DA;
    float* sX = sscale + DA;           // (S, DO)
    float* sH0 = sX + S * DO;          // (S, HP)
    float* sH1 = sH0 + S * HP;
    float* sT0 = sH1 + S * HP;
    float* sT1 = sT0 + S * HP;
    float* sU = sT1 + S * HP;          // (S, DA)

    // flat parameter order (sorted keys): W0, W1, W2, b0, b1, b2, logstd
    const int oW1 = DO * H, oW2 = oW1 + H * H, ob0 = oW2 + H * DA;
    const int ob1 = ob0 + H, ob2 = ob1 + H, Pg = ob2 + DA;
    const int tid = threadIdx.x;
    for (int i = tid; i < H * H; i += NT) {
        const int k = i / H, c = i % H;
        sW1[k * HP + c] = W1[i];
        sdW1[k * HP + c] = v[oW1 + i];
    }
    for (int i = tid; i < H * DA; i += NT) {
        sW2[i] = W2[i];
        sdW2[i] = v[oW2 + i];
    }
    for (int i = tid; i < DO * H; i += NT) sdW0[i] = v[i];
    for (int i = tid; i < H; i += NT) {
        sdb0[i] = v[ob0 + i];
        sdb1[i] = v[ob1 + i];
    }
    if (tid < DA) {
        sdb2[tid] = v[ob2 + tid];
        sscale[tid] = scale[tid];
    }
    const Smem m = {sX, sH0, sH1, sT0, sT1, sU, sW1, sdW1, sW2, sdW2,
                    sdW0, sdb0, sdb1, sdb2, sscale, DO, DO, DA};
    Acc acc;
    zero(acc);

    const int n_tiles = (B + S - 1) / S;
    for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const int s0 = t * S;
        const int ns = min(S, B - s0);
        __syncthreads();
        for (int i = tid; i < S * DO; i += NT)
            sX[i] = (i < ns * DO) ? X[(size_t)s0 * DO + i] : 0.f;
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            const bool ok = s < ns;
            sH0[s * HP + c] = ok ? h0[(size_t)s0 * H + i] : 0.f;
            sH1[s * HP + c] = ok ? h1[(size_t)s0 * H + i] : 0.f;
        }
        __syncthreads();
        tile<S>(m, ns, acc);
    }
    write_partial(acc, partial + (size_t)blockIdx.x * Pg, DO, DA);
}

}  // namespace

// X (B, do), h0/h1 (B, 64), W1 (64, 64), W2 (64, da), scale (da) =
// exp(-2 logstd) / B, v and out (P) in flat sorted-key order, partial:
// n_blocks * (P - da) floats of scratch. All fp32 on the device.
extern "C" int trpo_fvp_launch(const float* X, const float* h0,
                               const float* h1, const float* W1,
                               const float* W2, const float* scale,
                               const float* v, float* partial, float* out,
                               int B, int DO, int DA, float damping,
                               int n_blocks, void* stream) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const size_t smem = (size_t)smem_floats(DO, DA) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fvp_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    fvp_partial_kernel<<<n_blocks, NT, smem, st>>>(X, h0, h1, W1, W2, scale,
                                                   v, partial, B, DO, DA);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    return (int)reduce(partial, v, out, n_blocks, DO, DA, damping, st);
}
