// Gauss-Newton Fisher-vector product on the feature-first Fisher
// subsample as the rollout stores it, with the hidden activations
// recomputed per call.
//
// Replaces `make_pallas_gn_fvp_ff` / `_fvp_ff_kernel` in
// trpo_robot_control_tpu/ops/pallas/fvp_ff_kernel.py. The subsample is
// obs_ff[::k, :, ::e], a (T', do, N') view of the (T, do, N) batch, read
// in place through its time, feature and env strides (no copy, bf16 or
// fp32 as stored; e = 1 at c3, 4 at c4, 8 at c5). Per call and per sample,
// all in fp32 from the upcast inputs:
//   recompute        h0 = tanh(x W0 + b0), h1 = tanh(h0 W1 + b1)
//   forward tangent  dh0 = (1-h0^2)(x dW0 + db0)
//                    dh1 = (1-h1^2)(dh0 W1 + h0 dW1 + db1)
//                    dmu = dh1 W2 + h1 dW2 + db2
//   Fisher scaling   u   = dmu * inv_var / B'
//   reverse          gW2 = h1^T u, g1 = (u W2^T)(1-h1^2), gW1 = h0^T g1,
//                    g0 = (g1 W1^T)(1-h0^2), gW0 = x^T g0 (+ bias sums)
// The logstd block 2 v and the damping are added in the reduce pass, as
// the TPU wrapper adds them outside its kernel. This is the math of the
// batch-major FVP (fvp.cu) on the subsample flattened and cast to fp32.
//
// What bounds it on an H100: fp32 FMAs. At c3 (B' = 102,400 samples, do
// 24, H 64, da 7) one call is 5.5 GFLOP (82 us at 67 TFLOP/s) against
// 4.9 MB of bf16 obs read (1.5 us at 3.35 TB/s): recomputing the
// activations costs 2 of the 7 products per sample and saves reading
// 52 MB of fp32 activations on each of the 10 CG calls. The design is
// fvp.cu's with a 32-sample tile (one time step, 32 subsampled envs): the
// extra W0 and activation tiles then still let two blocks share an SM.
// With an env stride e a tile's row spans 32 e neighbouring envs, up to
// one 32-byte sector per element, which this operation-bound kernel does
// not feel (at c4, e = 4, it takes as long as at c3, e = 1, for the same
// 102,400 samples). Blocks keep their share of the
// gradient in registers across their tiles and write per-block partials;
// a second pass sums them in a fixed order. No float atomics: two calls on
// the same v return bit-identical Fv, which CG's acceptance at the KL
// boundary needs (trpo/update.py:236-241 in the JAX package). The tile
// body, the per-block partials and the reduction are fvp_tile.cuh's, which
// the batch-major kernel shares.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fvp_tile.cuh"

namespace {

using namespace fvp_tile;

constexpr int S = 32;          // samples per tile

__host__ __device__ inline int smem_floats(int DO, int DA) {
    return 2 * H * HP + 2 * H * DA + 2 * DO * H + 4 * H + 2 * DA
           + S * (DO + 1) + 4 * S * HP + S * DA;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}

template <typename In>
__global__ void __launch_bounds__(NT) fvp_ff_partial_kernel(
    const In* __restrict__ X, long long t_stride, long long d_stride,
    long long n_stride, const float* __restrict__ W0, const float* __restrict__ b0,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ scale,
    const float* __restrict__ v, float* __restrict__ partial, int T,
    int DO, int DA, int N) {
    extern __shared__ float sm[];
    const int XS = DO + 1;             // padded sample stride of the x tile
    float* sW1 = sm;                   // (H, HP)
    float* sdW1 = sW1 + H * HP;        // (H, HP)
    float* sW2 = sdW1 + H * HP;        // (H, DA)
    float* sdW2 = sW2 + H * DA;        // (H, DA)
    float* sW0 = sdW2 + H * DA;        // (DO, H)
    float* sdW0 = sW0 + DO * H;        // (DO, H)
    float* sb0 = sdW0 + DO * H;
    float* sb1 = sb0 + H;
    float* sdb0 = sb1 + H;
    float* sdb1 = sdb0 + H;
    float* sdb2 = sdb1 + H;
    float* sscale = sdb2 + DA;
    float* sX = sscale + DA;           // (S, XS)
    float* sH0 = sX + S * XS;          // (S, HP)
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
    for (int i = tid; i < DO * H; i += NT) {
        sW0[i] = W0[i];
        sdW0[i] = v[i];
    }
    for (int i = tid; i < H; i += NT) {
        sb0[i] = b0[i];
        sb1[i] = b1[i];
        sdb0[i] = v[ob0 + i];
        sdb1[i] = v[ob1 + i];
    }
    if (tid < DA) {
        sdb2[tid] = v[ob2 + tid];
        sscale[tid] = scale[tid];
    }
    const Smem m = {sX, sH0, sH1, sT0, sT1, sU, sW1, sdW1, sW2, sdW2,
                    sdW0, sdb0, sdb1, sdb2, sscale, XS, DO, DA};
    Acc acc;
    zero(acc);

    const int tiles_per_t = (N + S - 1) / S;
    const int n_tiles = T * tiles_per_t;
    for (int tile_id = blockIdx.x; tile_id < n_tiles; tile_id += gridDim.x) {
        const int t = tile_id / tiles_per_t;
        const int n0 = (tile_id % tiles_per_t) * S;
        const int ns = min(S, N - n0);
        __syncthreads();
        for (int i = tid; i < DO * S; i += NT) {
            const int d = i / S, j = i % S;
            sX[j * XS + d] =
                (j < ns) ? load_f32(X + t * t_stride + d * d_stride
                                    + (n0 + j) * n_stride)
                         : 0.f;
        }
        __syncthreads();
        // recompute the activations in fp32
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            float a = 0.f;
            for (int d = 0; d < DO; ++d)
                a = fmaf(sX[s * XS + d], sW0[d * H + c], a);
            sH0[s * HP + c] = tanhf(a + sb0[c]);
        }
        __syncthreads();
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            float a = 0.f;
#pragma unroll 8
            for (int k = 0; k < H; ++k)
                a = fmaf(sH0[s * HP + k], sW1[k * HP + c], a);
            sH1[s * HP + c] = tanhf(a + sb1[c]);
        }
        __syncthreads();
        tile<S>(m, ns, acc);
    }
    write_partial(acc, partial + (size_t)blockIdx.x * Pg, DO, DA);
}

template <typename In>
cudaError_t launch(const void* X, long long t_stride, long long d_stride,
                   long long n_stride, const float* W0,
                   const float* b0, const float* W1, const float* b1,
                   const float* W2, const float* scale, const float* v,
                   float* partial, float* out, int T, int DO, int DA, int N,
                   float damping, int n_blocks, cudaStream_t st) {
    const size_t smem = (size_t)smem_floats(DO, DA) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        fvp_ff_partial_kernel<In>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    fvp_ff_partial_kernel<In><<<n_blocks, NT, smem, st>>>(
        static_cast<const In*>(X), t_stride, d_stride, n_stride, W0, b0, W1,
        b1, W2, scale, v,
        partial, T, DO, DA, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return reduce(partial, v, out, n_blocks, DO, DA, damping, st);
}

}  // namespace

// X: the (T', do, N') subsample, element (t, d, n) at X[t * t_stride +
// d * d_stride + n * n_stride], bf16 when bf16 != 0, else fp32. W0 (do, 64), b0, W1
// (64, 64), b1, W2 (64, da), scale (da) = exp(-2 logstd) / B', v and out
// (P) in flat sorted-key order, all fp32 on the device; partial:
// n_blocks * (P - da) floats of scratch.
extern "C" int trpo_fvp_ff_launch(const void* X, long long t_stride,
                                  long long d_stride, long long n_stride,
                                  const float* W0, const float* b0,
                                  const float* W1, const float* b1,
                                  const float* W2, const float* scale,
                                  const float* v, float* partial, float* out,
                                  int T, int DO, int DA, int N, float damping,
                                  int n_blocks, int bf16, void* stream) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16)
        return (int)launch<__nv_bfloat16>(X, t_stride, d_stride, n_stride, W0,
                                          b0, W1, b1, W2, scale, v, partial,
                                          out, T, DO, DA, N, damping,
                                          n_blocks, st);
    return (int)launch<float>(X, t_stride, d_stride, n_stride, W0, b0, W1,
                              b1, W2, scale, v, partial, out, T, DO, DA, N,
                              damping, n_blocks, st);
}
