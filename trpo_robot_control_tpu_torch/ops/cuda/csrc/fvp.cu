// Gauss-Newton Fisher-vector product for the 2-hidden-layer tanh policy.
//
// Replaces `make_pallas_gn_fvp` / `_fvp_kernel` (and its pair-packed twin
// `_fvp_kernel_packed`) in trpo_robot_control_tpu/ops/pallas/fvp_kernel.py.
// One pass over batch-major samples per CG call:
//   forward tangent  dh0 = (1-h0^2)(X dW0 + db0)
//                    dh1 = (1-h1^2)(dh0 W1 + h0 dW1 + db1)
//                    dmu = dh1 W2 + h1 dW2 + db2
//   Fisher scaling   u   = dmu * inv_var / B
//   reverse          gW2 = h1^T u, g1 = (u W2^T)(1-h1^2), gW1 = h0^T g1,
//                    g0 = (g1 W1^T)(1-h0^2), gW0 = X^T g0 (+ bias sums)
// The activations X, h0, h1 are computed once per update outside (they
// are the same for every CG call). The logstd block 2 v and the damping
// are added in the reduce pass.
//
// What bounds it on an H100: fp32 FMAs. At c2 (B' = 25,600 samples,
// do 12, H 64, da 3) one call is ~0.96 GFLOP (~14 us at 67 TFLOP/s)
// against 14.3 MB of activations read (~4.3 us at 3.35 TB/s). The design
// reads each activation once into a shared tile of 64 samples, runs every
// product of the forward and reverse passes out of shared memory (rows
// padded by one word so column reads do not collide in a bank), and keeps
// each thread's share of the weight gradient in registers across all of
// the block's tiles. Blocks write per-block partials; a second pass sums
// them in a fixed order. No float atomics anywhere, so two calls on the
// same inputs return bit-identical Fv: CG's acceptance at the KL boundary
// is sensitive to noise of order 1e-5 on Fv.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_runtime.h>

namespace {

constexpr int H = 64;          // hidden width (both layers)
constexpr int HP = H + 1;      // padded row stride in shared memory
constexpr int S = 64;          // samples per tile
constexpr int NT = 256;        // threads per block
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int RW1 = H * H / NT;                        // 16 gW1 entries
constexpr int RW0 = (DO_MAX * H + NT - 1) / NT;        // <= 8 gW0 entries
constexpr int RW2 = (H * DA_MAX + NT - 1) / NT;        // <= 2 gW2 entries
constexpr int ROWS = NT / H;   // gW0/gW1 rows interleave by this stride
constexpr int RED_OUT = 32;
constexpr int RED_GROUPS = NT / RED_OUT;

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
    float* sT0 = sH1 + S * HP;         // dh0, then g0
    float* sT1 = sT0 + S * HP;         // dh1, then g1
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

    float aW1[RW1], aW0[RW0], aW2[RW2];
#pragma unroll
    for (int r = 0; r < RW1; ++r) aW1[r] = 0.f;
#pragma unroll
    for (int r = 0; r < RW0; ++r) aW0[r] = 0.f;
#pragma unroll
    for (int r = 0; r < RW2; ++r) aW2[r] = 0.f;
    float ab0 = 0.f, ab1 = 0.f, ab2 = 0.f;
    const int jc = tid % H;            // gW0/gW1 column of this thread
    const int k0 = tid / H;            // its first row; rows k0 + ROWS r

    const int n_tiles = (B + S - 1) / S;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int s0 = tile * S;
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
        // forward tangent, layer 0
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            float a = 0.f;
            for (int d = 0; d < DO; ++d) a = fmaf(sX[s * DO + d], sdW0[d * H + c], a);
            a += sdb0[c];
            const float h = sH0[s * HP + c];
            sT0[s * HP + c] = (1.f - h * h) * a;
        }
        __syncthreads();
        // forward tangent, layer 1
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            float a = 0.f;
#pragma unroll 8
            for (int k = 0; k < H; ++k) {
                a = fmaf(sT0[s * HP + k], sW1[k * HP + c], a);
                a = fmaf(sH0[s * HP + k], sdW1[k * HP + c], a);
            }
            a += sdb1[c];
            const float h = sH1[s * HP + c];
            sT1[s * HP + c] = (1.f - h * h) * a;
        }
        __syncthreads();
        // output tangent and Fisher scaling; padded samples get u = 0
        for (int i = tid; i < S * DA; i += NT) {
            const int s = i / DA, m = i % DA;
            float a = 0.f;
            for (int k = 0; k < H; ++k) {
                a = fmaf(sT1[s * HP + k], sW2[k * DA + m], a);
                a = fmaf(sH1[s * HP + k], sdW2[k * DA + m], a);
            }
            a += sdb2[m];
            sU[i] = (s < ns) ? a * sscale[m] : 0.f;
        }
        __syncthreads();
        // reverse: gW2 = h1^T u, gb2 = sum u; g1 = (u W2^T)(1 - h1^2)
#pragma unroll
        for (int r = 0; r < RW2; ++r) {
            const int e = tid + r * NT;
            if (e < H * DA) {
                const int k = e / DA, m = e % DA;
                float acc = aW2[r];
                for (int s = 0; s < S; ++s)
                    acc = fmaf(sH1[s * HP + k], sU[s * DA + m], acc);
                aW2[r] = acc;
            }
        }
        if (tid < DA)
            for (int s = 0; s < S; ++s) ab2 += sU[s * DA + tid];
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, k = i % H;
            float g = 0.f;
            for (int m = 0; m < DA; ++m) g = fmaf(sU[s * DA + m], sW2[k * DA + m], g);
            const float h = sH1[s * HP + k];
            sT1[s * HP + k] = g * (1.f - h * h);
        }
        __syncthreads();
        // gW1 = h0^T g1, gb1 = sum g1; g0 = (g1 W1^T)(1 - h0^2)
        for (int s = 0; s < S; ++s) {
            const float g = sT1[s * HP + jc];
#pragma unroll
            for (int r = 0; r < RW1; ++r)
                aW1[r] = fmaf(sH0[s * HP + k0 + ROWS * r], g, aW1[r]);
        }
        if (tid < H)
            for (int s = 0; s < S; ++s) ab1 += sT1[s * HP + tid];
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, k = i % H;
            float g = 0.f;
#pragma unroll 8
            for (int c = 0; c < H; ++c) g = fmaf(sT1[s * HP + c], sW1[k * HP + c], g);
            const float h = sH0[s * HP + k];
            sT0[s * HP + k] = g * (1.f - h * h);
        }
        __syncthreads();
        // gW0 = X^T g0, gb0 = sum g0
        for (int s = 0; s < S; ++s) {
            const float g = sT0[s * HP + jc];
#pragma unroll
            for (int r = 0; r < RW0; ++r) {
                const int d = k0 + ROWS * r;
                if (d < DO) aW0[r] = fmaf(sX[s * DO + d], g, aW0[r]);
            }
        }
        if (tid < H)
            for (int s = 0; s < S; ++s) ab0 += sT0[s * HP + tid];
    }

    float* out = partial + (size_t)blockIdx.x * Pg;
#pragma unroll
    for (int r = 0; r < RW1; ++r) out[oW1 + (k0 + ROWS * r) * H + jc] = aW1[r];
#pragma unroll
    for (int r = 0; r < RW0; ++r) {
        const int d = k0 + ROWS * r;
        if (d < DO) out[d * H + jc] = aW0[r];
    }
#pragma unroll
    for (int r = 0; r < RW2; ++r) {
        const int e = tid + r * NT;
        if (e < H * DA) out[oW2 + e] = aW2[r];
    }
    if (tid < H) {
        out[ob0 + tid] = ab0;
        out[ob1 + tid] = ab1;
    }
    if (tid < DA) out[ob2 + tid] = ab2;
}

// out[i] = sum over blocks of partial[blk, i] + damping v[i] for the
// weight/bias entries, 2 v[i] + damping v[i] for logstd. Fixed order:
// group g sums blocks g, g + 8, ...; the group sums add in group order.
__global__ void __launch_bounds__(NT) fvp_reduce_kernel(
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
    const int Pg = DO * H + H * H + H * DA + 2 * H + DA;
    const int P = Pg + DA;
    fvp_reduce_kernel<<<(P + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, v, out, n_blocks, Pg, P, damping);
    return (int)cudaGetLastError();
}
