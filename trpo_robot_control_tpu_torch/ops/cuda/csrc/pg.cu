// Surrogate-gradient pass at theta_old for the 2-hidden-layer tanh policy,
// over the feature-first batch as the rollout stores it.
//
// Replaces `pallas_surrogate_grad_ff` / `_pg_kernel` in
// trpo_robot_control_tpu/ops/pallas/pg_kernel.py. At theta_old the
// importance ratio is 1, so the gradient has a closed form. Per sample:
//   forward   h0 = r(tanh(x W0 + b0)), h1 = r(tanh(h0 W1 + b1)),
//             mu = h1 W2 + b2, z = (a - mu) e^-logstd,
//             logp = -(sum z^2 + 2 sum logstd + da log 2pi) / 2
//   cotangent u = adv (a - mu) e^-2logstd / B         (fp32)
//   reverse   gW2 = h1^T u, g1 = r((u W2^T)(1 - h1^2)), gW1 = h0^T g1,
//             g0 = r((g1 W1^T)(1 - h0^2)), gW0 = x^T g0 (+ bias sums),
//             glogstd = mean(adv (z^2 - 1))
// where r() rounds to bf16 in bf16 mode (obs/act stored bf16) and is the
// identity in fp32 mode: the rounding points of the JAX package's
// surrogate_grad_ff(store_dtype=bf16). Every product accumulates fp32
// against fp32 weights. mu (T, da, N) and logp (T, N) are written in fp32
// for the line search.
//
// What bounds it on an H100: fp32 FMAs. At c3 (B = 819,200 samples, do 24,
// H 64, da 7) the pass is 27.4 GFLOP (0.41 ms at 67 TFLOP/s) against
// 80 MB read and written (24 us at 3.35 TB/s). The design is the FVP
// kernel's (fvp.cu): a block stages a tile of 64 samples (one time step,
// 64 neighbouring envs, so every load coalesces along N with no relayout)
// in shared memory, runs the forward and the reverse pass out of it (rows
// padded by one word against bank conflicts), and keeps its share of the
// weight gradient in registers across all of its tiles. Blocks write
// per-block partials; a second pass sums them in a fixed order. No float
// atomics, so repeat calls return bit-identical gradients.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
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
constexpr float LOG2PI = 1.8378770664093453f;

__host__ __device__ inline int smem_floats(int DO, int DA) {
    return DO * H + H * HP + H * DA + 2 * H + 4 * DA + 1 + S * (DO + 1)
           + 2 * S * DA + S + 4 * S * HP;
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
}
__device__ __forceinline__ float rnd(float x, const float*) { return x; }
__device__ __forceinline__ float rnd(float x, const __nv_bfloat16*) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename In>
__global__ void __launch_bounds__(NT) pg_partial_kernel(
    const In* __restrict__ obs, const In* __restrict__ act,
    const float* __restrict__ adv, const float* __restrict__ W0,
    const float* __restrict__ b0, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ W2,
    const float* __restrict__ b2, const float* __restrict__ logstd,
    float* __restrict__ mu_out, float* __restrict__ logp_out,
    float* __restrict__ partial, int T, int DO, int DA, int N) {
    extern __shared__ float sm[];
    const int XS = DO + 1;             // padded sample stride of the x tile
    float* sW0 = sm;                   // (DO, H)
    float* sW1 = sW0 + DO * H;         // (H, HP)
    float* sW2 = sW1 + H * HP;         // (H, DA)
    float* sb0 = sW2 + H * DA;
    float* sb1 = sb0 + H;
    float* sb2 = sb1 + H;
    float* sinv_sd = sb2 + DA;         // e^-logstd
    float* sinv_var = sinv_sd + DA;    // e^-2 logstd
    float* sconst = sinv_var + DA;     // 2 sum logstd (then da log 2pi)
    float* sX = sconst + DA + 1;       // (S, XS)
    float* sA = sX + S * XS;           // (S, DA) actions
    float* sAdv = sA + S * DA;         // (S)
    float* sU = sAdv + S;              // (S, DA) output cotangent
    float* sH0 = sU + S * DA;          // (S, HP)
    float* sH1 = sH0 + S * HP;
    float* sT0 = sH1 + S * HP;         // g0
    float* sT1 = sT0 + S * HP;         // g1

    // flat parameter order (sorted keys): W0, W1, W2, b0, b1, b2, logstd
    const int oW1 = DO * H, oW2 = oW1 + H * H, ob0 = oW2 + H * DA;
    const int ob1 = ob0 + H, ob2 = ob1 + H, ols = ob2 + DA, P = ols + DA;
    const int tid = threadIdx.x;
    for (int i = tid; i < H * H; i += NT) sW1[(i / H) * HP + i % H] = W1[i];
    for (int i = tid; i < DO * H; i += NT) sW0[i] = W0[i];
    for (int i = tid; i < H * DA; i += NT) sW2[i] = W2[i];
    for (int i = tid; i < H; i += NT) {
        sb0[i] = b0[i];
        sb1[i] = b1[i];
    }
    if (tid < DA) {
        sb2[tid] = b2[tid];
        sinv_sd[tid] = expf(-logstd[tid]);
        sinv_var[tid] = expf(-2.f * logstd[tid]);
    }
    if (tid == 0) {
        float sl = logstd[0];
        for (int m = 1; m < DA; ++m) sl += logstd[m];
        sconst[0] = 2.f * sl;
        sconst[1] = (float)DA * LOG2PI;
    }

    float aW1[RW1], aW0[RW0], aW2[RW2];
#pragma unroll
    for (int r = 0; r < RW1; ++r) aW1[r] = 0.f;
#pragma unroll
    for (int r = 0; r < RW0; ++r) aW0[r] = 0.f;
#pragma unroll
    for (int r = 0; r < RW2; ++r) aW2[r] = 0.f;
    float ab0 = 0.f, ab1 = 0.f, ab2 = 0.f, als = 0.f;
    const int jc = tid % H;            // gW0/gW1 column of this thread
    const int k0 = tid / H;            // its first row; rows k0 + ROWS r
    const float Bf = (float)T * (float)N;

    const int tiles_per_t = (N + S - 1) / S;
    const int n_tiles = T * tiles_per_t;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int t = tile / tiles_per_t;
        const int n0 = (tile % tiles_per_t) * S;
        const int ns = min(S, N - n0);
        __syncthreads();
        for (int i = tid; i < DO * S; i += NT) {
            const int d = i / S, j = i % S;
            sX[j * XS + d] =
                (j < ns) ? load_f32(obs + ((size_t)t * DO + d) * N + n0 + j)
                         : 0.f;
        }
        for (int i = tid; i < DA * S; i += NT) {
            const int m = i / S, j = i % S;
            sA[j * DA + m] =
                (j < ns) ? load_f32(act + ((size_t)t * DA + m) * N + n0 + j)
                         : 0.f;
        }
        for (int j = tid; j < S; j += NT)
            sAdv[j] = (j < ns) ? adv[(size_t)t * N + n0 + j] : 0.f;
        __syncthreads();
        // forward, layer 0
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            float a = 0.f;
            for (int d = 0; d < DO; ++d)
                a = fmaf(sX[s * XS + d], sW0[d * H + c], a);
            sH0[s * HP + c] = rnd(tanhf(a + sb0[c]), obs);
        }
        __syncthreads();
        // forward, layer 1
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            float a = 0.f;
#pragma unroll 8
            for (int k = 0; k < H; ++k)
                a = fmaf(sH0[s * HP + k], sW1[k * HP + c], a);
            sH1[s * HP + c] = rnd(tanhf(a + sb1[c]), obs);
        }
        __syncthreads();
        // head: mu, logp, the cotangent u and the logstd integrand
        if (tid < S) {
            const int s = tid;
            const bool ok = s < ns;
            const float av = sAdv[s];
            float sz2 = 0.f;
            for (int m = 0; m < DA; ++m) {
                float mu = 0.f;
                for (int k = 0; k < H; ++k)
                    mu = fmaf(sH1[s * HP + k], sW2[k * DA + m], mu);
                mu += sb2[m];
                const float diff = sA[s * DA + m] - mu;
                const float z = diff * sinv_sd[m];
                sz2 = (m == 0) ? z * z : sz2 + z * z;
                sU[s * DA + m] = ok ? ((av * diff) * sinv_var[m]) / Bf : 0.f;
                // logstd integrand adv (z^2 - 1), parked in sT0 until the
                // column sums below have read it
                sT0[s * HP + m] = ok ? av * (z * z - 1.f) : 0.f;
                if (ok) mu_out[((size_t)t * DA + m) * N + n0 + s] = mu;
            }
            if (ok)
                logp_out[(size_t)t * N + n0 + s] =
                    -0.5f * ((sz2 + sconst[0]) + sconst[1]);
        }
        __syncthreads();
        // gW2 = h1^T u, gb2 = sum u, glogstd += sum adv (z^2 - 1)
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
        if (tid < DA) {
            for (int s = 0; s < S; ++s) ab2 += sU[s * DA + tid];
        } else if (tid >= 32 && tid < 32 + DA) {
            for (int s = 0; s < S; ++s) als += sT0[s * HP + tid - 32];
        }
        __syncthreads();
        // g1 = r((u W2^T)(1 - h1^2))
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, k = i % H;
            float g = 0.f;
            for (int m = 0; m < DA; ++m)
                g = fmaf(sU[s * DA + m], sW2[k * DA + m], g);
            const float h = sH1[s * HP + k];
            sT1[s * HP + k] = rnd(g * (1.f - h * h), obs);
        }
        __syncthreads();
        // gW1 = h0^T g1, gb1 = sum g1; g0 = r((g1 W1^T)(1 - h0^2))
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
            for (int c = 0; c < H; ++c)
                g = fmaf(sT1[s * HP + c], sW1[k * HP + c], g);
            const float h = sH0[s * HP + k];
            sT0[s * HP + k] = rnd(g * (1.f - h * h), obs);
        }
        __syncthreads();
        // gW0 = x^T g0, gb0 = sum g0
        for (int s = 0; s < S; ++s) {
            const float g = sT0[s * HP + jc];
#pragma unroll
            for (int r = 0; r < RW0; ++r) {
                const int d = k0 + ROWS * r;
                if (d < DO) aW0[r] = fmaf(sX[s * XS + d], g, aW0[r]);
            }
        }
        if (tid < H)
            for (int s = 0; s < S; ++s) ab0 += sT0[s * HP + tid];
    }

    float* out = partial + (size_t)blockIdx.x * P;
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
    if (tid >= 32 && tid < 32 + DA) out[ols + tid - 32] = als;
}

// g[i] = sum over blocks of partial[blk, i] (the logstd entries then
// divided by B). Fixed order: group g sums blocks g, g + 8, ...; the
// group sums add in group order.
__global__ void __launch_bounds__(NT) pg_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ g, int G, int P,
    int ols, float Bf) {
    __shared__ float part[RED_GROUPS][RED_OUT];
    const int lane = threadIdx.x % RED_OUT, grp = threadIdx.x / RED_OUT;
    const int i = blockIdx.x * RED_OUT + lane;
    float s = 0.f;
    if (i < P)
        for (int b = grp; b < G; b += RED_GROUPS) s += partial[(size_t)b * P + i];
    part[grp][lane] = s;
    __syncthreads();
    if (grp == 0 && i < P) {
        float tot = part[0][lane];
        for (int k = 1; k < RED_GROUPS; ++k) tot += part[k][lane];
        g[i] = (i >= ols) ? tot / Bf : tot;
    }
}

template <typename In>
cudaError_t launch(const void* obs, const void* act, const float* adv,
                   const float* W0, const float* b0, const float* W1,
                   const float* b1, const float* W2, const float* b2,
                   const float* logstd, float* mu, float* logp,
                   float* partial, float* g, int T, int DO, int DA, int N,
                   int n_blocks, cudaStream_t st) {
    const size_t smem = (size_t)smem_floats(DO, DA) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        pg_partial_kernel<In>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    pg_partial_kernel<In><<<n_blocks, NT, smem, st>>>(
        static_cast<const In*>(obs), static_cast<const In*>(act), adv, W0,
        b0, W1, b1, W2, b2, logstd, mu, logp, partial, T, DO, DA, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const int P = DO * H + H * H + H * DA + 2 * H + 2 * DA;
    pg_reduce_kernel<<<(P + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, g, n_blocks, P, P - DA, (float)T * (float)N);
    return cudaGetLastError();
}

}  // namespace

// obs (T, do, N) and act (T, da, N) in bf16 when bf16 != 0, else fp32;
// adv (T, N), the weights W0 (do, 64), b0, W1 (64, 64), b1, W2 (64, da),
// b2 and logstd (da) fp32. Out: mu (T, da, N), logp (T, N) and the flat
// gradient g (P) in sorted-key order, all fp32; partial: n_blocks * P
// floats of scratch.
extern "C" int trpo_pg_launch(const void* obs, const void* act,
                              const float* adv, const float* W0,
                              const float* b0, const float* W1,
                              const float* b1, const float* W2,
                              const float* b2, const float* logstd,
                              float* mu, float* logp, float* partial,
                              float* g, int T, int DO, int DA, int N,
                              int n_blocks, int bf16, void* stream) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16)
        return (int)launch<__nv_bfloat16>(obs, act, adv, W0, b0, W1, b1, W2,
                                          b2, logstd, mu, logp, partial, g, T,
                                          DO, DA, N, n_blocks, st);
    return (int)launch<float>(obs, act, adv, W0, b0, W1, b1, W2, b2, logstd,
                              mu, logp, partial, g, T, DO, DA, N, n_blocks,
                              st);
}
