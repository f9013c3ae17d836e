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
// surrogate_grad_ff(store_dtype=bf16). The weights stay fp32, as in the
// plain version (models/policy.surrogate_grad_ff). mu (T, da, N) and
// logp (T, N) are written in fp32 for the line search.
//
// fp32 mode (no c1-c5 path; c1 and c2 take the plain version below the
// 400k-sample gate) runs every product as an fp32 FMA from shared memory:
// a tile of 64 samples (one time step, 64 neighbouring envs), rows padded
// by one word, its share of the weight gradient in registers.
//
// bf16 mode (c3-c5) is bound by operations on an H100: at c5 (B = 13.1M
// samples, do 27, H 64, da 7) the MLP is 17,088 MACs a sample, 0.45 TFLOP
// (0.45 ms at 989 TFLOP/s on the tensor cores) against 1.36 GB read and
// written (0.41 ms at 3.35 TB/s). Its six 64-wide products run on the
// tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) and every
// product stays exact:
// - x, h0, h1, g1 and g0 are bf16 values (stored, or rounded at r());
// - each fp32 weight is split in the block's prologue into three bf16
//   planes, w = hi + mid + lo (hi = bf16(w), mid = bf16(w - hi),
//   lo = bf16(w - hi - mid): three 8-bit significands hold fp32's 24, and
//   bf16 has fp32's exponent range), so x W0, h0 W1 and g1 W1^T are each
//   the sum of three exact mma products. The hi plane sums into its own
//   accumulator and mid + lo into a second, added in fp32 at the end, so
//   the truncating tensor-core sums see the large terms only once per
//   k-step;
// - gW1 = h0^T g1 and gW0 = x^T g0 have two bf16 operands: one mma each,
//   summed per tile in fresh accumulators and added in fp32 to running
//   totals (the two-level sum of moments.cu).
// Hidden units are the mma's M, samples its N, features its K. A tile is
// one time step and TS = 64 envs, staged by a two-stage cp.async ring
// (x rows, actions, advantages); the activations go to shared memory
// feature-first, rounded to bf16, as the next product's operand. One
// weight copy [in][out] serves both directions: ldmatrix.trans reads it
// as W^T for the forward, plain ldmatrix as W for g1 W1^T. The da-wide
// head (mu, u, gW2, u W2^T, z, logp) has fp32 operands on both sides and
// runs on the CUDA cores in fp32, spread over the whole block; the bias
// sums ride in the registers of the threads that form g1 and g0. tanhf is
// the precise one: tanh.approx's 2^-10.7 would flip bf16 roundings against
// the plain version.
//
// Both modes write per-block partials; a second pass sums them in a fixed
// order. No float atomics, so repeat calls return bit-identical gradients.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int H = 64;          // hidden width (both layers)
constexpr int NT = 256;        // threads per block
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int RED_OUT = 32;
constexpr int RED_GROUPS = NT / RED_OUT;
constexpr float LOG2PI = 1.8378770664093453f;

// ---------------------------------------------------------------- fp32 mode

constexpr int HP = H + 1;      // padded row stride in shared memory
constexpr int S = 64;          // samples per tile
constexpr int RW1 = H * H / NT;                        // 16 gW1 entries
constexpr int RW0 = (DO_MAX * H + NT - 1) / NT;        // <= 8 gW0 entries
constexpr int RW2 = (H * DA_MAX + NT - 1) / NT;        // <= 2 gW2 entries
constexpr int ROWS = NT / H;   // gW0/gW1 rows interleave by this stride

__host__ __device__ inline int smem_floats(int DO, int DA) {
    return DO * H + H * HP + H * DA + 2 * H + 4 * DA + 1 + S * (DO + 1)
           + 2 * S * DA + S + 4 * S * HP;
}

__global__ void __launch_bounds__(NT) pg_partial_kernel(
    const float* __restrict__ obs, const float* __restrict__ act,
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
                (j < ns) ? obs[((size_t)t * DO + d) * N + n0 + j] : 0.f;
        }
        for (int i = tid; i < DA * S; i += NT) {
            const int m = i / S, j = i % S;
            sA[j * DA + m] =
                (j < ns) ? act[((size_t)t * DA + m) * N + n0 + j] : 0.f;
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
            sH0[s * HP + c] = tanhf(a + sb0[c]);
        }
        __syncthreads();
        // forward, layer 1
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, c = i % H;
            float a = 0.f;
#pragma unroll 8
            for (int k = 0; k < H; ++k)
                a = fmaf(sH0[s * HP + k], sW1[k * HP + c], a);
            sH1[s * HP + c] = tanhf(a + sb1[c]);
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
        // g1 = (u W2^T)(1 - h1^2)
        for (int i = tid; i < S * H; i += NT) {
            const int s = i / H, k = i % H;
            float g = 0.f;
            for (int m = 0; m < DA; ++m)
                g = fmaf(sU[s * DA + m], sW2[k * DA + m], g);
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
            for (int c = 0; c < H; ++c)
                g = fmaf(sT1[s * HP + c], sW1[k * HP + c], g);
            const float h = sH0[s * HP + k];
            sT0[s * HP + k] = g * (1.f - h * h);
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

// ---------------------------------------------------------------- bf16 mode

using bf16 = __nv_bfloat16;

constexpr int TS = 64;                  // samples (envs of one step) per tile
constexpr int RS = TS + 8;              // bf16 row stride: 144 B, so the 8
                                        // rows of an ldmatrix hit distinct
                                        // 16-byte bank groups
constexpr int XR = DO_MAX;              // x rows: layer 0's K, gW0's M
constexpr int PLANES = 3;               // hi, mid, lo

// shared memory, byte offsets
constexpr int W0_PLANE = XR * RS;                      // bf16 elements
constexpr int W1_PLANE = H * RS;
constexpr int OFF_W0 = 0;                              // 3 x (XR, RS) [d][h]
constexpr int OFF_W1 = OFF_W0 + PLANES * W0_PLANE * 2; // 3 x (H, RS) [h][o]
constexpr int ST_X = XR * RS * 2;                      // stage: x [d][s]
constexpr int ST_A = DA_MAX * TS * 2;                  //   actions [m][s]
constexpr int STAGE = ST_X + ST_A + TS * 4;            //   advantages [s]
constexpr int OFF_ST = OFF_W1 + PLANES * W1_PLANE * 2; // 2 stages
constexpr int ACT = H * RS * 2;                        // (H, RS) activations
constexpr int OFF_H0 = OFF_ST + 2 * STAGE;             // h0 [h][s]
constexpr int OFF_H1 = OFF_H0 + ACT;                   // h1 [o][s], then g0
constexpr int OFF_G1 = OFF_H1 + ACT;                   // g1 [o][s]
constexpr int OFF_U = OFF_G1 + ACT;                    // u [m][s] fp32
constexpr int OFF_Z = OFF_U + DA_MAX * TS * 4;         // z [m][s] fp32
constexpr int OFF_W2 = OFF_Z + DA_MAX * TS * 4;        // W2 [k][m] fp32
constexpr int OFF_C = OFF_W2 + H * DA_MAX * 4;         // b2, e^-ls, e^-2ls, 2
constexpr int TC_SMEM = OFF_C + (3 * DA_MAX + 2) * 4;
static_assert(STAGE % 16 == 0 && OFF_ST % 16 == 0 && OFF_U % 16 == 0,
              "cp.async and ldmatrix need 16-byte aligned rows");
static_assert(2 * TC_SMEM + 2048 <= 228 * 1024, "two blocks per SM");
static_assert(4 * DA_MAX * TS * 4 <= ACT, "mu's partial sums fit g1's buffer");

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
    return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
__device__ __forceinline__ float bf16_round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
}

// w = hi + mid + lo exactly (pg_kernel.split3 states the same split)
__device__ __forceinline__ void split3(float w, bf16& hi, bf16& mid,
                                       bf16& lo) {
    hi = __float2bfloat16_rn(w);
    const float r = w - __bfloat162float(hi);
    mid = __float2bfloat16_rn(r);
    lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

// Stage tile (t, n0): x rows [0, DO), actions, advantages. cp.async when
// every row start is 16-byte aligned (N % 8 == 0; envs past N
// zero-filled), else plain loads with the ragged edge masked.
__device__ __forceinline__ void load_tile(
    char* stage, const bf16* __restrict__ obs, const bf16* __restrict__ act,
    const float* __restrict__ adv, int t, int n0, int DO, int DA, int N,
    bool vec) {
    bf16* sx = reinterpret_cast<bf16*>(stage);
    bf16* sa = reinterpret_cast<bf16*>(stage + ST_X);
    float* sv = reinterpret_cast<float*>(stage + ST_X + ST_A);
    const bf16* ot = obs + (size_t)t * DO * N;
    const bf16* at = act + (size_t)t * DA * N;
    const float* vt = adv + (size_t)t * N;
    const int tid = threadIdx.x;
    if (vec) {
        constexpr int CH = TS / 8;      // 16-byte chunks of a bf16 row
        const int nx = DO * CH, na = DA * CH;
        for (int c = tid; c < nx + na + TS / 4; c += NT) {
            if (c < nx) {
                const int d = c / CH, j = 8 * (c % CH), n = n0 + j;
                const bool ok = n < N;
                cp_async16(sx + d * RS + j, ok ? ot + (size_t)d * N + n : ot,
                           ok ? 16 : 0);
            } else if (c < nx + na) {
                const int m = (c - nx) / CH, j = 8 * ((c - nx) % CH);
                const int n = n0 + j;
                const bool ok = n < N;
                cp_async16(sa + m * TS + j, ok ? at + (size_t)m * N + n : at,
                           ok ? 16 : 0);
            } else {
                const int j = 4 * (c - nx - na), n = n0 + j;
                const bool ok = n < N;
                cp_async16(sv + j, ok ? vt + n : vt, ok ? 16 : 0);
            }
        }
    } else {
        const bf16 zero = __float2bfloat16_rn(0.f);
        for (int i = tid; i < DO * TS; i += NT) {
            const int d = i / TS, j = i % TS, n = n0 + j;
            sx[d * RS + j] = (n < N) ? ot[(size_t)d * N + n] : zero;
        }
        for (int i = tid; i < DA * TS; i += NT) {
            const int m = i / TS, j = i % TS, n = n0 + j;
            sa[m * TS + j] = (n < N) ? at[(size_t)m * N + n] : zero;
        }
        for (int j = tid; j < TS; j += NT)
            sv[j] = (n0 + j < N) ? vt[n0 + j] : 0.f;
    }
}

// hi + ml = W^T act, or W act when WT is false: 16 output rows from m0 by
// 32 samples from s0 (four n-tiles), over KS k-steps. act is an [in][s]
// tile, read transposed as B; W is the three [in][out] planes, read
// transposed as A (W^T, rows from column m0) or as stored (W, rows from
// m0). The hi plane sums into hi, mid and lo into ml.
template <int KS, bool WT>
__device__ __forceinline__ void weight_product(
    float (&hi)[4][4], float (&ml)[4][4], const bf16* sW, int plane,
    const bf16* sIn, int m0, int s0, int lane) {
    const int lr = lane & 15, lc = (lane >> 4) << 3;
    const int ar = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) << 3;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        uint32_t b[2][4], a[PLANES][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
            ldmatrix_x4_trans(b[j], sIn + (16 * kk + lr) * RS + s0 + 16 * j + lc);
#pragma unroll
        for (int p = 0; p < PLANES; ++p) {
            if (WT)
                ldmatrix_x4_trans(a[p], sW + p * plane + (16 * kk + ar) * RS +
                                            m0 + ac);
            else
                ldmatrix_x4(a[p], sW + p * plane + (m0 + lr) * RS + 16 * kk + lc);
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t b0 = b[j][2 * h], b1 = b[j][2 * h + 1];
                mma_bf16(hi[2 * j + h], a[0], b0, b1, kk == 0);
                mma_bf16(ml[2 * j + h], a[1], b0, b1, kk == 0);
                mma_bf16(ml[2 * j + h], a[2], b0, b1, false);
            }
    }
}

// r(tanh(acc + b)) into out [h][s] (rows m0 + g, + 8; cols s0 + 8 nt + 2c)
__device__ __forceinline__ void tanh_epilogue(
    const float (&hi)[4][4], const float (&ml)[4][4], const float (&bias)[2],
    bf16* out, int m0, int s0, int lane) {
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const float v0 = tanhf((hi[nt][2 * hf] + ml[nt][2 * hf]) + bias[hf]);
            const float v1 =
                tanhf((hi[nt][2 * hf + 1] + ml[nt][2 * hf + 1]) + bias[hf]);
            *reinterpret_cast<uint32_t*>(out + (m0 + g + 8 * hf) * RS + s0 +
                                         8 * nt + 2 * c) = pack_bf16(v0, v1);
        }
}

__global__ void __launch_bounds__(NT, 2) pg_partial_tc_kernel(
    const bf16* __restrict__ obs, const bf16* __restrict__ act,
    const float* __restrict__ adv, const float* __restrict__ W0,
    const float* __restrict__ b0, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ W2,
    const float* __restrict__ b2, const float* __restrict__ logstd,
    float* __restrict__ mu_out, float* __restrict__ logp_out,
    float* __restrict__ partial, int T, int DO, int DA, int N, int vec) {
    extern __shared__ __align__(16) char smem[];
    bf16* sW0 = reinterpret_cast<bf16*>(smem + OFF_W0);
    bf16* sW1 = reinterpret_cast<bf16*>(smem + OFF_W1);
    bf16* sH0 = reinterpret_cast<bf16*>(smem + OFF_H0);
    bf16* sH1 = reinterpret_cast<bf16*>(smem + OFF_H1);
    bf16* sG0 = sH1;                   // h1 is dead once g1 is formed
    bf16* sG1 = reinterpret_cast<bf16*>(smem + OFF_G1);
    // mu's partial sums [quarter][m][s], over g1's buffer (dead from the
    // last tile's gW1 to this tile's g1)
    float* sMuP = reinterpret_cast<float*>(smem + OFF_G1);
    float* sU = reinterpret_cast<float*>(smem + OFF_U);
    float* sZ = reinterpret_cast<float*>(smem + OFF_Z);
    float* sW2 = reinterpret_cast<float*>(smem + OFF_W2);
    float* sB2 = reinterpret_cast<float*>(smem + OFF_C);
    float* sInvSd = sB2 + DA_MAX;
    float* sInvVar = sInvSd + DA_MAX;
    float* sConst = sInvVar + DA_MAX;

    const int oW1 = DO * H, oW2 = oW1 + H * H, ob0 = oW2 + H * DA;
    const int ob1 = ob0 + H, ob2 = ob1 + H, ols = ob2 + DA, P = ols + DA;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    // mma roles: hidden rows 16 mt.., samples 32 nh.. (gW1: o cols 32 nh..)
    const int mt = warp & 3, nh = warp >> 2;
    // CUDA-core roles: (sample s, output pair mq) and (unit k, quarter sq)
    const int hs = tid & 63, mq = tid >> 6;

    // prologue: the weights' three bf16 planes; W0's rows past DO and the
    // x rows past DO of both stages are zero (layer 0's K is XR)
    for (int i = tid; i < XR * H; i += NT) {
        const int d = i / H, o = i % H;
        bf16 p[PLANES];
        split3(d < DO ? W0[d * H + o] : 0.f, p[0], p[1], p[2]);
#pragma unroll
        for (int q = 0; q < PLANES; ++q) sW0[q * W0_PLANE + d * RS + o] = p[q];
    }
    for (int i = tid; i < H * H; i += NT) {
        const int k = i / H, o = i % H;
        bf16 p[PLANES];
        split3(W1[i], p[0], p[1], p[2]);
#pragma unroll
        for (int q = 0; q < PLANES; ++q) sW1[q * W1_PLANE + k * RS + o] = p[q];
    }
    for (int i = tid; i < 2 * (XR - DO) * RS; i += NT) {
        const int st = i / ((XR - DO) * RS), r = i % ((XR - DO) * RS);
        reinterpret_cast<bf16*>(smem + OFF_ST + st * STAGE)[DO * RS + r] =
            __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < H * DA_MAX; i += NT) {     // W2, outputs padded
        const int k = i / DA_MAX, m = i % DA_MAX;
        sW2[i] = m < DA ? W2[k * DA + m] : 0.f;
    }
    if (tid < DA_MAX) {
        const bool ok = tid < DA;
        sB2[tid] = ok ? b2[tid] : 0.f;
        sInvSd[tid] = ok ? expf(-logstd[tid]) : 0.f;
        sInvVar[tid] = ok ? expf(-2.f * logstd[tid]) : 0.f;
    }
    if (tid == 0) {
        float sl = logstd[0];
        for (int m = 1; m < DA; ++m) sl += logstd[m];
        sConst[0] = 2.f * sl;
        sConst[1] = (float)DA * LOG2PI;
    }
    float w2r[DA_MAX];                 // W2[hs][.], for u W2^T
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) w2r[m] = m < DA ? W2[hs * DA + m] : 0.f;
    const float bias0[2] = {b0[16 * mt + g], b0[16 * mt + g + 8]};
    const float bias1[2] = {b1[16 * mt + g], b1[16 * mt + g + 8]};

    float tot1[4][4], tot0[2][4];      // gW1 (rows 16 mt.., cols 32 nh..),
                                       // gW0 (rows 16 (warp & 1).., cols
                                       // 16 (warp >> 1)..)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot1[i][q] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot0[i][q] = 0.f;
    float aW2[DA_MAX];                 // gW2[hs][.] over quarter mq
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) aW2[m] = 0.f;
    float gb0[2] = {0.f, 0.f}, gb1 = 0.f;
    float gb2[2] = {0.f, 0.f}, gls[2] = {0.f, 0.f};
    const float Bf = (float)T * (float)N;

    const int tiles_per_t = (N + TS - 1) / TS;
    const int n_tiles = T * tiles_per_t;
    const int G = gridDim.x;
    auto prefetch = [&](int tile, int slot) {
        if (tile < n_tiles)
            load_tile(smem + OFF_ST + slot * STAGE, obs, act, adv,
                      tile / tiles_per_t, (tile % tiles_per_t) * TS, DO, DA,
                      N, vec);
        cp_async_commit();
    };
    prefetch(blockIdx.x, 0);
    int slot = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += G, slot ^= 1) {
        const int t = tile / tiles_per_t, n0 = (tile % tiles_per_t) * TS;
        const int ns = min(TS, N - n0);
        cp_async_wait<0>();
        __syncthreads();        // tile staged; every warp done with the last
        prefetch(tile + G, slot ^ 1);
        const char* stage = smem + OFF_ST + slot * STAGE;
        const bf16* sX = reinterpret_cast<const bf16*>(stage);
        const bf16* sA = reinterpret_cast<const bf16*>(stage + ST_X);
        const float* sAdv = reinterpret_cast<const float*>(stage + ST_X + ST_A);

        {   // h0 = r(tanh(x W0 + b0)), h1 = r(tanh(h0 W1 + b1))
            float hi[4][4], ml[4][4];
            weight_product<XR / 16, true>(hi, ml, sW0, W0_PLANE, sX, 16 * mt,
                                     32 * nh, lane);
            tanh_epilogue(hi, ml, bias0, sH0, 16 * mt, 32 * nh, lane);
            __syncthreads();
            weight_product<H / 16, true>(hi, ml, sW1, W1_PLANE, sH0, 16 * mt,
                                    32 * nh, lane);
            tanh_epilogue(hi, ml, bias1, sH1, 16 * mt, 32 * nh, lane);
        }
        __syncthreads();
        {   // mu's partial sums over a quarter of the units: thread (sample
            // pair lane, outputs 4 (warp & 1)..+3, units 16 (warp >> 1)..)
            const int m0 = 4 * (warp & 1), kq = warp >> 1;
            float acc[2][4] = {};
#pragma unroll
            for (int k = 16 * kq; k < 16 * kq + 16; ++k) {
                const float2 h = unpack_bf16(
                    *reinterpret_cast<const uint32_t*>(sH1 + k * RS + 2 * lane));
                const float4 w =
                    *reinterpret_cast<const float4*>(sW2 + k * DA_MAX + m0);
                const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    acc[0][j] = fmaf(h.x, wv[j], acc[0][j]);
                    acc[1][j] = fmaf(h.y, wv[j], acc[1][j]);
                }
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<float2*>(sMuP + (kq * DA_MAX + m0 + j) * TS +
                                           2 * lane) =
                    make_float2(acc[0][j], acc[1][j]);
        }
        __syncthreads();
        {   // head, thread (sample hs, outputs mq and mq + 4): mu, z, u, the
            // bias and logstd sums
            const bool ok = hs < ns;
            const float av = sAdv[hs];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int m = mq + 4 * j;
                const float* pm = sMuP + m * TS + hs;
                const float mu = ((pm[0] + pm[DA_MAX * TS]) +
                                  (pm[2 * DA_MAX * TS] + pm[3 * DA_MAX * TS])) +
                                 sB2[m];
                float u = 0.f, z = 0.f;
                if (m < DA) {
                    const float diff = __bfloat162float(sA[m * TS + hs]) - mu;
                    z = diff * sInvSd[m];
                    if (ok) {
                        u = ((av * diff) * sInvVar[m]) / Bf;
                        gb2[j] += u;
                        gls[j] += av * (z * z - 1.f);
                        mu_out[((size_t)t * DA + m) * N + n0 + hs] = mu;
                    }
                }
                sU[m * TS + hs] = u;
                sZ[m * TS + hs] = z;
            }
        }
        __syncthreads();
        {   // thread (unit hs, samples 16 mq..): logp; gW2 = h1^T u;
            // g1 = r((u W2^T)(1 - h1^2)), gb1 = sum g1
            if (tid < TS && tid < ns) {
                float sz2 = 0.f;
                for (int m = 0; m < DA; ++m) {
                    const float z = sZ[m * TS + tid];
                    sz2 = (m == 0) ? z * z : sz2 + z * z;
                }
                logp_out[(size_t)t * N + n0 + tid] =
                    -0.5f * ((sz2 + sConst[0]) + sConst[1]);
            }
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
                const int s0 = 16 * mq + 8 * ch;
                const uint4 hv = *reinterpret_cast<const uint4*>(sH1 + hs * RS + s0);
                const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
                float h[8], v[8];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 f = unpack_bf16(hw[q]);
                    h[2 * q] = f.x;
                    h[2 * q + 1] = f.y;
                }
#pragma unroll
                for (int m = 0; m < DA_MAX; ++m) {
                    const float4 ua = *reinterpret_cast<const float4*>(sU + m * TS + s0);
                    const float4 ub =
                        *reinterpret_cast<const float4*>(sU + m * TS + s0 + 4);
                    const float u[8] = {ua.x, ua.y, ua.z, ua.w,
                                        ub.x, ub.y, ub.z, ub.w};
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        aW2[m] = fmaf(h[q], u[q], aW2[m]);
                        v[q] = m == 0 ? u[q] * w2r[0] : fmaf(u[q], w2r[m], v[q]);
                    }
                }
                uint32_t out[4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    // h is a bf16 value, so 1 - h h rounds once
                    const float g0v = bf16_round(v[2 * q] * (1.f - h[2 * q] * h[2 * q]));
                    const float g1v = bf16_round(v[2 * q + 1] *
                                                 (1.f - h[2 * q + 1] * h[2 * q + 1]));
                    gb1 += g0v;
                    gb1 += g1v;
                    out[q] = pack_bf16(g0v, g1v);
                }
                *reinterpret_cast<uint4*>(sG1 + hs * RS + s0) =
                    make_uint4(out[0], out[1], out[2], out[3]);
            }
        }
        __syncthreads();
        {   // g0 = r((W1 g1)(1 - h0^2)) into sG0, gb0 = sum g0
            float hi[4][4], ml[4][4];
            weight_product<H / 16, false>(hi, ml, sW1, W1_PLANE, sG1, 16 * mt,
                                          32 * nh, lane);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int off = (16 * mt + g + 8 * hf) * RS + 32 * nh + 8 * nt + 2 * c;
                    const float2 h = unpack_bf16(*reinterpret_cast<const uint32_t*>(sH0 + off));
                    const float v0 = bf16_round(
                        (hi[nt][2 * hf] + ml[nt][2 * hf]) * (1.f - h.x * h.x));
                    const float v1 = bf16_round(
                        (hi[nt][2 * hf + 1] + ml[nt][2 * hf + 1]) * (1.f - h.y * h.y));
                    gb0[hf] += v0;
                    gb0[hf] += v1;
                    *reinterpret_cast<uint32_t*>(sG0 + off) = pack_bf16(v0, v1);
                }
        }
        {   // gW1 += h0^T g1 (this tile's sums fresh, then into the totals)
            float fr[4][4];
            const int lr = lane & 15, lc = (lane >> 4) << 3;
#pragma unroll
            for (int ks = 0; ks < TS / 16; ++ks) {
                uint32_t a[4];
                ldmatrix_x4(a, sH0 + (16 * mt + lr) * RS + 16 * ks + lc);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    uint32_t b[4];
                    ldmatrix_x4(b, sG1 + (32 * nh + 16 * j + lr) * RS + 16 * ks + lc);
                    mma_bf16(fr[2 * j], a, b[0], b[2], ks == 0);
                    mma_bf16(fr[2 * j + 1], a, b[1], b[3], ks == 0);
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) tot1[i][q] += fr[i][q];
        }
        __syncthreads();
        {   // gW0 += x^T g0: warp (d rows 16 (warp & 1).., h cols 16 (warp >> 1)..)
            float fr[2][4];
            const int lr = lane & 15, lc = (lane >> 4) << 3;
            const int d0 = 16 * (warp & 1), h0 = 16 * (warp >> 1);
#pragma unroll
            for (int ks = 0; ks < TS / 16; ++ks) {
                uint32_t a[4], b[4];
                ldmatrix_x4(a, sX + (d0 + lr) * RS + 16 * ks + lc);
                ldmatrix_x4(b, sG0 + (h0 + lr) * RS + 16 * ks + lc);
                mma_bf16(fr[0], a, b[0], b[2], ks == 0);
                mma_bf16(fr[1], a, b[1], b[3], ks == 0);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) tot0[i][q] += fr[i][q];
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    // the block's partial: gW1 and gW0 straight from the fragments, the
    // rest through shared scratch (over the activations), summed in a
    // fixed order
    float* out = partial + (size_t)blockIdx.x * P;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int h = 16 * mt + g + 8 * hf, o = 32 * nh + 8 * nt + 2 * c;
            out[oW1 + h * H + o] = tot1[nt][2 * hf];
            out[oW1 + h * H + o + 1] = tot1[nt][2 * hf + 1];
        }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int d = 16 * (warp & 1) + g + 8 * hf;
            const int h = 16 * (warp >> 1) + 8 * j + 2 * c;
            if (d < DO) {
                out[d * H + h] = tot0[j][2 * hf];
                out[d * H + h + 1] = tot0[j][2 * hf + 1];
            }
        }
    float* rW2 = reinterpret_cast<float*>(smem + OFF_H0);  // [mq][k][m]
    float* rB1 = rW2 + 4 * H * DA_MAX;                      // [mq][k]
    float* rB0 = rB1 + 4 * H;                               // [nh][h]
    float* rB2 = rB0 + 2 * H;                               // [m][s]
    float* rLS = rB2 + DA_MAX * TS;                         // [m][s]
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) rW2[(mq * H + hs) * DA_MAX + m] = aW2[m];
    rB1[mq * H + hs] = gb1;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        float v = gb0[hf];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (c == 0) rB0[nh * H + 16 * mt + g + 8 * hf] = v;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        rB2[(mq + 4 * j) * TS + hs] = gb2[j];
        rLS[(mq + 4 * j) * TS + hs] = gls[j];
    }
    __syncthreads();
    for (int e = tid; e < H * DA; e += NT) {
        const int k = e / DA, m = e % DA;
        float s = rW2[k * DA_MAX + m];
        for (int q = 1; q < 4; ++q) s += rW2[(q * H + k) * DA_MAX + m];
        out[oW2 + e] = s;
    }
    if (tid < H) {
        float s = rB1[tid];
        for (int q = 1; q < 4; ++q) s += rB1[q * H + tid];
        out[ob1 + tid] = s;
        out[ob0 + tid] = rB0[tid] + rB0[H + tid];
    }
    if (tid < DA) {
        float s2 = 0.f, sl = 0.f;
        for (int s = 0; s < TS; ++s) {
            s2 += rB2[tid * TS + s];
            sl += rLS[tid * TS + s];
        }
        out[ob2 + tid] = s2;
        out[ols + tid] = sl;
    }
}

// ------------------------------------------------------------------ reduce

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

}  // namespace

// obs (T, do, N) and act (T, da, N) in bf16 when bf16_mode != 0, else fp32;
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
                              int n_blocks, int bf16_mode, void* stream) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bf16_mode) {
        err = cudaFuncSetAttribute(pg_partial_tc_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   TC_SMEM);
        if (err != cudaSuccess) return (int)err;
        const bool aligned = ((uintptr_t)obs | (uintptr_t)act |
                              (uintptr_t)adv) % 16 == 0;
        pg_partial_tc_kernel<<<n_blocks, NT, TC_SMEM, st>>>(
            static_cast<const __nv_bfloat16*>(obs),
            static_cast<const __nv_bfloat16*>(act), adv, W0, b0, W1, b1, W2,
            b2, logstd, mu, logp, partial, T, DO, DA, N,
            (int)(aligned && N % 8 == 0));
    } else {
        const size_t smem = (size_t)smem_floats(DO, DA) * sizeof(float);
        err = cudaFuncSetAttribute(pg_partial_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        pg_partial_kernel<<<n_blocks, NT, smem, st>>>(
            static_cast<const float*>(obs), static_cast<const float*>(act),
            adv, W0, b0, W1, b1, W2, b2, logstd, mu, logp, partial, T, DO,
            DA, N);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int P = DO * H + H * H + H * DA + 2 * H + 2 * DA;
    pg_reduce_kernel<<<(P + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, g, n_blocks, P, P - DA, (float)T * (float)N);
    return (int)cudaGetLastError();
}
