// Surrogate-gradient pass at theta_old for the tanh policy of 1-3 hidden
// layers of 1-64 units (policy_shape.cuh; (64, 64) at c3-c5), over the
// feature-first batch as the rollout stores it.
//
// Replaces `pallas_surrogate_grad_ff` / `_pg_kernel` in
// trpo_robot_control_tpu/ops/pallas/pg_kernel.py. At theta_old the
// importance ratio is 1, so the gradient has a closed form. Per sample,
// with L hidden layers (h_-1 = x, W_L the head; at L = 2):
//   forward   h_l = r(tanh(h_{l-1} W_l + b_l)): h0 = r(tanh(x W0 + b0)),
//             h1 = r(tanh(h0 W1 + b1)),
//             mu = h1 W2 + b2, z = (a - mu) e^-logstd,
//             logp = -(sum z^2 + 2 sum logstd + da log 2pi) / 2
//   cotangent u = adv (a - mu) e^-2logstd / B         (fp32)
//   reverse   gW_L = h_{L-1}^T u, g_{L-1} = r((u W_L^T)(1 - h_{L-1}^2)),
//             then per layer gW_l = h_{l-1}^T g_l,
//             g_{l-1} = r((g_l W_l^T)(1 - h_{l-1}^2)): gW2 = h1^T u,
//             g1 = r((u W2^T)(1 - h1^2)), gW1 = h0^T g1,
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
// written (0.41 ms at 3.35 TB/s). Its hidden layers' products (six at
// (64, 64)) run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate), every width padded to the tile's 16 with zero weights
// (a padded unit's h and g are exact zeros, as are its products), and
// every product stays exact:
// - x, every h_l and every g_l are bf16 values (stored, or rounded at
//   r());
// - each fp32 weight is split in the block's prologue into three bf16
//   planes, w = hi + mid + lo (hi = bf16(w), mid = bf16(w - hi),
//   lo = bf16(w - hi - mid): three 8-bit significands hold fp32's 24, and
//   bf16 has fp32's exponent range), so x W0, h_{l-1} W_l and g_l W_l^T
//   are each the sum of three exact mma products. The hi plane sums into
//   its own accumulator and mid + lo into a second, added in fp32 at the
//   end, so the truncating tensor-core sums see the large terms only once
//   per k-step;
// - gW_l = h_{l-1}^T g_l and gW0 = x^T g0 have two bf16 operands: one mma
//   each, summed per tile in fresh accumulators and added in fp32 to running
//   totals (the two-level sum of moments.cu).
// Hidden units are the mma's M, samples its N, features its K. A tile is
// one time step and TS = 64 envs, staged by a two-stage cp.async ring
// (x rows, actions, advantages); the activations go to shared memory
// feature-first, rounded to bf16, as the next product's operand. One
// weight copy [in][out] serves both directions: ldmatrix.trans reads it
// as W^T for the forward, plain ldmatrix as W for g1 W1^T. The da-wide
// head (mu, u, gW2, u W2^T, z, logp) has fp32 operands on both sides and
// runs on the CUDA cores in fp32, spread over the whole block; the bias
// sums ride in the registers of the threads that form each g_l. Every
// layer's weight planes and activations stay in shared memory, the
// activations in one buffer a layer: g_{L-1} takes a buffer of its own,
// g_{l-1} the buffer of h_l, dead once g_l is formed. At (64, 64, 64) the
// block takes 124 KB, so one block fits an SM instead of two. tanhf is
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
#include "policy_shape.cuh"

namespace {

using policy_shape::Flat;
using policy_shape::Hidden;
using policy_shape::NL;
// the packed forms only, as the TPU kernel takes them (build.MAX_WIDTH)
static_assert(Hidden::widest() <= policy_shape::PACKED_MAX,
              "hidden widths up to 64 (ROADMAP B3 for more)");
using policy_shape::Weights;
using policy_shape::flat;
using policy_shape::in_width;
using policy_shape::padded;

constexpr int NT = 256;        // threads per block
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int RED_OUT = 32;
constexpr int RED_GROUPS = NT / RED_OUT;
constexpr float LOG2PI = 1.8378770664093453f;
constexpr int HL = Hidden::width(NL - 1);      // the head's inputs

// ---------------------------------------------------------------- fp32 mode

constexpr int S = 64;          // samples per tile
constexpr int HP = Hidden::widest() + 1;       // cotangent row stride

// row strides in shared memory of hidden layer l's weights (padded by one
// word past layer 0) and of its activations
__host__ __device__ constexpr int w_stride(int l) {
    return l == 0 ? Hidden::width(0) : Hidden::width(l) + 1;
}
__host__ __device__ constexpr int h_stride(int l) {
    return Hidden::width(l) + 1;
}
// weight-gradient entries a thread keeps in registers of W_l (l = NL the
// head), entry tid + NT r, and where they start in its register array
__host__ __device__ constexpr int regs(int l) {
    return ((l == 0 ? DO_MAX : Hidden::width(l - 1))
            * (l == NL ? DA_MAX : Hidden::width(l)) + NT - 1) / NT;
}
__host__ __device__ constexpr int reg_off(int l) {
    int o = 0;
    for (int m = 0; m < l; ++m) o += regs(m);
    return o;
}

__host__ __device__ inline int smem_floats(int DO, int DA) {
    int n = HL * DA + 4 * DA + 1 + S * (DO + 1) + 2 * S * DA + S
            + 2 * S * HP;
    for (int l = 0; l < NL; ++l)
        n += in_width(l, DO) * w_stride(l) + Hidden::width(l)
             + S * h_stride(l);
    return n;
}

// fp32 mode's shared memory, carved in order
struct Fp32Smem {
    float *W[3], *Wh, *b[3], *b2, *inv_sd, *inv_var, *cnst, *X, *A, *Adv,
        *U, *H[3], *T[2];
};
__device__ __forceinline__ Fp32Smem fp32_smem(float* sm, int DO, int DA) {
    Fp32Smem m;
    float* q = sm;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        m.W[l] = q;                    // (in, out), row stride w_stride
        q += in_width(l, DO) * w_stride(l);
    }
    m.Wh = q;                          // (HL, DA)
    q += HL * DA;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        m.b[l] = q;
        q += Hidden::width(l);
    }
    m.b2 = q;
    m.inv_sd = m.b2 + DA;              // e^-logstd
    m.inv_var = m.inv_sd + DA;         // e^-2 logstd
    m.cnst = m.inv_var + DA;           // 2 sum logstd (then da log 2pi)
    m.X = m.cnst + DA + 1;             // (S, DO + 1)
    m.A = m.X + S * (DO + 1);          // (S, DA) actions
    m.Adv = m.A + S * DA;              // (S)
    m.U = m.Adv + S;                   // (S, DA) output cotangent
    q = m.U + S * DA;
#pragma unroll
    for (int l = 0; l < NL; ++l) {
        m.H[l] = q;                    // (S, h_stride)
        q += S * h_stride(l);
    }
    m.T[0] = q;                        // cotangents g_l, l even, (S, HP)
    m.T[1] = q + S * HP;               // and odd
    return m;
}

// h_l = tanh(h_{l-1} W_l + b_l) on the tile (h_-1 = x)
template <int l>
__device__ __forceinline__ void fp32_forward(const Fp32Smem& m, int DO,
                                             int tid) {
    constexpr int W = Hidden::width(l), HS = h_stride(l), WS = w_stride(l);
    const float* in = l == 0 ? m.X : m.H[l > 0 ? l - 1 : 0];
    const int IS = l == 0 ? DO + 1 : h_stride(l > 0 ? l - 1 : 0);
    for (int i = tid; i < S * W; i += NT) {
        const int s = i / W, c = i % W;
        float a = 0.f;
        if constexpr (l == 0) {
            for (int d = 0; d < DO; ++d)
                a = fmaf(in[s * IS + d], m.W[0][d * WS + c], a);
        } else {
#pragma unroll 8
            for (int k = 0; k < Hidden::width(l - 1); ++k)
                a = fmaf(in[s * IS + k], m.W[l][k * WS + c], a);
        }
        m.H[l][s * HS + c] = tanhf(a + m.b[l][c]);
    }
}

// gW_l += h_{l-1}^T g_l, gb_l += sum g_l, g_{l-1} = (g_l W_l^T)(1 - h_{l-1}^2)
template <int l>
__device__ __forceinline__ void fp32_backward(const Fp32Smem& m, float* aW,
                                              float& ab, int tid) {
    constexpr int W = Hidden::width(l), IN = Hidden::width(l - 1);
    constexpr int HI = h_stride(l - 1), WS = w_stride(l);
    const float* g = m.T[l % 2];
    float* gn = m.T[(l - 1) % 2];
    for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int r = 0; r < regs(l); ++r) {
            const int e = tid + r * NT;
            if (e < IN * W)
                aW[reg_off(l) + r] = fmaf(m.H[l - 1][s * HI + e / W],
                                          g[s * HP + e % W],
                                          aW[reg_off(l) + r]);
        }
    }
    if (tid < W)
        for (int s = 0; s < S; ++s) ab += g[s * HP + tid];
    for (int i = tid; i < S * IN; i += NT) {
        const int s = i / IN, k = i % IN;
        float a = 0.f;
#pragma unroll 8
        for (int c = 0; c < W; ++c)
            a = fmaf(g[s * HP + c], m.W[l][k * WS + c], a);
        const float h = m.H[l - 1][s * HI + k];
        gn[s * HP + k] = a * (1.f - h * h);
    }
}

// DEPTH = NL: a template, so that the layers past NL are never built
template <int DEPTH>
__global__ void __launch_bounds__(NT) pg_partial_kernel(
    const float* __restrict__ obs, const float* __restrict__ act,
    const float* __restrict__ adv, Weights p, float* __restrict__ mu_out,
    float* __restrict__ logp_out, float* __restrict__ partial, int T, int DO,
    int DA, int N) {
    extern __shared__ float sm[];
    const Fp32Smem m = fp32_smem(sm, DO, DA);
    const int XS = DO + 1;             // padded sample stride of the x tile
    constexpr int HLS = h_stride(DEPTH - 1);
    const float* sHL = m.H[DEPTH - 1];

    const Flat f = flat(DO, DA);
    const int tid = threadIdx.x;
#pragma unroll
    for (int l = 0; l < DEPTH; ++l) {
        const int IN = in_width(l, DO), W = Hidden::width(l);
        const int WS = w_stride(l);
        for (int i = tid; i < IN * W; i += NT)
            m.W[l][(i / W) * WS + i % W] = p.W[l][i];
        for (int i = tid; i < W; i += NT) m.b[l][i] = p.b[l][i];
    }
    for (int i = tid; i < HL * DA; i += NT) m.Wh[i] = p.W[DEPTH][i];
    if (tid < DA) {
        m.b2[tid] = p.b[DEPTH][tid];
        m.inv_sd[tid] = expf(-p.logstd[tid]);
        m.inv_var[tid] = expf(-2.f * p.logstd[tid]);
    }
    if (tid == 0) {
        float sl = p.logstd[0];
        for (int k = 1; k < DA; ++k) sl += p.logstd[k];
        m.cnst[0] = 2.f * sl;
        m.cnst[1] = (float)DA * LOG2PI;
    }
    constexpr int RTOT = reg_off(DEPTH + 1);
    float aW[RTOT];
#pragma unroll
    for (int r = 0; r < RTOT; ++r) aW[r] = 0.f;
    float ab[DEPTH + 1];               // bias sums; ab[DEPTH] the head's
#pragma unroll
    for (int l = 0; l <= DEPTH; ++l) ab[l] = 0.f;
    float als = 0.f;
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
            m.X[j * XS + d] =
                (j < ns) ? obs[((size_t)t * DO + d) * N + n0 + j] : 0.f;
        }
        for (int i = tid; i < DA * S; i += NT) {
            const int k = i / S, j = i % S;
            m.A[j * DA + k] =
                (j < ns) ? act[((size_t)t * DA + k) * N + n0 + j] : 0.f;
        }
        for (int j = tid; j < S; j += NT)
            m.Adv[j] = (j < ns) ? adv[(size_t)t * N + n0 + j] : 0.f;
        __syncthreads();
        fp32_forward<0>(m, DO, tid);
        __syncthreads();
        if constexpr (DEPTH > 1) {
            fp32_forward<1>(m, DO, tid);
            __syncthreads();
        }
        if constexpr (DEPTH > 2) {
            fp32_forward<2>(m, DO, tid);
            __syncthreads();
        }
        // head: mu, logp, the cotangent u and the logstd integrand
        if (tid < S) {
            const int s = tid;
            const bool ok = s < ns;
            const float av = m.Adv[s];
            float sz2 = 0.f;
            for (int k = 0; k < DA; ++k) {
                float mu = 0.f;
                for (int j = 0; j < HL; ++j)
                    mu = fmaf(sHL[s * HLS + j], m.Wh[j * DA + k], mu);
                mu += m.b2[k];
                const float diff = m.A[s * DA + k] - mu;
                const float z = diff * m.inv_sd[k];
                sz2 = (k == 0) ? z * z : sz2 + z * z;
                m.U[s * DA + k] = ok ? ((av * diff) * m.inv_var[k]) / Bf : 0.f;
                // logstd integrand adv (z^2 - 1), parked in T[0] until the
                // column sums below have read it
                m.T[0][s * HP + k] = ok ? av * (z * z - 1.f) : 0.f;
                if (ok) mu_out[((size_t)t * DA + k) * N + n0 + s] = mu;
            }
            if (ok)
                logp_out[(size_t)t * N + n0 + s] =
                    -0.5f * ((sz2 + m.cnst[0]) + m.cnst[1]);
        }
        __syncthreads();
        // gW_L = h_{L-1}^T u, gb_L = sum u, glogstd += sum adv (z^2 - 1)
#pragma unroll
        for (int r = 0; r < regs(DEPTH); ++r) {
            const int e = tid + r * NT;
            if (e < HL * DA) {
                const int k = e / DA, j = e % DA;
                float acc = aW[reg_off(DEPTH) + r];
                for (int s = 0; s < S; ++s)
                    acc = fmaf(sHL[s * HLS + k], m.U[s * DA + j], acc);
                aW[reg_off(DEPTH) + r] = acc;
            }
        }
        if (tid < DA) {
            for (int s = 0; s < S; ++s) ab[DEPTH] += m.U[s * DA + tid];
        } else if (tid >= 32 && tid < 32 + DA) {
            for (int s = 0; s < S; ++s) als += m.T[0][s * HP + tid - 32];
        }
        __syncthreads();
        // g_{L-1} = (u W_L^T)(1 - h_{L-1}^2)
        for (int i = tid; i < S * HL; i += NT) {
            const int s = i / HL, k = i % HL;
            float g = 0.f;
            for (int j = 0; j < DA; ++j)
                g = fmaf(m.U[s * DA + j], m.Wh[k * DA + j], g);
            const float h = sHL[s * HLS + k];
            m.T[(DEPTH - 1) % 2][s * HP + k] = g * (1.f - h * h);
        }
        __syncthreads();
        if constexpr (DEPTH > 2) {
            fp32_backward<2>(m, aW, ab[2], tid);
            __syncthreads();
        }
        if constexpr (DEPTH > 1) {
            fp32_backward<1>(m, aW, ab[1], tid);
            __syncthreads();
        }
        // gW0 = x^T g0, gb0 = sum g0
        {
            constexpr int W = Hidden::width(0);
            for (int s = 0; s < S; ++s) {
#pragma unroll
                for (int r = 0; r < regs(0); ++r) {
                    const int e = tid + r * NT;
                    if (e < DO * W)
                        aW[r] = fmaf(m.X[s * XS + e / W],
                                     m.T[0][s * HP + e % W], aW[r]);
                }
            }
            if (tid < W)
                for (int s = 0; s < S; ++s) ab[0] += m.T[0][s * HP + tid];
        }
    }

    float* out = partial + (size_t)blockIdx.x * f.P;
#pragma unroll
    for (int l = 0; l <= DEPTH; ++l) {
        const int n = in_width(l, DO) * policy_shape::out_width(l, DA);
#pragma unroll
        for (int r = 0; r < regs(l); ++r) {
            const int e = tid + r * NT;
            if (e < n) out[f.W[l] + e] = aW[reg_off(l) + r];
        }
        const int nb = policy_shape::out_width(l, DA);
        if (tid < nb) out[f.b[l] + tid] = ab[l];
    }
    if (tid >= 32 && tid < 32 + DA) out[f.ls + tid - 32] = als;
}

// ---------------------------------------------------------------- bf16 mode

using bf16 = __nv_bfloat16;

constexpr int TS = 64;                  // samples (envs of one step) per tile
constexpr int RS = TS + 8;              // bf16 row stride: 144 B, so the 8
                                        // rows of an ldmatrix hit distinct
                                        // 16-byte bank groups
constexpr int XR = DO_MAX;              // x rows: layer 0's K, gW0's M
constexpr int PLANES = 3;               // hi, mid, lo
constexpr int HMP = (Hidden::widest() + 15) / 16 * 16;   // widest, padded
constexpr int HLP = padded(NL - 1);     // the head's inputs, padded

// layer l's padded K (its weights' rows) and the bf16 elements a plane of
// its weights takes
__host__ __device__ constexpr int kp(int l) {
    return l == 0 ? XR : padded(l - 1);
}
__host__ __device__ constexpr int w_plane(int l) { return kp(l) * RS; }

// shared memory, byte offsets
__host__ __device__ constexpr int off_w(int l) {   // 3 x (kp, RS) [in][out]
    int o = 0;
    for (int m = 0; m < l; ++m) o += PLANES * w_plane(m) * 2;
    return o;
}
constexpr int ST_X = XR * RS * 2;                      // stage: x [d][s]
constexpr int ST_A = DA_MAX * TS * 2;                  //   actions [m][s]
constexpr int STAGE = ST_X + ST_A + TS * 4;            //   advantages [s]
constexpr int OFF_ST = off_w(NL);                      // 2 stages
constexpr int ACT = HMP * RS * 2;                      // (HMP, RS)
constexpr int OFF_H0 = OFF_ST + 2 * STAGE;             // h_l at + l ACT
constexpr int OFF_G = OFF_H0 + NL * ACT;               // g_{L-1} [o][s]
constexpr int MUP = 4 * DA_MAX * TS * 4;               // mu's partial sums
constexpr int GBUF = ACT > MUP ? ACT : MUP;
// the block's end-of-run scratch over the activations: the head's
// gradient [4][64][DA_MAX], the last layer's bias sums [4][64], the other
// layers' [L - 1][2][64], gb2's and glogstd's [DA_MAX][TS]
constexpr int SCRATCH =
    (4 * 64 * DA_MAX + 4 * 64 + 2 * 64 * (NL - 1) + 2 * DA_MAX * TS) * 4;
constexpr int ACTS = NL * ACT + GBUF > SCRATCH ? NL * ACT + GBUF : SCRATCH;
constexpr int OFF_U = OFF_H0 + ACTS;                   // u [m][s] fp32
constexpr int OFF_Z = OFF_U + DA_MAX * TS * 4;         // z [m][s] fp32
constexpr int OFF_W2 = OFF_Z + DA_MAX * TS * 4;        // W_L [k][m] fp32
constexpr int OFF_C = OFF_W2 + 64 * DA_MAX * 4;        // b2, e^-ls, e^-2ls, 2
constexpr int TC_SMEM = OFF_C + (3 * DA_MAX + 2) * 4;
static_assert(STAGE % 16 == 0 && OFF_ST % 16 == 0 && OFF_U % 16 == 0,
              "cp.async and ldmatrix need 16-byte aligned rows");
static_assert(TC_SMEM <= 232448, "one block's shared memory");
// blocks an SM holds (1 KB of its 228 KB kept per block): two, as at
// (64, 64), or one at (64, 64, 64)
constexpr int TC_BLOCKS = 2 * (TC_SMEM + 1024) <= 233472 ? 2 : 1;

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

// TC mode's buffers: hidden layer l's weight planes and activations (h_l,
// then g_{l-1}); G holds g_{L-1}
__device__ __forceinline__ bf16* w_planes(char* smem, int l) {
    return reinterpret_cast<bf16*>(smem + off_w(l));
}
__device__ __forceinline__ bf16* act_buf(char* smem, int l) {
    return reinterpret_cast<bf16*>(smem + OFF_H0 + l * ACT);
}

// Hidden layer l's weights as three bf16 planes [in][out] (rows past the
// input width and columns past the output width zero)
template <int l>
__device__ __forceinline__ void split_layer(const Weights& p, char* smem,
                                            int DO, int tid) {
    constexpr int K = kp(l), M = padded(l), W = Hidden::width(l);
    const int IN = in_width(l, DO);
    bf16* sW = w_planes(smem, l);
    for (int i = tid; i < K * M; i += NT) {
        const int k = i / M, o = i % M;
        bf16 q[PLANES];
        split3(k < IN && o < W ? p.W[l][k * W + o] : 0.f, q[0], q[1], q[2]);
#pragma unroll
        for (int j = 0; j < PLANES; ++j) sW[j * w_plane(l) + k * RS + o] = q[j];
    }
}

// h_l = r(tanh(h_{l-1} W_l + b_l)) (h_-1 = x): warp (rows 16 mt..,
// samples 32 nh..), the warps past the padded width idle
template <int l>
__device__ __forceinline__ void forward_layer(char* smem, const bf16* sX,
                                              const float (&bias)[2], int mt,
                                              int nh, int lane) {
    if (padded(l) == 64 || 16 * mt < padded(l)) {
        float hi[4][4], ml[4][4];
        weight_product<kp(l) / 16, true>(
            hi, ml, w_planes(smem, l), w_plane(l),
            l == 0 ? sX : act_buf(smem, l > 0 ? l - 1 : 0), 16 * mt, 32 * nh,
            lane);
        tanh_epilogue(hi, ml, bias, act_buf(smem, l), 16 * mt, 32 * nh, lane);
    }
}

// Layer l > 0 of the reverse pass: g_{l-1} = r((W_l g_l)(1 - h_{l-1}^2))
// over h_l's buffer, gb += g_{l-1}; tot += h_{l-1}^T g_l (this tile's sums
// fresh, then into the totals). g_l lies in h_{l+1}'s buffer, or in G at
// l = L - 1.
template <int l>
__device__ __forceinline__ void backward_layer(char* smem,
                                               float (&tot)[4][4],
                                               float (&gb)[2], int mt, int nh,
                                               int lane) {
    constexpr int MP = padded(l - 1), KP = padded(l);
    const bf16* gl = l == NL - 1
                         ? reinterpret_cast<const bf16*>(smem + OFF_G)
                         : act_buf(smem, l + 1 < NL ? l + 1 : 0);
    bf16* gn = act_buf(smem, l);
    const bf16* hp = act_buf(smem, l - 1);
    if (MP == 64 || 16 * mt < MP) {
        const int g = lane >> 2, c = lane & 3;
        {
            float hi[4][4], ml[4][4];
            weight_product<KP / 16, false>(hi, ml, w_planes(smem, l),
                                           w_plane(l), gl, 16 * mt, 32 * nh,
                                           lane);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int off =
                        (16 * mt + g + 8 * hf) * RS + 32 * nh + 8 * nt + 2 * c;
                    const float2 h = unpack_bf16(
                        *reinterpret_cast<const uint32_t*>(hp + off));
                    const float v0 = bf16_round(
                        (hi[nt][2 * hf] + ml[nt][2 * hf]) * (1.f - h.x * h.x));
                    const float v1 =
                        bf16_round((hi[nt][2 * hf + 1] + ml[nt][2 * hf + 1]) *
                                   (1.f - h.y * h.y));
                    gb[hf] += v0;
                    gb[hf] += v1;
                    *reinterpret_cast<uint32_t*>(gn + off) = pack_bf16(v0, v1);
                }
        }
        {
            float fr[4][4];
            const int lr = lane & 15, lc = (lane >> 4) << 3;
#pragma unroll
            for (int ks = 0; ks < TS / 16; ++ks) {
                uint32_t a[4];
                ldmatrix_x4(a, hp + (16 * mt + lr) * RS + 16 * ks + lc);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    if (KP == 64 || 32 * nh + 16 * j < KP) {
                        uint32_t b[4];
                        ldmatrix_x4(b, gl + (32 * nh + 16 * j + lr) * RS +
                                           16 * ks + lc);
                        mma_bf16(fr[2 * j], a, b[0], b[2], ks == 0);
                        mma_bf16(fr[2 * j + 1], a, b[1], b[3], ks == 0);
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < 2; ++j)
                if (KP == 64 || 32 * nh + 16 * j < KP)
#pragma unroll
                    for (int i = 2 * j; i < 2 * j + 2; ++i)
#pragma unroll
                        for (int q = 0; q < 4; ++q) tot[i][q] += fr[i][q];
        }
    }
}

// gW_l (l > 0) of the block's partial, straight from the fragments
template <int l>
__device__ __forceinline__ void write_tot(float* out, const Flat& f,
                                          const float (&tot)[4][4], int mt,
                                          int nh, int lane) {
    constexpr int IN = Hidden::width(l - 1), W = Hidden::width(l);
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int h = 16 * mt + g + 8 * hf, o = 32 * nh + 8 * nt + 2 * c;
            if (h < IN) {
                if (o < W) out[f.W[l] + h * W + o] = tot[nt][2 * hf];
                if (o + 1 < W) out[f.W[l] + h * W + o + 1] = tot[nt][2 * hf + 1];
            }
        }
}

// DEPTH = NL: a template, so that the layers past NL are never built
template <int DEPTH>
__global__ void __launch_bounds__(NT, TC_BLOCKS) pg_partial_tc_kernel(
    const bf16* __restrict__ obs, const bf16* __restrict__ act,
    const float* __restrict__ adv, Weights p, float* __restrict__ mu_out,
    float* __restrict__ logp_out, float* __restrict__ partial, int T, int DO,
    int DA, int N, int vec) {
    extern __shared__ __align__(16) char smem[];
    const bf16* sHL = act_buf(smem, DEPTH - 1);      // h_{L-1}
    bf16* sG = reinterpret_cast<bf16*>(smem + OFF_G);  // g_{L-1}
    // g0, for gW0
    const bf16* sG0 = DEPTH == 1 ? sG : act_buf(smem, 1);
    // mu's partial sums [quarter][m][s], over G (dead from the last tile's
    // use of g_{L-1} to this tile's)
    float* sMuP = reinterpret_cast<float*>(smem + OFF_G);
    float* sU = reinterpret_cast<float*>(smem + OFF_U);
    float* sZ = reinterpret_cast<float*>(smem + OFF_Z);
    float* sW2 = reinterpret_cast<float*>(smem + OFF_W2);
    float* sB2 = reinterpret_cast<float*>(smem + OFF_C);
    float* sInvSd = sB2 + DA_MAX;
    float* sInvVar = sInvSd + DA_MAX;
    float* sConst = sInvVar + DA_MAX;

    const Flat f = flat(DO, DA);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    // mma roles: hidden rows 16 mt.., samples 32 nh.. (gW_l: cols 32 nh..)
    const int mt = warp & 3, nh = warp >> 2;
    // CUDA-core roles: (sample s, output pair mq) and (unit k, quarter sq)
    const int hs = tid & 63, mq = tid >> 6;

    // prologue: the hidden layers' weights as three bf16 planes; the x rows
    // past DO of both stages are zero (layer 0's K is XR)
    split_layer<0>(p, smem, DO, tid);
    if constexpr (DEPTH > 1) split_layer<1>(p, smem, DO, tid);
    if constexpr (DEPTH > 2) split_layer<2>(p, smem, DO, tid);
    for (int i = tid; i < 2 * (XR - DO) * RS; i += NT) {
        const int st = i / ((XR - DO) * RS), r = i % ((XR - DO) * RS);
        reinterpret_cast<bf16*>(smem + OFF_ST + st * STAGE)[DO * RS + r] =
            __float2bfloat16_rn(0.f);
    }
    for (int i = tid; i < 64 * DA_MAX; i += NT) {    // W_L, padded
        const int k = i / DA_MAX, m = i % DA_MAX;
        sW2[i] = m < DA && k < HL ? p.W[DEPTH][k * DA + m] : 0.f;
    }
    if (tid < DA_MAX) {
        const bool ok = tid < DA;
        sB2[tid] = ok ? p.b[DEPTH][tid] : 0.f;
        sInvSd[tid] = ok ? expf(-p.logstd[tid]) : 0.f;
        sInvVar[tid] = ok ? expf(-2.f * p.logstd[tid]) : 0.f;
    }
    if (tid == 0) {
        float sl = p.logstd[0];
        for (int m = 1; m < DA; ++m) sl += p.logstd[m];
        sConst[0] = 2.f * sl;
        sConst[1] = (float)DA * LOG2PI;
    }
    float w2r[DA_MAX];                 // W_L[hs][.], for u W_L^T
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m)
        w2r[m] = m < DA && hs < HL ? p.W[DEPTH][hs * DA + m] : 0.f;
    float bias[DEPTH][2];              // b_l at rows 16 mt + g (+ 8)
#pragma unroll
    for (int l = 0; l < DEPTH; ++l)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = 16 * mt + g + 8 * hf;
            bias[l][hf] = r < Hidden::width(l) ? p.b[l][r] : 0.f;
        }

    // gW_l, l = 1..L-1 (rows 16 mt.., cols 32 nh..), gW0 (rows 16 (warp &
    // 1).., cols 16 (warp >> 1)..)
    float tot[DEPTH > 1 ? DEPTH - 1 : 1][4][4], tot0[2][4];
#pragma unroll
    for (int l = 0; l < (DEPTH > 1 ? DEPTH - 1 : 1); ++l)
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) tot[l][i][q] = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot0[i][q] = 0.f;
    float aW2[DA_MAX];                 // gW_L[hs][.] over quarter mq
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) aW2[m] = 0.f;
    // bias sums: layers 0..L-2 in the mma layout (rows 16 mt + g (+ 8)),
    // layer L-1 by unit hs
    float gbm[DEPTH > 1 ? DEPTH - 1 : 1][2], gbl = 0.f;
#pragma unroll
    for (int l = 0; l < (DEPTH > 1 ? DEPTH - 1 : 1); ++l)
        gbm[l][0] = gbm[l][1] = 0.f;
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

        // h_l = r(tanh(h_{l-1} W_l + b_l)), layer by layer
        forward_layer<0>(smem, sX, bias[0], mt, nh, lane);
        if constexpr (DEPTH > 1) {
            __syncthreads();
            forward_layer<1>(smem, sX, bias[1], mt, nh, lane);
        }
        if constexpr (DEPTH > 2) {
            __syncthreads();
            forward_layer<2>(smem, sX, bias[2], mt, nh, lane);
        }
        __syncthreads();
        {   // mu's partial sums over a quarter of the units: thread (sample
            // pair lane, outputs 4 (warp & 1)..+3, units 16 (warp >> 1)..)
            const int m0 = 4 * (warp & 1), kq = warp >> 1;
            float acc[2][4] = {};
            if (HLP == 64 || 16 * kq < HLP) {
#pragma unroll
                for (int k = 16 * kq; k < 16 * kq + 16; ++k) {
                    const float2 h = unpack_bf16(*reinterpret_cast<const uint32_t*>(
                        sHL + k * RS + 2 * lane));
                    const float4 w =
                        *reinterpret_cast<const float4*>(sW2 + k * DA_MAX + m0);
                    const float wv[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
                    for (int j = 0; j < 4; ++j) {
                        acc[0][j] = fmaf(h.x, wv[j], acc[0][j]);
                        acc[1][j] = fmaf(h.y, wv[j], acc[1][j]);
                    }
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
        {   // thread (unit hs, samples 16 mq..): logp; gW_L = h_{L-1}^T u;
            // g_{L-1} = r((u W_L^T)(1 - h_{L-1}^2)), its bias sum
            if (tid < TS && tid < ns) {
                float sz2 = 0.f;
                for (int m = 0; m < DA; ++m) {
                    const float z = sZ[m * TS + tid];
                    sz2 = (m == 0) ? z * z : sz2 + z * z;
                }
                logp_out[(size_t)t * N + n0 + tid] =
                    -0.5f * ((sz2 + sConst[0]) + sConst[1]);
            }
            if (HLP == 64 || hs < HLP) {   // the padded last layer's units
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
                const int s0 = 16 * mq + 8 * ch;
                const uint4 hv = *reinterpret_cast<const uint4*>(sHL + hs * RS + s0);
                const uint32_t hw[4] = {hv.x, hv.y, hv.z, hv.w};
                float h[8], v[8];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float2 f2 = unpack_bf16(hw[q]);
                    h[2 * q] = f2.x;
                    h[2 * q + 1] = f2.y;
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
                    gbl += g0v;
                    gbl += g1v;
                    out[q] = pack_bf16(g0v, g1v);
                }
                *reinterpret_cast<uint4*>(sG + hs * RS + s0) =
                    make_uint4(out[0], out[1], out[2], out[3]);
            }
            }
        }
        __syncthreads();
        // g_{l-1} and gW_l, layer by layer down
        if constexpr (DEPTH > 2) {
            backward_layer<2>(smem, tot[1], gbm[1], mt, nh, lane);
            __syncthreads();
        }
        if constexpr (DEPTH > 1) {
            backward_layer<1>(smem, tot[0], gbm[0], mt, nh, lane);
            __syncthreads();
        }
        {   // gW0 += x^T g0: warp (d rows 16 (warp & 1).., h cols 16 (warp >> 1)..)
            const int d0 = 16 * (warp & 1), h0 = 16 * (warp >> 1);
            if (padded(0) == 64 || h0 < padded(0)) {
                float fr[2][4];
                const int lr = lane & 15, lc = (lane >> 4) << 3;
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
    }
    cp_async_wait<0>();
    __syncthreads();

    // the block's partial: gW_l (l < L) straight from the fragments, the
    // rest through shared scratch (over the activations), summed in a
    // fixed order
    float* out = partial + (size_t)blockIdx.x * f.P;
    if constexpr (DEPTH > 1) write_tot<1>(out, f, tot[0], mt, nh, lane);
    if constexpr (DEPTH > 2) write_tot<2>(out, f, tot[1], mt, nh, lane);
    {
        constexpr int W = Hidden::width(0);
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int d = 16 * (warp & 1) + g + 8 * hf;
                const int h = 16 * (warp >> 1) + 8 * j + 2 * c;
                if (d < DO) {
                    if (h < W) out[d * W + h] = tot0[j][2 * hf];
                    if (h + 1 < W) out[d * W + h + 1] = tot0[j][2 * hf + 1];
                }
            }
    }
    float* rW2 = reinterpret_cast<float*>(smem + OFF_H0);  // [mq][k][m]
    float* rBL = rW2 + 4 * 64 * DA_MAX;                     // [mq][k]
    float* rB = rBL + 4 * 64;                               // [l][nh][h]
    float* rB2 = rB + 2 * 64 * (DEPTH - 1);                 // [m][s]
    float* rLS = rB2 + DA_MAX * TS;                         // [m][s]
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) rW2[(mq * 64 + hs) * DA_MAX + m] = aW2[m];
    rBL[mq * 64 + hs] = gbl;
#pragma unroll
    for (int l = 0; l < DEPTH - 1; ++l)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            float v = gbm[l][hf];
            v += __shfl_xor_sync(0xffffffffu, v, 1);
            v += __shfl_xor_sync(0xffffffffu, v, 2);
            if (c == 0) rB[(2 * l + nh) * 64 + 16 * mt + g + 8 * hf] = v;
        }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
        rB2[(mq + 4 * j) * TS + hs] = gb2[j];
        rLS[(mq + 4 * j) * TS + hs] = gls[j];
    }
    __syncthreads();
    for (int e = tid; e < HL * DA; e += NT) {
        const int k = e / DA, m = e % DA;
        float s = rW2[k * DA_MAX + m];
        for (int q = 1; q < 4; ++q) s += rW2[(q * 64 + k) * DA_MAX + m];
        out[f.W[DEPTH] + e] = s;
    }
    if (tid < HL) {
        float s = rBL[tid];
        for (int q = 1; q < 4; ++q) s += rBL[q * 64 + tid];
        out[f.b[DEPTH - 1] + tid] = s;
    }
#pragma unroll
    for (int l = 0; l < DEPTH - 1; ++l)
        if (tid < Hidden::width(l))
            out[f.b[l] + tid] = rB[2 * l * 64 + tid] + rB[(2 * l + 1) * 64 + tid];
    if (tid < DA) {
        float s2 = 0.f, sl = 0.f;
        for (int s = 0; s < TS; ++s) {
            s2 += rB2[tid * TS + s];
            sl += rLS[tid * TS + s];
        }
        out[f.b[DEPTH] + tid] = s2;
        out[f.ls + tid] = sl;
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
// adv (T, N) fp32. hidden (n_hidden ints, host): the policy's hidden
// widths, which must be this library's (policy_shape.cuh), else
// cudaErrorInvalidValue; weights (host array of device pointers): W0, b0,
// ..., W_L, b_L, L = n_hidden (W_l (in, out) row-major), then logstd
// (da), all fp32. Out: mu (T, da, N), logp (T, N) and the flat gradient g
// (P) in sorted-key order, all fp32; partial: n_blocks * P floats of
// scratch.
extern "C" int trpo_pg_launch(const void* obs, const void* act,
                              const float* adv, const int* hidden,
                              int n_hidden, const float* const* weights,
                              float* mu, float* logp, float* partial,
                              float* g, int T, int DO, int DA, int N,
                              int n_blocks, int bf16_mode, void* stream) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX ||
        !policy_shape::same_shape(hidden, n_hidden))
        return (int)cudaErrorInvalidValue;
    const Weights w = policy_shape::weights_of(weights);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (bf16_mode) {
        err = cudaFuncSetAttribute(pg_partial_tc_kernel<NL>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   TC_SMEM);
        if (err != cudaSuccess) return (int)err;
        const bool aligned = ((uintptr_t)obs | (uintptr_t)act |
                              (uintptr_t)adv) % 16 == 0;
        pg_partial_tc_kernel<NL><<<n_blocks, NT, TC_SMEM, st>>>(
            static_cast<const __nv_bfloat16*>(obs),
            static_cast<const __nv_bfloat16*>(act), adv, w, mu, logp, partial,
            T, DO, DA, N, (int)(aligned && N % 8 == 0));
    } else {
        const size_t smem = (size_t)smem_floats(DO, DA) * sizeof(float);
        err = cudaFuncSetAttribute(pg_partial_kernel<NL>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
        if (err != cudaSuccess) return (int)err;
        pg_partial_kernel<NL><<<n_blocks, NT, smem, st>>>(
            static_cast<const float*>(obs), static_cast<const float*>(act),
            adv, w, mu, logp, partial, T, DO, DA, N);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const Flat f = policy_shape::flat(DO, DA);
    pg_reduce_kernel<<<(f.P + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, g, n_blocks, f.P, f.ls, (float)T * (float)N);
    return (int)cudaGetLastError();
}
