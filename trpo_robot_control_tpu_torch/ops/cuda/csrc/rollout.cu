// Fused planar-arm rollout: the whole horizon in one launch.
//
// Replaces `pallas_rollout` / `_rollout_kernel` in
// trpo_robot_control_tpu/ops/pallas/rollout_kernel.py (fp32-storage
// mode). Per env step: forward kinematics, the closed-form planar mass
// matrix and centripetal bias, an unrolled Cholesky solve, semi-implicit
// Euler over n_substeps, the tanh-MLP policy mean, a Gaussian action
// (caller-supplied eps, or Philox4x32-10 + paired Box-Muller), the torque
// clip and the reward at the post-step state. The terminating
// instantiation (TERM, the TPU kernel's `terminating` branch) then flags
// an env done when its post-step end effector is within done_dist of the
// target and gives it a fresh episode in registers: q and qd uniform in
// +-noise, the target at a uniform radius in [rmin, rmax] and a uniform
// angle, drawn from Philox with counter (env, t, block, 1) (the action
// normals use (env, t, block, 0), so the action noise is the same whether
// the env terminates or not), or read from caller-supplied fresh states.
// TERM is a template switch: the non-terminating instantiation is the
// same code as without it.
//
// What bounds it on an H100: not bytes (6.6 MB written at c2, ~2 us) and
// not FLOPs (~1 GFLOP of fp32 FMA, ~15 us at 67 TFLOP/s) but the T
// dependent steps of one env: each step is a chain of ~5k FMAs and 128
// tanh through the policy MLP. The design keeps each env on one thread
// with q, qd and the target in registers for all T steps, the first hidden
// vector (64 floats) in registers, and the policy weights in shared memory
// where every thread of a warp reads the same word (broadcast). The second
// hidden layer is never stored: each unit is folded into the mean as soon
// as it is computed, four units at a time so four FMA chains are in flight.
// Outputs are feature-first (T, d, N): neighbouring threads are
// neighbouring envs, so every store coalesces. 1024 envs fill only 32
// one-warp blocks; more parallelism per env is later work.
//
// C interface (ctypes); returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int H = 64;          // hidden width (both layers)
constexpr int NT = 32;         // threads (envs) per block
constexpr int NJ_MAX = 8;

struct Planar {
    float l[NJ_MAX], lc[NJ_MAX], m[NJ_MAX], iz[NJ_MAX];
    float damping, h, torque_limit, qd_limit, qd_obs_scale, ctrl_weight,
          chol_reg;
    // termination: done_dist^2 (rounded to fp32 once) and the reset
    // distributions' q0_noise, qd0_noise, rmin, rmax
    float done_dist2, q0_noise, qd0_noise, rmin, rmax;
    int n_substeps;
};

template <int NJ>
struct Fk {
    float px[NJ], py[NJ], cx[NJ], cy[NJ], eex, eey;
};

template <int NJ>
__device__ __forceinline__ void fk(const Planar& c, const float* q,
                                   Fk<NJ>& f) {
    float th = 0.f, x = 0.f, y = 0.f;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        th = (i == 0) ? q[0] : th + q[i];
        float ct = cosf(th), st = sinf(th);
        f.px[i] = x;
        f.py[i] = y;
        f.cx[i] = x + c.lc[i] * ct;
        f.cy[i] = y + c.lc[i] * st;
        x = x + c.l[i] * ct;
        y = y + c.l[i] * st;
    }
    f.eex = x;
    f.eey = y;
}

// One semi-implicit Euler substep: M qdd = tau - bias - damping qd.
template <int NJ>
__device__ __forceinline__ void substep(const Planar& c, const Fk<NJ>& f,
                                        const float* tau, float* q,
                                        float* qd) {
    // mass matrix, upper triangle: M_ij = sum_{k>=j} m_k <J_ki, J_kj> + I_k
    float M[NJ][NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i)
#pragma unroll
        for (int j = i; j < NJ; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int k = j; k < NJ; ++k) {
                float dot = (f.cy[k] - f.py[i]) * (f.cy[k] - f.py[j])
                          + (f.cx[k] - f.px[i]) * (f.cx[k] - f.px[j]);
                float term = c.m[k] * dot + c.iz[k];
                acc = (k == j) ? term : acc + term;
            }
            M[i][j] = acc;
        }
    // centripetal bias: planar Newton-Euler with qdd = 0, no gravity
    float w[NJ], acx[NJ], acy[NJ];
    float ax = 0.f, ay = 0.f, wacc = 0.f;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        wacc = (i == 0) ? qd[0] : wacc + qd[i];
        w[i] = wacc;
        float w2 = w[i] * w[i];
        acx[i] = ax - w2 * (f.cx[i] - f.px[i]);
        acy[i] = ay - w2 * (f.cy[i] - f.py[i]);
        if (i + 1 < NJ) {
            ax = ax - w2 * (f.px[i + 1] - f.px[i]);
            ay = ay - w2 * (f.py[i + 1] - f.py[i]);
        }
    }
    float bias[NJ];
    float fx = 0.f, fy = 0.f, nz = 0.f, pcx = 0.f, pcy = 0.f;
#pragma unroll
    for (int i = NJ - 1; i >= 0; --i) {
        float Fx = c.m[i] * acx[i];
        float Fy = c.m[i] * acy[i];
        nz = nz + (f.cx[i] - f.px[i]) * Fy - (f.cy[i] - f.py[i]) * Fx
                + (pcx - f.px[i]) * fy - (pcy - f.py[i]) * fx;
        bias[i] = nz;
        fx = Fx + fx;
        fy = Fy + fy;
        pcx = f.px[i];
        pcy = f.py[i];
    }
    float rhs[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i)
        rhs[i] = tau[i] - bias[i] - c.damping * qd[i];
    // unrolled Cholesky of (M + reg I), one rsqrt per pivot
    float L[NJ][NJ], inv_d[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        float s = M[j][j] + c.chol_reg;
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - L[j][k] * L[j][k];
        float inv = rsqrtf(s);
        inv_d[j] = inv;
        L[j][j] = s * inv;
#pragma unroll
        for (int i = j + 1; i < NJ; ++i) {
            float t = M[j][i];
#pragma unroll
            for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
            L[i][j] = t * inv;
        }
    }
    float y[NJ], x[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        float s = rhs[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
        y[i] = s * inv_d[i];
    }
#pragma unroll
    for (int i = NJ - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < NJ; ++k) s = s - L[k][i] * x[k];
        x[i] = s * inv_d[i];
    }
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        qd[i] = fminf(fmaxf(qd[i] + c.h * x[i], -c.qd_limit), c.qd_limit);
        q[i] = q[i] + c.h * qd[i];
    }
}

// The fresh episode of a done env: fq/fqd (T, NJ, N) and ftgt (T, 2, N)
// from the caller, or, when fq is NULL, uniforms from Philox with counter
// (env, t, block, 1): q_i = u[i], qd_i = u[NJ + i], radius u[2 NJ], angle
// u[2 NJ + 1].
template <int NJ>
__device__ __forceinline__ void fresh_episode(
    const Planar& c, uint2 key, int e, int t, int N,
    const float* __restrict__ fq, const float* __restrict__ fqd,
    const float* __restrict__ ftgt, float* q, float* qd, float& tgtx,
    float& tgty) {
    if (fq != nullptr) {
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            q[i] = fq[((size_t)t * NJ + i) * N + e];
            qd[i] = fqd[((size_t)t * NJ + i) * N + e];
        }
        tgtx = ftgt[((size_t)t * 2) * N + e];
        tgty = ftgt[((size_t)t * 2 + 1) * N + e];
        return;
    }
    constexpr int NB = (2 * NJ + 2 + 3) / 4;
    float u[4 * NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) {
        uint4 r = philox4x32_10(
            make_uint4((uint32_t)e, (uint32_t)t, (uint32_t)b, 1u), key);
        u[4 * b + 0] = uniform01(r.x);
        u[4 * b + 1] = uniform01(r.y);
        u[4 * b + 2] = uniform01(r.z);
        u[4 * b + 3] = uniform01(r.w);
    }
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        q[i] = c.q0_noise * (2.f * u[i] - 1.f);
        qd[i] = c.qd0_noise * (2.f * u[NJ + i] - 1.f);
    }
    const float r = c.rmin + (c.rmax - c.rmin) * u[2 * NJ];
    float s, cs;
    sincosf(6.283185307179586f * u[2 * NJ + 1], &s, &cs);
    tgtx = r * cs;
    tgty = r * s;
}

template <int NJ, bool TERM>
__global__ void __launch_bounds__(NT) rollout_kernel(
    Planar c, const float* __restrict__ q0, const float* __restrict__ qd0,
    const float* __restrict__ tgt, const float* __restrict__ W0,
    const float* __restrict__ b0, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ W2,
    const float* __restrict__ b2, const float* __restrict__ logstd,
    const float* __restrict__ eps, const int64_t* __restrict__ seed,
    const float* __restrict__ fq, const float* __restrict__ fqd,
    const float* __restrict__ ftgt, float* __restrict__ obs,
    float* __restrict__ act, float* __restrict__ rew,
    float* __restrict__ dones, int N, int T) {
    constexpr int DO = 3 * NJ + 3;
    __shared__ __align__(16) float sW1[H * H];
    __shared__ float sW0[DO * H], sb0[H], sb1[H], sW2[H * NJ], sb2[NJ];
    for (int i = threadIdx.x; i < H * H; i += NT) sW1[i] = W1[i];
    for (int i = threadIdx.x; i < DO * H; i += NT) sW0[i] = W0[i];
    for (int i = threadIdx.x; i < H * NJ; i += NT) sW2[i] = W2[i];
    for (int i = threadIdx.x; i < H; i += NT) {
        sb0[i] = b0[i];
        sb1[i] = b1[i];
    }
    if (threadIdx.x < NJ) sb2[threadIdx.x] = b2[threadIdx.x];
    __syncthreads();

    const int e = blockIdx.x * NT + threadIdx.x;
    if (e >= N) return;

    float q[NJ], qd[NJ], sigma[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        q[i] = q0[i * N + e];
        qd[i] = qd0[i * N + e];
        sigma[i] = expf(logstd[i]);
    }
    float tgtx = tgt[e], tgty = tgt[N + e];
    uint2 key = make_uint2(0u, 0u);
    if (eps == nullptr) {
        key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
    }

    for (int t = 0; t < T; ++t) {
        Fk<NJ> f;
        fk<NJ>(c, q, f);
        float o[DO];
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            o[i] = cosf(q[i]);
            o[NJ + i] = sinf(q[i]);
            o[2 * NJ + i] = c.qd_obs_scale * qd[i];
        }
        o[3 * NJ] = tgtx - f.eex;
        o[3 * NJ + 1] = tgty - f.eey;
        o[3 * NJ + 2] = 0.f;
#pragma unroll
        for (int d = 0; d < DO; ++d) obs[((size_t)t * DO + d) * N + e] = o[d];

        // policy mean: tanh(W0^T o + b0) -> tanh(W1^T h0 + b1) -> W2^T h1 + b2
        float h0[H];
#pragma unroll
        for (int k = 0; k < H; ++k) {
            float z = 0.f;
#pragma unroll
            for (int d = 0; d < DO; ++d) z = fmaf(o[d], sW0[d * H + k], z);
            h0[k] = tanhf(z + sb0[k]);
        }
        float mu[NJ];
#pragma unroll
        for (int m = 0; m < NJ; ++m) mu[m] = 0.f;
#pragma unroll 1
        for (int j = 0; j < H; j += 4) {
            float z0 = 0.f, z1 = 0.f, z2 = 0.f, z3 = 0.f;
#pragma unroll
            for (int k = 0; k < H; ++k) {
                float4 w = *reinterpret_cast<const float4*>(&sW1[k * H + j]);
                z0 = fmaf(h0[k], w.x, z0);
                z1 = fmaf(h0[k], w.y, z1);
                z2 = fmaf(h0[k], w.z, z2);
                z3 = fmaf(h0[k], w.w, z3);
            }
            float a0 = tanhf(z0 + sb1[j]), a1 = tanhf(z1 + sb1[j + 1]);
            float a2 = tanhf(z2 + sb1[j + 2]), a3 = tanhf(z3 + sb1[j + 3]);
#pragma unroll
            for (int m = 0; m < NJ; ++m) {
                mu[m] = fmaf(a0, sW2[j * NJ + m], mu[m]);
                mu[m] = fmaf(a1, sW2[(j + 1) * NJ + m], mu[m]);
                mu[m] = fmaf(a2, sW2[(j + 2) * NJ + m], mu[m]);
                mu[m] = fmaf(a3, sW2[(j + 3) * NJ + m], mu[m]);
            }
        }

        float z[NJ];
        if (eps != nullptr) {
#pragma unroll
            for (int i = 0; i < NJ; ++i) z[i] = eps[((size_t)t * NJ + i) * N + e];
        } else {
            normals<NJ>(key, (uint32_t)e, (uint32_t)t, z);
        }
        float tau[NJ];
        float ctrl = 0.f;
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            float a = (mu[i] + sb2[i]) + sigma[i] * z[i];
            act[((size_t)t * NJ + i) * N + e] = a;
            tau[i] = fminf(fmaxf(a, -c.torque_limit), c.torque_limit);
            ctrl = (i == 0) ? tau[0] * tau[0] : ctrl + tau[i] * tau[i];
        }

        for (int s = 0; s < c.n_substeps; ++s) {
            if (s > 0) fk<NJ>(c, q, f);
            substep<NJ>(c, f, tau, q, qd);
        }
        fk<NJ>(c, q, f);                  // reward at the post-step state
        float dx = f.eex - tgtx, dy = f.eey - tgty;
        const float dist2 = dx * dx + dy * dy;
        rew[(size_t)t * N + e] = -(dist2 + c.ctrl_weight * ctrl);
        if (TERM) {
            const bool done = dist2 < c.done_dist2;
            dones[(size_t)t * N + e] = done ? 1.f : 0.f;
            if (done)
                fresh_episode<NJ>(c, key, e, t, N, fq, fqd, ftgt, q, qd, tgtx,
                                  tgty);
        }
    }
}

struct Args {
    const float *q0, *qd0, *tgt, *W0, *b0, *W1, *b1, *W2, *b2, *logstd, *eps;
    const int64_t* seed;
    const float *fq, *fqd, *ftgt;
    float *obs, *act, *rew, *dones;
    int N, T;
    cudaStream_t stream;
};

template <int NJ, bool TERM>
cudaError_t launch(const Planar& c, const Args& a) {
    dim3 grid((a.N + NT - 1) / NT);
    rollout_kernel<NJ, TERM><<<grid, NT, 0, a.stream>>>(
        c, a.q0, a.qd0, a.tgt, a.W0, a.b0, a.W1, a.b1, a.W2, a.b2, a.logstd,
        a.eps, a.seed, a.fq, a.fqd, a.ftgt, a.obs, a.act, a.rew, a.dones,
        a.N, a.T);
    return cudaGetLastError();
}

template <int NJ>
cudaError_t launch_term(const Planar& c, const Args& a, int terminating) {
    return terminating ? launch<NJ, true>(c, a) : launch<NJ, false>(c, a);
}

}  // namespace

// consts (host array): l[n], lc[n], m[n], iz[n], damping, h, torque_limit,
// qd_limit, qd_obs_scale, ctrl_weight, chol_reg, done_dist^2, q0_noise,
// qd0_noise, rmin, rmax.
// eps: (T, n, N) or NULL for Philox mode with seed: int64[2] on the device.
// terminating != 0 takes the TERM instantiation, which writes dones (T, N)
// and takes the fresh episodes from fq/fqd (T, n, N) and ftgt (T, 2, N),
// or from Philox when fq is NULL.
extern "C" int trpo_rollout_launch(
    const float* consts, int n_substeps, int n_joints, int terminating,
    const float* q0, const float* qd0, const float* tgt, const float* W0,
    const float* b0, const float* W1, const float* b1, const float* W2,
    const float* b2, const float* logstd, const float* eps,
    const int64_t* seed, const float* fq, const float* fqd,
    const float* ftgt, float* obs, float* act, float* rew, float* dones,
    int N, int T, void* stream) {
    Planar c;
    const int n = n_joints;
    if (n < 1 || n > NJ_MAX) return (int)cudaErrorInvalidValue;
    for (int i = 0; i < n; ++i) {
        c.l[i] = consts[i];
        c.lc[i] = consts[n + i];
        c.m[i] = consts[2 * n + i];
        c.iz[i] = consts[3 * n + i];
    }
    const float* s = consts + 4 * n;
    c.damping = s[0];
    c.h = s[1];
    c.torque_limit = s[2];
    c.qd_limit = s[3];
    c.qd_obs_scale = s[4];
    c.ctrl_weight = s[5];
    c.chol_reg = s[6];
    c.done_dist2 = s[7];
    c.q0_noise = s[8];
    c.qd0_noise = s[9];
    c.rmin = s[10];
    c.rmax = s[11];
    c.n_substeps = n_substeps;
    const Args a = {q0, qd0, tgt, W0, b0, W1, b1, W2, b2, logstd, eps, seed,
                    fq, fqd, ftgt, obs, act, rew, dones, N, T,
                    static_cast<cudaStream_t>(stream)};
    switch (n) {
        case 2:
            return (int)launch_term<2>(c, a, terminating);
        case 3:
            return (int)launch_term<3>(c, a, terminating);
        default:
            return (int)cudaErrorInvalidValue;
    }
}
