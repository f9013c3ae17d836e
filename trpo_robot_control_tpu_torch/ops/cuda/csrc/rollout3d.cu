// Fused rollout of a 7-DoF spatial arm with gravity: the whole horizon in
// one launch.
//
// Replaces `pallas_rollout3d` / `_rollout3d_kernel` in
// trpo_robot_control_tpu/ops/pallas/rollout3d_kernel.py (fp32 or bf16
// storage). Per env step: forward kinematics from exact
// sincosf, the observation (with the task one-hot when NTASKS > 1), the
// tanh-MLP policy mean, a Gaussian action (caller eps, or Philox4x32-10 +
// paired Box-Muller), the torque clip, then per substep the 7 mass-matrix
// columns and the gravity/Coriolis bias as 8 world-frame RNEA passes, a
// regularised Cholesky solve and a semi-implicit Euler step, and
// `_score_step`'s reward at the post-step state (whose FK is the next
// step's pre-step FK: the same q gives the same numbers): the track
// task's target rotation (task 1), the reach and control cost, the push
// task's end-effector velocity penalty (task 2, NTASKS > 2) and the
// obstacle sphere penalty (OBST). The terminating instantiation (TERM,
// the TPU kernel's `terminating` branch) then flags an env done when its
// post-step end effector is within done_dist of the (rotated) target and
// gives it a fresh episode: q and qd uniform in +-noise, the target at a
// uniform radius in [rmin, rmax] along a normalised 3-normal with z >= 0
// (Box-Muller), and with several families a task floor(u n_tasks); drawn
// from Philox with counter (env, t, block, 1), the action normals' being
// (env, t, block, 0), or read from caller-supplied fresh states. The task
// terms and TERM are template switches, so the reach-only non-terminating
// instantiation is the same code as without them.
//
// What bounds it on an H100: neither bytes (54 MB written at c3, 16 us)
// nor FLOPs (~10 GFLOP of MLP plus the dynamics, ~0.2 ms at 67 TFLOP/s)
// but the 200 dependent steps of each env: a chain of two 64-wide MLP
// layers, 2 x (FK + RNEA pass + 7x7 Cholesky) and ~20 transcendentals.
// The design spreads one env over eight threads, one per RNEA pass, which
// is the TPU kernel's `_mass_bias_fused` row split turned into warps: a
// block holds 32 envs (one per lane) and NJ + 1 = 8 warps. Warp j < 7
// computes mass-matrix column j (zero velocity, unit acceleration of
// joint j, no gravity), warp 7 the bias (real velocity, gravity, zero
// acceleration); the columns meet in shared memory and every warp then
// solves the same 7x7 system redundantly, so q and qd stay in registers
// in every warp without another exchange. The same holds for a reset:
// every warp sees the same distance, so all take the same done decision,
// and counter-based Philox gives all of them the same fresh episode
// without an exchange; after it every warp recomputes the cos/sin and
// the FK that the next observation reads. The 64 hidden units of each
// policy layer are split the same way (8 per warp) with the activations
// in shared memory, and warp m < 7 forms action m. No warp diverges:
// its 32 lanes are 32 envs on the same pass. Stores are rows of 32
// neighbouring envs, so they coalesce. 4096 envs give 128 blocks of 256
// threads: one block on each of 128 SMs.
//
// Numerics: built with -fmad=false so every multiply and add rounds as
// PyTorch's separate elementwise ops do in the plain version; the
// Cholesky pivots use 1.0f / sqrtf (correctly rounded, as 1 / torch.sqrt
// is), and the push term divides by |d| + 1e-6 as the plain version does;
// the policy MLP uses explicit fmaf. Arm constants arrive as kernel
// arguments already rounded to float32, and products with the zero and
// unit entries of the fixed transforms give the same numbers as the plain
// version's sparse folding of them.
//
// C interface (ctypes); returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr int H = 64;          // hidden width (both layers)
constexpr int ENVS = 32;       // envs per block, one per lane
constexpr int NJ_MAX = 7;

struct Arm3D {
    float T_rot[NJ_MAX][9], T_pos[NJ_MAX][3], mass[NJ_MAX], com[NJ_MAX][3],
        inertia[NJ_MAX][9], ee[3];
    float gravity, damping, h, torque_limit, qd_limit, qd_obs_scale,
        ctrl_weight, chol_reg;
    // task terms: cos/sin of track_omega * dt, push speed and weight,
    // obstacle weight, radius and centre
    float track_cos, track_sin, push_speed, push_weight, obstacle_weight,
        obstacle_radius, obstacle_center[3];
    // termination: done_dist^2 (rounded to fp32 once) and the reset
    // distributions' q0_noise, qd0_noise, rmin, rmax
    float done_dist2, q0_noise, qd0_noise, rmin, rmax;
    int n_substeps;
};

struct V3 {
    float x, y, z;
};

__device__ __forceinline__ V3 vadd(V3 a, V3 b) {
    return {a.x + b.x, a.y + b.y, a.z + b.z};
}
__device__ __forceinline__ V3 vsub(V3 a, V3 b) {
    return {a.x - b.x, a.y - b.y, a.z - b.z};
}
__device__ __forceinline__ V3 vscale(float s, V3 a) {
    return {s * a.x, s * a.y, s * a.z};
}
__device__ __forceinline__ V3 vcross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}
__device__ __forceinline__ float vdot(V3 a, V3 b) {
    return a.x * b.x + a.y * b.y + a.z * b.z;
}
// R (row-major 3x3) @ v
__device__ __forceinline__ V3 mvec(const float* R, V3 v) {
    return {R[0] * v.x + R[1] * v.y + R[2] * v.z,
            R[3] * v.x + R[4] * v.y + R[5] * v.z,
            R[6] * v.x + R[7] * v.y + R[8] * v.z};
}
__device__ __forceinline__ V3 mvec_c(const float* R, const float* v) {
    return mvec(R, V3{v[0], v[1], v[2]});
}
// R^T @ v
__device__ __forceinline__ V3 mtvec(const float* R, V3 v) {
    return {R[0] * v.x + R[3] * v.y + R[6] * v.z,
            R[1] * v.x + R[4] * v.y + R[7] * v.z,
            R[2] * v.x + R[5] * v.y + R[8] * v.z};
}
// world inertia times v: R (I (R^T v))
__device__ __forceinline__ V3 inertia_vec(const float* R, const float* I,
                                          V3 v) {
    V3 tv = mtvec(R, v);
    V3 iv = {tv.x * I[0] + tv.y * I[1] + tv.z * I[2],
             tv.x * I[3] + tv.y * I[4] + tv.z * I[5],
             tv.x * I[6] + tv.y * I[7] + tv.z * I[8]};
    return mvec(R, iv);
}

template <int NJ>
struct Fk3 {
    float R[NJ][9];
    V3 p[NJ], axis[NJ], ee;
};

template <int NJ>
__device__ __forceinline__ void fk3(const Arm3D& c, const float* cq,
                                    const float* sq, Fk3<NJ>& f) {
    float Rp[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    V3 pp = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        float A[9];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                A[3 * r + k] = Rp[3 * r] * c.T_rot[i][k]
                             + Rp[3 * r + 1] * c.T_rot[i][3 + k]
                             + Rp[3 * r + 2] * c.T_rot[i][6 + k];
        f.p[i] = vadd(pp, mvec_c(Rp, c.T_pos[i]));
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            f.R[i][3 * r] = A[3 * r] * cq[i] + A[3 * r + 1] * sq[i];
            f.R[i][3 * r + 1] = -A[3 * r] * sq[i] + A[3 * r + 1] * cq[i];
            f.R[i][3 * r + 2] = A[3 * r + 2];
        }
        f.axis[i] = V3{A[2], A[5], A[8]};
#pragma unroll
        for (int k = 0; k < 9; ++k) Rp[k] = f.R[i][k];
        pp = f.p[i];
    }
    f.ee = vadd(f.p[NJ - 1], mvec_c(f.R[NJ - 1], c.ee));
}

// One RNEA pass of the fused sweep: pass j < NJ gives column j of the
// mass matrix (qd = 0, qdd = e_j, no gravity), pass NJ the bias (real qd,
// qdd = 0, gravity). Writes tau_i of this pass to tau[i].
template <int NJ>
__device__ __forceinline__ void rnea_pass(const Arm3D& c, const Fk3<NJ>& f,
                                          const float* qd, int j,
                                          float* tau) {
    const bool bias = (j == NJ);
    V3 w_par = {0.f, 0.f, 0.f}, wd_par = {0.f, 0.f, 0.f};
    V3 a_par = {0.f, 0.f, bias ? c.gravity : 0.f};
    V3 p_par = {0.f, 0.f, 0.f};
    V3 ws[NJ], wds[NJ], acs[NJ], cws[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        const float qd_i = bias ? qd[i] : 0.f;
        const float qdd_i = (i == j) ? 1.f : 0.f;
        V3 r = vsub(f.p[i], p_par);
        V3 a_i = vadd(a_par, vadd(vcross(wd_par, r),
                                  vcross(w_par, vcross(w_par, r))));
        V3 s = f.axis[i];
        V3 w_i = vadd(w_par, vscale(qd_i, s));
        V3 wd_i = vadd(vadd(wd_par, vscale(qdd_i, s)),
                       vcross(w_par, vscale(qd_i, s)));
        V3 d = mvec_c(f.R[i], c.com[i]);
        acs[i] = vadd(a_i, vadd(vcross(wd_i, d),
                                vcross(w_i, vcross(w_i, d))));
        ws[i] = w_i;
        wds[i] = wd_i;
        cws[i] = vadd(f.p[i], d);
        w_par = w_i;
        wd_par = wd_i;
        a_par = a_i;
        p_par = f.p[i];
    }
    V3 f_child = {0.f, 0.f, 0.f}, n_child = {0.f, 0.f, 0.f};
    V3 p_child = {0.f, 0.f, 0.f};
#pragma unroll
    for (int i = NJ - 1; i >= 0; --i) {
        V3 F = vscale(c.mass[i], acs[i]);
        V3 N = vadd(inertia_vec(f.R[i], c.inertia[i], wds[i]),
                    vcross(ws[i], inertia_vec(f.R[i], c.inertia[i], ws[i])));
        V3 fi = vadd(F, f_child);
        V3 nn = vadd(vadd(N, n_child),
                     vadd(vcross(vsub(cws[i], f.p[i]), F),
                          vcross(vsub(p_child, f.p[i]), f_child)));
        tau[i] = vdot(f.axis[i], nn);
        f_child = fi;
        n_child = nn;
        p_child = f.p[i];
    }
}

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

// The reward of one env at the post-step state: -(|ee - tgt|^2 + ctrl_weight
// sum tau^2), minus the push penalty for task 2 and the obstacle penalty,
// in the plain version's operation order.
template <int NJ, int NTASKS, bool OBST>
__device__ __forceinline__ float score(const Arm3D& c, const Fk3<NJ>& f,
                                       const float* qd, V3 tgt, int task,
                                       float ctrl) {
    V3 d = vsub(f.ee, tgt);
    float r = -(vdot(d, d) + c.ctrl_weight * ctrl);
    if (NTASKS > 2 && task == 2) {
        V3 v = {0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < NJ; ++i)
            v = vadd(v, vscale(qd[i], vcross(f.axis[i], vsub(f.ee, f.p[i]))));
        const float dn = sqrtf(vdot(d, d)) + 1e-6f;
        const V3 dirn = {-d.x / dn, -d.y / dn, -d.z / dn};
        const V3 verr = vsub(v, vscale(c.push_speed, dirn));
        r = r - c.push_weight * vdot(verr, verr);
    }
    if (OBST) {
        float pen = 0.f;
#pragma unroll
        for (int i = 1; i <= NJ; ++i) {
            const V3 pt = (i < NJ) ? f.p[i] : f.ee;
            const float dx = pt.x - c.obstacle_center[0];
            const float dy = pt.y - c.obstacle_center[1];
            const float dz = pt.z - c.obstacle_center[2];
            float t = fmaxf(c.obstacle_radius - sqrtf(dx * dx + dy * dy
                                                      + dz * dz), 0.f);
            t = t * t;
            pen = (i == 1) ? t : pen + t;
        }
        r = r - c.obstacle_weight * pen;
    }
    return r;
}

// The fresh episode of a done env: fq/fqd (T, NJ, N), ftgt (T, 3, N) and
// ftask (T, N) from the caller, or, when fq is NULL, uniforms from Philox
// with counter (env, t, block, 1): q_i = u[i], qd_i = u[NJ + i], radius
// u[2 NJ], the direction's Box-Muller pairs u[2 NJ + 1 .. 2 NJ + 4], task
// u[2 NJ + 5]. Every warp of the env's block computes the same values.
template <int NJ, int NTASKS>
__device__ __forceinline__ void fresh_episode(
    const Arm3D& c, uint2 key, int e, int t, int N,
    const float* __restrict__ fq, const float* __restrict__ fqd,
    const float* __restrict__ ftgt, const int* __restrict__ ftask,
    float* q, float* qd, V3& tgt, int& task) {
    if (fq != nullptr) {
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            q[i] = fq[((size_t)t * NJ + i) * N + e];
            qd[i] = fqd[((size_t)t * NJ + i) * N + e];
        }
        tgt = {ftgt[((size_t)t * 3) * N + e], ftgt[((size_t)t * 3 + 1) * N + e],
               ftgt[((size_t)t * 3 + 2) * N + e]};
        if (NTASKS > 1) task = ftask[(size_t)t * N + e];
        return;
    }
    constexpr int NB = (2 * NJ + 6 + 3) / 4;
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
    constexpr float TWO_PI = 6.283185307179586f;
    float s, cs;
    const float g1 = sqrtf(-2.f * logf(u[2 * NJ + 1]))
                   * cosf(TWO_PI * u[2 * NJ + 2]);
    const float bm = sqrtf(-2.f * logf(u[2 * NJ + 3]));
    sincosf(TWO_PI * u[2 * NJ + 4], &s, &cs);
    const float g2 = bm * cs, g3 = bm * s;
    const float nrm = sqrtf(g1 * g1 + g2 * g2 + g3 * g3) + 1e-12f;
    tgt = {r * g1 / nrm, r * g2 / nrm, r * fabsf(g3) / nrm};
    // u <= 1 - 2^-24, so u * n_tasks rounds to below n_tasks
    if (NTASKS > 1) task = (int)(u[2 * NJ + 5] * (float)NTASKS);
}

template <int NJ, int NTASKS, bool OBST, bool TERM, typename Out>
__global__ void __launch_bounds__((NJ + 1) * ENVS) rollout3d_kernel(
    Arm3D c, const float* __restrict__ q0, const float* __restrict__ qd0,
    const float* __restrict__ tgt0, const int* __restrict__ task0,
    const float* __restrict__ W0,
    const float* __restrict__ b0, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ W2,
    const float* __restrict__ b2, const float* __restrict__ logstd,
    const float* __restrict__ eps, const int64_t* __restrict__ seed,
    const float* __restrict__ fq, const float* __restrict__ fqd,
    const float* __restrict__ ftgt, const int* __restrict__ ftask,
    Out* __restrict__ obs, Out* __restrict__ act, float* __restrict__ rew,
    float* __restrict__ dones, int N, int T) {
    constexpr int NW = NJ + 1;          // warps: one per RNEA pass
    constexpr int NT = NW * ENVS;
    constexpr int DO = 3 * NJ + 3 + (NTASKS > 1 ? NTASKS : 0);
    constexpr int UPW = H / NW;         // hidden units per warp
    static_assert(H % NW == 0, "hidden width must split evenly over warps");
    static_assert(NW * NJ <= H, "tau columns alias the first hidden buffer");
    __shared__ float sW0[DO * H], sW1[H * H], sW2[H * NJ];
    __shared__ float sb0[H], sb1[H], sb2[NJ];
    __shared__ float sH0[H * ENVS], sH1[H * ENVS], sAct[NJ * ENVS];
    float* sTau = sH0;   // (NW, NJ, ENVS): used only between MLP phases
    for (int i = threadIdx.x; i < H * H; i += NT) sW1[i] = W1[i];
    for (int i = threadIdx.x; i < DO * H; i += NT) sW0[i] = W0[i];
    for (int i = threadIdx.x; i < H * NJ; i += NT) sW2[i] = W2[i];
    for (int i = threadIdx.x; i < H; i += NT) {
        sb0[i] = b0[i];
        sb1[i] = b1[i];
    }
    if (threadIdx.x < NJ) sb2[threadIdx.x] = b2[threadIdx.x];
    __syncthreads();

    const int lane = threadIdx.x % ENVS;
    const int wid = threadIdx.x / ENVS;           // this warp's pass
    const int e_raw = blockIdx.x * ENVS + lane;
    const bool live = e_raw < N;
    const int e = live ? e_raw : N - 1;          // padded lanes shadow env N-1

    float q[NJ], qd[NJ], cq[NJ], sq[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        q[i] = q0[i * N + e];
        qd[i] = qd0[i * N + e];
        sincosf(q[i], &sq[i], &cq[i]);
    }
    V3 tgt = {tgt0[e], tgt0[N + e], tgt0[2 * N + e]};
    int task = (NTASKS > 1) ? task0[e] : 0;     // changes only at a reset
    const float sigma = (wid < NJ) ? expf(logstd[wid]) : 0.f;
    uint2 key = make_uint2(0u, 0u);
    if (eps == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);

    Fk3<NJ> f;
    fk3<NJ>(c, cq, sq, f);
    for (int t = 0; t < T; ++t) {
        float o[DO];
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            o[i] = cq[i];
            o[NJ + i] = sq[i];
            o[2 * NJ + i] = c.qd_obs_scale * qd[i];
        }
        o[3 * NJ] = tgt.x - f.ee.x;
        o[3 * NJ + 1] = tgt.y - f.ee.y;
        o[3 * NJ + 2] = tgt.z - f.ee.z;
#pragma unroll
        for (int k = 0; k < DO - 3 * NJ - 3; ++k)
            o[3 * NJ + 3 + k] = (task == k) ? 1.f : 0.f;
        if (live) {
#pragma unroll
            for (int d = 0; d < DO; ++d)      // rows d = wid (mod NW)
                if (d % NW == wid)
                    obs[((size_t)t * DO + d) * N + e] = store_cast<Out>(o[d]);
        }

        // policy layer 0: this warp's UPW units
#pragma unroll
        for (int u = 0; u < UPW; ++u) {
            const int k = wid * UPW + u;
            float z = 0.f;
#pragma unroll
            for (int d = 0; d < DO; ++d) z = fmaf(o[d], sW0[d * H + k], z);
            sH0[k * ENVS + lane] = tanhf(z + sb0[k]);
        }
        __syncthreads();
        // policy layer 1: UPW chains in flight
        {
            float z[UPW];
#pragma unroll
            for (int u = 0; u < UPW; ++u) z[u] = 0.f;
#pragma unroll 8
            for (int k = 0; k < H; ++k) {
                const float hk = sH0[k * ENVS + lane];
#pragma unroll
                for (int u = 0; u < UPW; ++u)
                    z[u] = fmaf(hk, sW1[k * H + wid * UPW + u], z[u]);
            }
#pragma unroll
            for (int u = 0; u < UPW; ++u) {
                const int j = wid * UPW + u;
                sH1[j * ENVS + lane] = tanhf(z[u] + sb1[j]);
            }
        }
        __syncthreads();
        // action m = wid: mean, noise, store
        if (wid < NJ) {
            float mu = 0.f;
#pragma unroll 8
            for (int k = 0; k < H; ++k)
                mu = fmaf(sH1[k * ENVS + lane], sW2[k * NJ + wid], mu);
            float zn;
            if (eps != nullptr) {
                zn = eps[((size_t)t * NJ + wid) * N + e];
            } else {
                float zz[NJ];
                normals<NJ>(key, (uint32_t)e, (uint32_t)t, zz);
                zn = zz[0];
#pragma unroll
                for (int i = 1; i < NJ; ++i)
                    if (i == wid) zn = zz[i];
            }
            const float a = (mu + sb2[wid]) + sigma * zn;
            if (live) act[((size_t)t * NJ + wid) * N + e] = store_cast<Out>(a);
            sAct[wid * ENVS + lane] = a;
        }
        __syncthreads();
        float tau[NJ];
        float ctrl = 0.f;
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            tau[i] = fminf(fmaxf(sAct[i * ENVS + lane], -c.torque_limit),
                           c.torque_limit);
            ctrl = (i == 0) ? tau[0] * tau[0] : ctrl + tau[i] * tau[i];
        }

        for (int s = 0; s < c.n_substeps; ++s) {
            if (s > 0) fk3<NJ>(c, cq, sq, f);
            {
                float col[NJ];
                rnea_pass<NJ>(c, f, qd, wid, col);
#pragma unroll
                for (int i = 0; i < NJ; ++i)
                    sTau[(wid * NJ + i) * ENVS + lane] = col[i];
            }
            __syncthreads();
            // M[i][k] (i <= k) = tau_i of pass k; bias_i = tau_i of pass NJ
#define MUP(i, k) sTau[((k) * NJ + (i)) * ENVS + lane]
            float L[NJ][NJ], inv_d[NJ];
#pragma unroll
            for (int jj = 0; jj < NJ; ++jj) {
                float sacc = MUP(jj, jj) + c.chol_reg;
#pragma unroll
                for (int k = 0; k < jj; ++k) sacc = sacc - L[jj][k] * L[jj][k];
                const float inv = 1.0f / sqrtf(sacc);
                inv_d[jj] = inv;
                L[jj][jj] = sacc * inv;
#pragma unroll
                for (int i = jj + 1; i < NJ; ++i) {
                    float tt = MUP(jj, i);
#pragma unroll
                    for (int k = 0; k < jj; ++k) tt = tt - L[i][k] * L[jj][k];
                    L[i][jj] = tt * inv;
                }
            }
            float y[NJ], x[NJ];
#pragma unroll
            for (int i = 0; i < NJ; ++i) {
                float sacc = (tau[i] - MUP(i, NJ)) - c.damping * qd[i];
#pragma unroll
                for (int k = 0; k < i; ++k) sacc = sacc - L[i][k] * y[k];
                y[i] = sacc * inv_d[i];
            }
#undef MUP
#pragma unroll
            for (int i = NJ - 1; i >= 0; --i) {
                float sacc = y[i];
#pragma unroll
                for (int k = i + 1; k < NJ; ++k) sacc = sacc - L[k][i] * x[k];
                x[i] = sacc * inv_d[i];
            }
#pragma unroll
            for (int i = 0; i < NJ; ++i) {
                qd[i] = fminf(fmaxf(qd[i] + c.h * x[i], -c.qd_limit),
                              c.qd_limit);
                q[i] = q[i] + c.h * qd[i];
                sincosf(q[i], &sq[i], &cq[i]);
            }
            __syncthreads();      // every warp has read the columns
        }
        if (NTASKS > 1 && task == 1) {   // the track target moves first
            const float tx = c.track_cos * tgt.x - c.track_sin * tgt.y;
            const float ty = c.track_sin * tgt.x + c.track_cos * tgt.y;
            tgt.x = tx;
            tgt.y = ty;
        }
        fk3<NJ>(c, cq, sq, f);    // post-step FK: the reward, next step's obs
        if (wid == 0 && live)
            rew[(size_t)t * N + e] =
                score<NJ, NTASKS, OBST>(c, f, qd, tgt, task, ctrl);
        if (TERM) {               // every warp decides, warp 0 stores
            const V3 d = vsub(f.ee, tgt);
            const bool done = vdot(d, d) < c.done_dist2;
            if (wid == 0 && live) dones[(size_t)t * N + e] = done ? 1.f : 0.f;
            if (done) {
                fresh_episode<NJ, NTASKS>(c, key, e, t, N, fq, fqd, ftgt,
                                          ftask, q, qd, tgt, task);
#pragma unroll
                for (int i = 0; i < NJ; ++i) sincosf(q[i], &sq[i], &cq[i]);
                fk3<NJ>(c, cq, sq, f);
            }
        }
    }
}

struct Args {
    const float *q0, *qd0, *tgt;
    const int* task;
    const float *W0, *b0, *W1, *b1, *W2, *b2, *logstd, *eps;
    const int64_t* seed;
    const float *fq, *fqd, *ftgt;
    const int* ftask;
    void *obs, *act;
    float *rew, *dones;
    int N, T;
    cudaStream_t stream;
};

template <int NJ, int NTASKS, bool OBST, bool TERM, typename Out>
cudaError_t launch(const Arm3D& c, const Args& a) {
    dim3 grid((a.N + ENVS - 1) / ENVS);
    rollout3d_kernel<NJ, NTASKS, OBST, TERM, Out>
        <<<grid, (NJ + 1) * ENVS, 0, a.stream>>>(
            c, a.q0, a.qd0, a.tgt, a.task, a.W0, a.b0, a.W1, a.b1, a.W2,
            a.b2, a.logstd, a.eps, a.seed, a.fq, a.fqd, a.ftgt, a.ftask,
            static_cast<Out*>(a.obs), static_cast<Out*>(a.act), a.rew,
            a.dones, a.N, a.T);
    return cudaGetLastError();
}

template <int NJ, int NTASKS, bool OBST, bool TERM>
cudaError_t launch_store(const Arm3D& c, const Args& a, int store_bf16) {
    return store_bf16 ? launch<NJ, NTASKS, OBST, TERM, __nv_bfloat16>(c, a)
                      : launch<NJ, NTASKS, OBST, TERM, float>(c, a);
}

}  // namespace

// consts (host array, float32): T_rot[n][9], T_pos[n][3], mass[n],
// com[n][3], inertia[n][9] (link frame, row-major), ee_offset[3], gravity,
// damping, h = dt / n_substeps, torque_limit, qd_limit, qd_obs_scale,
// ctrl_weight, chol_reg, cos and sin of track_omega * dt, push_speed,
// push_weight, obstacle_weight, obstacle_radius, obstacle_center[3],
// done_dist^2, q0_noise, qd0_noise, rmin, rmax.
// q0/qd0 (n, N), tgt (3, N), task (N) int32 (read when n_tasks > 1);
// eps (T, n, N) or NULL for Philox mode with seed: int64[2] on the device.
// terminating != 0 takes the TERM instantiation, which writes dones (T, N)
// fp32 and takes the fresh episodes from fq/fqd (T, n, N), ftgt (T, 3, N)
// and ftask (T, N) int32, or from Philox when fq is NULL.
// obs (T, 3n+3 (+ n_tasks when > 1), N) and act (T, n, N) are bf16 when
// store_bf16 != 0, else fp32; rew (T, N) fp32. Instantiated for n = 7
// with (n_tasks, obstacle) in {(1, 0), (1, 1), (3, 0)} (c3, c4, c5), each
// terminating or not; any other combination returns
// cudaErrorNotSupported, which the wrapper raises as NotImplementedError.
extern "C" int trpo_rollout3d_launch(
    const float* consts, int n_joints, int n_substeps, int n_tasks,
    int obstacle, int terminating, int store_bf16, const float* q0,
    const float* qd0, const float* tgt, const int* task, const float* W0,
    const float* b0, const float* W1, const float* b1, const float* W2,
    const float* b2, const float* logstd, const float* eps,
    const int64_t* seed, const float* fq, const float* fqd,
    const float* ftgt, const int* ftask, void* obs, void* act, float* rew,
    float* dones, int N, int T, void* stream) {
    if (n_joints != 7) return (int)cudaErrorInvalidValue;
    constexpr int NJ = 7;
    Arm3D c;
    const float* s = consts;
    for (int i = 0; i < NJ; ++i)
        for (int k = 0; k < 9; ++k) c.T_rot[i][k] = *s++;
    for (int i = 0; i < NJ; ++i)
        for (int k = 0; k < 3; ++k) c.T_pos[i][k] = *s++;
    for (int i = 0; i < NJ; ++i) c.mass[i] = *s++;
    for (int i = 0; i < NJ; ++i)
        for (int k = 0; k < 3; ++k) c.com[i][k] = *s++;
    for (int i = 0; i < NJ; ++i)
        for (int k = 0; k < 9; ++k) c.inertia[i][k] = *s++;
    for (int k = 0; k < 3; ++k) c.ee[k] = *s++;
    c.gravity = s[0];
    c.damping = s[1];
    c.h = s[2];
    c.torque_limit = s[3];
    c.qd_limit = s[4];
    c.qd_obs_scale = s[5];
    c.ctrl_weight = s[6];
    c.chol_reg = s[7];
    c.track_cos = s[8];
    c.track_sin = s[9];
    c.push_speed = s[10];
    c.push_weight = s[11];
    c.obstacle_weight = s[12];
    c.obstacle_radius = s[13];
    for (int k = 0; k < 3; ++k) c.obstacle_center[k] = s[14 + k];
    c.done_dist2 = s[17];
    c.q0_noise = s[18];
    c.qd0_noise = s[19];
    c.rmin = s[20];
    c.rmax = s[21];
    c.n_substeps = n_substeps;
    const Args a = {q0, qd0, tgt, task, W0, b0, W1, b1, W2, b2, logstd, eps,
                    seed, fq, fqd, ftgt, ftask, obs, act, rew, dones, N, T,
                    static_cast<cudaStream_t>(stream)};
    const bool term = terminating != 0;
    if (n_tasks == 1 && !obstacle && !term)
        return (int)launch_store<NJ, 1, false, false>(c, a, store_bf16);
    if (n_tasks == 1 && obstacle && !term)
        return (int)launch_store<NJ, 1, true, false>(c, a, store_bf16);
    if (n_tasks == 3 && !obstacle && !term)
        return (int)launch_store<NJ, 3, false, false>(c, a, store_bf16);
    if (n_tasks == 1 && !obstacle && term)
        return (int)launch_store<NJ, 1, false, true>(c, a, store_bf16);
    if (n_tasks == 1 && obstacle && term)
        return (int)launch_store<NJ, 1, true, true>(c, a, store_bf16);
    if (n_tasks == 3 && !obstacle && term)
        return (int)launch_store<NJ, 3, false, true>(c, a, store_bf16);
    return (int)cudaErrorNotSupported;
}
