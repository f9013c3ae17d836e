// Fused rollout of a spatial arm of 1-8 joints, with gravity, or of a
// planar arm with task terms: the whole horizon in one launch.
//
// Replaces `pallas_rollout3d` / `_rollout3d_kernel` in
// trpo_robot_control_tpu/ops/pallas/rollout3d_kernel.py (fp32 or bf16
// storage). Per env step: forward kinematics from exact
// sincosf, the observation (with the task one-hot when NTASKS > 1), the
// tanh-MLP policy mean, a Gaussian action (caller eps, or Philox4x32-10 +
// paired Box-Muller), the torque clip, then per substep the NJ mass-matrix
// columns and the gravity/Coriolis bias as NJ + 1 world-frame RNEA passes, a
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
// (Box-Muller), or for a planar arm at a uniform angle in the z = 0 plane,
// and with several families a task floor(u n_tasks); drawn
// from Philox with counter (env, t, block, 1), the action normals' being
// (env, t, block, 0), or read from caller-supplied fresh states. The task
// terms and TERM are template switches, so the reach-only non-terminating
// instantiation is the same code as without them.
//
// What bounds it on an H100: neither bytes (54 MB written at c3, 16 us)
// nor FLOPs (~10 GFLOP of MLP plus the dynamics, ~0.5 ms at 67 TFLOP/s)
// but the 200 dependent steps of each env: per substep a chain of FK ->
// RNEA bias pass -> NJxNJ Cholesky -> solve -> Euler step -> sincosf, and per
// step the MLP's hidden layers (two 64-wide at c3-c5) whose weights reach
// every lane as shared-memory broadcasts (each returns a weight to all 32
// lanes, so the load-return path bounds the MLP); and instruction fetch,
// since one warp alone runs most of that chain's code.
//
// Design: warp roles. A block holds 32 envs (one per lane, so every
// feature-first store is a 128-byte row) and NJ + 1 warps (8 at NJ = 7):
// - the state warp (warp NJ) keeps each env's target and task in
//   registers and its q and qd in shared memory, and alone does the
//   env's serial work once: the FK, the bias pass (real velocity,
//   gravity, zero acceleration), the Cholesky and both solves, the
//   integration, the observation, the score, the done test and the
//   fresh episode;
// - column warp j < NJ computes mass-matrix column j with a pass
//   specialised to what is not structurally zero: with qd = 0, unit qdd_j
//   and no gravity every angular velocity is zero and every quantity of
//   joints before j vanishes, so the pass starts at joint j, carries no
//   w terms, and below j only carries the force's moment down to the
//   joints whose torques column j needs (tau_i, i <= j). The column
//   warps also run the policy MLP, layer by layer (each layer's units
//   split as evenly as they go, 64 at NJ = 7 9/9/9/9/9/9/10, at NJ = 3
//   21/21/22; warp m forms action m), through two activation buffers
//   used in turn, the sincosf of the new q (warp j: joint j) and, in
//   Philox mode, the next step's action normals (warp NJ - 1, while the
//   state warp finishes the step).
// Shared memory carries the rest: per joint R, p, axis and the pass-
// independent r = p_i - p_{i-1}, d = R com and (p + d) - p that every
// pass reads (written once by the state warp), q, qd and cos/sin q (the
// observation's rows), the normals, the actions and the upper triangle of
// M. The roles meet at named producer/consumer barriers (bar.arrive on one
// side, bar.sync on the other; see BAR_*), so at substep 0 the state warp
// runs the bias pass and the Cholesky (neither needs the action) while the
// column warps run their columns and then the MLP. The joint loops (FK,
// bias pass, column passes) are rolled, with their per-joint carries in
// shared memory: unrolled, the code outgrew the instruction cache, and the
// state warp, whose code no other warp shares, stalled on instruction
// fetch. The launch bounds ask for as many resident blocks as make 16
// warps an SM, or as many as the block's shared memory lets in where that
// is fewer (`min_blocks`): at NJ = 7 and 8 two blocks (16 and 18 warps,
// under 128 registers), at NJ = 3 three (12 warps; four would need 252 KB
// of the SM's 228), so one block's idle column warps leave the issue
// slots to the others'.
//
// Instantiations: one library per joint count, built with -DTRPO_NJ=<n>
// (n = 1..8, ops/cuda/build.py), each holding the six (task families,
// obstacle) pairs (1, 2 or 3 families, obstacle off or on), each
// terminating or not, each with fp32 or bf16 stores; and per policy
// shape, -DTRPO_H<l> (policy_shape.cuh: 1-3 hidden layers of 1-128 units,
// (64, 64) without it). Every layer's weights stay in shared memory: a
// third 64-wide layer adds 21 KB a block at NJ = 7, so one block fits an
// SM there instead of two. The wide form (WIDE: a layer over 64 units,
// the TPU kernel's unpacked `_policy_ff`) sizes each activation buffer by
// the widest layer it holds (H0 layers 0 and 2, H1 layer 1), which keeps
// rllab's (100, 50, 25) at two blocks an SM at NJ = 7 (about 111 KB a
// block); where the layout still outgrows one block's 227 KB (three
// 128-wide layers at NJ = 5-8, about 245 KB), the largest
// hidden-to-hidden layer is read from global memory instead (`ldg_layer`:
// a uniform address, one L1 broadcast to the warp per weight) in the same
// fmaf order, so the bits stay. At widths up to 64 the layout is the one
// the packed form had.
//
// Numerics: built with -fmad=false so every multiply and add rounds as
// PyTorch's separate elementwise ops do in the plain version; the
// Cholesky pivots use 1.0f / sqrtf (correctly rounded, as 1 / torch.sqrt
// is), and the push term divides by |d| + 1e-6 as the plain version does;
// the policy MLP uses explicit fmaf in d / k order at every layer, the
// order of the plain version's matrix products. Arm constants arrive
// as kernel arguments already rounded to float32, and products with the
// zero and unit entries of the fixed transforms give the same numbers as
// the plain version's sparse folding of them. The specialised passes
// leave out only terms that are exactly +-0 in the plain version's fused
// sweep, and x + (+-0) = x for every non-zero x, so they give the fused
// sweep's numbers up to the sign of a zero
// (`rollout3d_kernel.mass_bias_split` states them in PyTorch; the CPU
// tests hold it to `_mass_bias_fused` with torch.equal).
//
// C interface (ctypes); returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "policy_shape.cuh"
#include "store.cuh"

namespace {

using policy_shape::Hidden;
using policy_shape::NL;
using policy_shape::Weights;
constexpr int ENVS = 32;       // envs per block, one per lane
constexpr int NJ_MAX = 8;
constexpr int FR = 24;         // floats per joint frame in shared memory
// frame fields: R (row-major), p, axis s, r = p_i - p_{i-1}, d = R com,
// cwd = (p + d) - p
constexpr int F_R = 0, F_P = 9, F_S = 12, F_RR = 15, F_D = 18, F_CWD = 21;
// named barriers (0 is __syncthreads), each but MLP a producer/consumer
// pair, the producers arriving and the consumers waiting: FRAMES (state
// -> column warps: a substep's frames, at substep 0 also the observation
// and the normals), COLS (column warps -> state: the columns), ACT
// (column warps -> state: the actions), MLP (the column warps between the
// policy's layers), Q (state -> column warps: the new q), TRIG (column
// warps -> state: its cos/sin)
constexpr int BAR_FRAMES = 1, BAR_COLS = 2, BAR_ACT = 3, BAR_MLP = 4,
              BAR_Q = 5, BAR_TRIG = 6;
// the wide form (see the header) and the widths it takes
constexpr bool WIDE = policy_shape::WIDE;
static_assert(Hidden::widest() <= 128, "hidden widths up to 128 (ROADMAP B3)");
// the most dynamic shared memory one block may take
constexpr int SMEM_MAX = 232448;

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
    // distributions' q0_noise, qd0_noise, rmin, rmax; a planar arm's fresh
    // targets lie in the z = 0 plane
    float done_dist2, q0_noise, qd0_noise, rmin, rmax;
    int n_substeps;
    bool planar;
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

// Frame fields in shared memory, (field, lane) with a lane stride of ENVS:
// `f` points at field 0 of one joint for this lane.
__device__ __forceinline__ V3 ld3(const float* f, int k) {
    return {f[k * ENVS], f[(k + 1) * ENVS], f[(k + 2) * ENVS]};
}
__device__ __forceinline__ void st3(float* f, int k, V3 v) {
    f[k * ENVS] = v.x;
    f[(k + 1) * ENVS] = v.y;
    f[(k + 2) * ENVS] = v.z;
}
__device__ __forceinline__ void ld9(const float* f, int k, float* R) {
#pragma unroll
    for (int m = 0; m < 9; ++m) R[m] = f[(k + m) * ENVS];
}

// Forward kinematics in fk3's operation order, one joint per iteration:
// reads cos/sin of q_i from `cs` (rows i and NJ + i, this lane's), writes
// joint i's frame and the pass-independent vectors every RNEA pass reads
// to `fr` (this lane's field 0 of joint 0) and returns the end effector.
template <int NJ>
__device__ __forceinline__ V3 fk_store(const Arm3D& c, const float* cs,
                                       float* fr) {
    float Rp[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    V3 pp = {0.f, 0.f, 0.f};
#pragma unroll 1
    for (int i = 0; i < NJ; ++i) {
        const float cq = cs[i * ENVS], sq = cs[(NJ + i) * ENVS];
        const float* T = c.T_rot[i];
        float A[9];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
            for (int k = 0; k < 3; ++k)
                A[3 * r + k] = Rp[3 * r] * T[k] + Rp[3 * r + 1] * T[3 + k]
                             + Rp[3 * r + 2] * T[6 + k];
        const V3 p = vadd(pp, mvec_c(Rp, c.T_pos[i]));
#pragma unroll
        for (int r = 0; r < 3; ++r) {
            Rp[3 * r] = A[3 * r] * cq + A[3 * r + 1] * sq;
            Rp[3 * r + 1] = -A[3 * r] * sq + A[3 * r + 1] * cq;
            Rp[3 * r + 2] = A[3 * r + 2];
        }
        const V3 d = mvec_c(Rp, c.com[i]);
        float* f = fr + i * FR * ENVS;
#pragma unroll
        for (int m = 0; m < 9; ++m) f[(F_R + m) * ENVS] = Rp[m];
        st3(f, F_P, p);
        st3(f, F_S, V3{A[2], A[5], A[8]});
        st3(f, F_RR, vsub(p, pp));
        st3(f, F_D, d);
        st3(f, F_CWD, vsub(vadd(p, d), p));
        pp = p;
    }
    return vadd(pp, mvec_c(Rp, c.ee));
}

// One step of the backward recursion at a joint: the child's force fc and
// moment nc (zero below the last joint, whose child offset rc reads 0)
// become this joint's.
__device__ __forceinline__ void backward_step(V3 F, V3 N, V3 cwd, V3 rc,
                                              V3& fc, V3& nc) {
    const V3 fi = vadd(F, fc);
    nc = vadd(vadd(N, nc), vadd(vcross(cwd, F), vcross(rc, fc)));
    fc = fi;
}

// The bias pass (real qd, qdd = 0, gravity) of the fused sweep without its
// qdd terms: qd from `qd` (row i, this lane's); F_i and N_i go through
// `fn` (6 rows a joint) to the backward loop, tau_i to bias (row i).
template <int NJ>
__device__ __forceinline__ void bias_pass(const Arm3D& c, const float* fr,
                                          const float* qd, float* fn,
                                          float* bias) {
    V3 w = {0.f, 0.f, 0.f}, wd = {0.f, 0.f, 0.f};
    V3 a = {0.f, 0.f, c.gravity};
#pragma unroll 1
    for (int i = 0; i < NJ; ++i) {
        const float* f = fr + i * FR * ENVS;
        float R[9];
        ld9(f, F_R, R);
        const V3 s = ld3(f, F_S), r = ld3(f, F_RR), d = ld3(f, F_D);
        const V3 qs = vscale(qd[i * ENVS], s);
        a = vadd(a, vadd(vcross(wd, r), vcross(w, vcross(w, r))));
        const V3 w_i = vadd(w, qs);
        wd = vadd(wd, vcross(w, qs));
        w = w_i;
        const V3 ac = vadd(a, vadd(vcross(wd, d), vcross(w, vcross(w, d))));
        float* g = fn + 6 * i * ENVS;
        st3(g, 0, vscale(c.mass[i], ac));
        st3(g, 3, vadd(inertia_vec(R, c.inertia[i], wd),
                       vcross(w, inertia_vec(R, c.inertia[i], w))));
    }
    V3 fc = {0.f, 0.f, 0.f}, nc = {0.f, 0.f, 0.f};
#pragma unroll 1
    for (int i = NJ - 1; i >= 0; --i) {
        const float* f = fr + i * FR * ENVS;
        const float* g = fn + 6 * i * ENVS;
        backward_step(ld3(g, 0), ld3(g, 3), ld3(f, F_CWD),
                      ld3(f + FR * ENVS, F_RR), fc, nc);
        bias[i * ENVS] = vdot(ld3(f, F_S), nc);
    }
}

// Column j of the mass matrix (qd = 0, qdd = e_j, no gravity) from the
// joints' frames: every w is zero, wd = s_j from joint j on, so
// a_i = a_{i-1} + s_j x r_i (a_j = 0; through `as`, 3 rows a joint from
// joint j on), ac_i = a_i + s_j x d_i, N_i = I_i(s_j); below joint j the
// force and moment are zero, so only the child's moment is carried down.
// Writes tau_i, i <= j, to the upper triangle m[tri(i, j)].
template <int NJ>
__device__ __forceinline__ void column_pass(const Arm3D& c, const float* fr,
                                            int j, float* as, float* m) {
    const V3 s = ld3(fr + j * FR * ENVS, F_S);
    V3 a = {0.f, 0.f, 0.f};
    st3(as, 0, a);
#pragma unroll 1
    for (int i = j + 1; i < NJ; ++i) {
        a = vadd(a, vcross(s, ld3(fr + i * FR * ENVS, F_RR)));
        st3(as + 3 * (i - j) * ENVS, 0, a);
    }
    V3 fc = {0.f, 0.f, 0.f}, nc = {0.f, 0.f, 0.f};
    float* col = m + (j * (j + 1) / 2) * ENVS;
#pragma unroll 1
    for (int i = NJ - 1; i >= 0; --i) {
        const float* f = fr + i * FR * ENVS;
        const V3 rc = ld3(f + FR * ENVS, F_RR);
        if (i >= j) {
            float R[9];
            ld9(f, F_R, R);
            const V3 ai = ld3(as + 3 * (i - j) * ENVS, 0);
            const V3 F = vscale(c.mass[i], vadd(ai, vcross(s, ld3(f, F_D))));
            backward_step(F, inertia_vec(R, c.inertia[i], s), ld3(f, F_CWD),
                          rc, fc, nc);
        } else {                         // F = N = 0 below joint j
            nc = vadd(nc, vcross(rc, fc));
        }
        if (i <= j) col[i * ENVS] = vdot(ld3(f, F_S), nc);
    }
}

// cos and sin of q (rows i, this lane's) to rows i and NJ + i of `cs`.
template <int NJ>
__device__ __forceinline__ void sincos_rows(const float* q, float* cs) {
#pragma unroll 1
    for (int i = 0; i < NJ; ++i) {
        float sn, cn;
        sincosf(q[i * ENVS], &sn, &cn);
        cs[i * ENVS] = cn;
        cs[(NJ + i) * ENVS] = sn;
    }
}

// The reward of one env at the post-step state: -(|ee - tgt|^2 + ctrl_weight
// sum tau^2), minus the push penalty for task 2 and the obstacle penalty,
// in the plain version's operation order; p and axis from the frames, qd
// from rows i of `qd`.
template <int NJ, int NTASKS, bool OBST>
__device__ __forceinline__ float score(const Arm3D& c, const float* fr,
                                       V3 ee, const float* qd, V3 tgt,
                                       int task, float ctrl) {
    V3 d = vsub(ee, tgt);
    float r = -(vdot(d, d) + c.ctrl_weight * ctrl);
    if (NTASKS > 2 && task == 2) {
        V3 v = {0.f, 0.f, 0.f};
#pragma unroll 1
        for (int i = 0; i < NJ; ++i) {
            const float* f = fr + i * FR * ENVS;
            v = vadd(v, vscale(qd[i * ENVS], vcross(ld3(f, F_S),
                                                   vsub(ee, ld3(f, F_P)))));
        }
        const float dn = sqrtf(vdot(d, d)) + 1e-6f;
        const V3 dirn = {-d.x / dn, -d.y / dn, -d.z / dn};
        const V3 verr = vsub(v, vscale(c.push_speed, dirn));
        r = r - c.push_weight * vdot(verr, verr);
    }
    if (OBST) {
        float pen = 0.f;
#pragma unroll 1
        for (int i = 1; i <= NJ; ++i) {
            const V3 pt = (i < NJ) ? ld3(fr + i * FR * ENVS, F_P) : ee;
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
// u[2 NJ], the direction's Box-Muller pairs u[2 NJ + 1 .. 2 NJ + 4] (a
// planar arm's angle 2 pi u[2 NJ + 1]), task u[2 NJ + 5].
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
    if (c.planar) {
        sincosf(TWO_PI * u[2 * NJ + 1], &s, &cs);
        tgt = {r * cs, r * s, 0.f};
        if (NTASKS > 1) task = (int)(u[2 * NJ + 5] * (float)NTASKS);
        return;
    }
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

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// Shared-memory layout in floats (dynamic shared memory; every per-env
// array is (row, lane)). Hidden layer l's weights and bias are padded per
// column warp: slot (w, u), u < upad(l), holds unit first(w) + u, with
// first(w) = w H_l / NJ, or 0 beyond the warp's units; upad rounds the
// most units a warp takes (umax) up to 16 bytes. Layer l's block is its
// in(l) weight rows of slots(l) floats and then its bias row, the layers'
// blocks one after another. The frames have a joint slot NJ whose r stays
// 0, the last joint's child offset.
template <int DO>
__host__ __device__ constexpr int layer_in(int l) {
    return l == 0 ? DO : Hidden::width(l - 1);
}
template <int NJ>
__host__ __device__ constexpr int umax(int l) {
    return (Hidden::width(l) + NJ - 1) / NJ;
}
template <int NJ>
__host__ __device__ constexpr int upad(int l) {
    return (umax<NJ>(l) + 3) / 4 * 4;
}
template <int NJ>
__host__ __device__ constexpr int slots(int l) {
    return NJ * upad<NJ>(l);
}
// floats of hidden layer l's block
template <int NJ, int DO>
__host__ __device__ constexpr int layer_floats(int l) {
    return (layer_in<DO>(l) + 1) * slots<NJ>(l);
}
// offset of hidden layer l's block (l = NL: the end of the last one) when
// layer `skip`'s (read from global memory) is left out
template <int NJ, int DO>
__host__ __device__ constexpr int layers_before(int l, int skip) {
    int off = 0;
    for (int m = 0; m < l; ++m)
        if (m != skip) off += layer_floats<NJ, DO>(m);
    return off;
}

// the layout with layer SKIP's weights in global memory (-1: none)
template <int NJ, int DO, int SKIP>
struct Layout {
    static constexpr int HL = Hidden::width(NL - 1);   // the head's inputs
    static constexpr int W2 = layers_before<NJ, DO>(NL, SKIP);  // (HL, NJ)
    static constexpr int B2 = W2 + HL * NJ;
    static constexpr int OBS = B2 + ((NJ + 7) / 8) * 8;
    // activations of the even and the odd hidden layers, each as wide as
    // the widest layer (the wide form: the widest layer it holds)
    static constexpr int HW0 =
        !WIDE ? Hidden::widest()
        : (NL > 2 && Hidden::width(2) > Hidden::width(0) ? Hidden::width(2)
                                                         : Hidden::width(0));
    static constexpr int HW1 =
        NL < 2 ? 0 : !WIDE ? Hidden::widest() : Hidden::width(1);
    static constexpr int H0 = OBS + DO * ENVS;
    static constexpr int H1 = H0 + HW0 * ENVS;
    static constexpr int Z = H1 + HW1 * ENVS;
    static constexpr int ACT = Z + NJ * ENVS;
    static constexpr int FRAME = ACT + NJ * ENVS;
    static constexpr int M = FRAME + (NJ + 1) * FR * ENVS;
    static constexpr int Q = M + (NJ * (NJ + 1) / 2) * ENVS;   // q
    static constexpr int QD = Q + NJ * ENVS;                   // qd
    static constexpr int FN = QD + NJ * ENVS;      // bias pass F_i, N_i
    static constexpr int BIAS = FN + 6 * NJ * ENVS;
    // column warp j's a_i, i >= j: NJ - j joints from joint j * NJ -
    // j (j - 1) / 2 on
    static constexpr int AS = BIAS + NJ * ENVS;
    static constexpr int END = AS + 3 * (NJ * (NJ + 1) / 2) * ENVS;
    static constexpr size_t BYTES = END * sizeof(float);
    static_assert(slots<NJ>(0) % 4 == 0 && W2 % 4 == 0,
                  "weight slices stay 16-byte aligned");
};

// The hidden layer whose weights the wide form reads from global memory,
// or -1: none while every layer fits one block's shared memory, else the
// largest hidden-to-hidden layer (the first of two as large).
template <int NJ, int DO>
__host__ __device__ constexpr int ldg_layer() {
    if (!WIDE || Layout<NJ, DO, -1>::BYTES <= SMEM_MAX) return -1;
    int best = -1, size = 0;
    for (int l = 1; l < NL; ++l)
        if (layer_floats<NJ, DO>(l) > size) {
            best = l;
            size = layer_floats<NJ, DO>(l);
        }
    return best;
}

template <int NJ, int DO>
__host__ __device__ constexpr int layer_off(int l) {
    return layers_before<NJ, DO>(l, ldg_layer<NJ, DO>());
}

template <int NJ, int DO>
struct Smem : Layout<NJ, DO, ldg_layer<NJ, DO>()> {
    static_assert(Layout<NJ, DO, ldg_layer<NJ, DO>()>::BYTES <= SMEM_MAX,
                  "the layout fits one block's shared memory");
};

// Resident blocks the launch bounds ask for: enough for 16 warps an SM,
// or as many as the SM's 228 KB of shared memory hold (1 KB of it kept
// per block) where that is fewer; at least one.
template <int NJ, int DO>
__host__ __device__ constexpr int min_blocks() {
    constexpr int want = (16 + NJ) / (NJ + 1);
    constexpr int fit = (int)(233472 / (Smem<NJ, DO>::BYTES + 1024));
    return want < fit ? want : (fit > 0 ? fit : 1);
}

template <int NJ, int NTASKS>
__host__ __device__ constexpr int obs_dim() {
    return 3 * NJ + 3 + (NTASKS > 1 ? NTASKS : 0);
}

// U hidden units of one layer for this lane: z_u = sum_d in[d] W[d][u]
// (fmaf in d order; in is (d, lane)) from the warp's padded weight slice
// (row stride STRIDE), then tanh(z + b) to out (unit, lane) for the warp's
// cnt <= U units (one code for every column warp).
template <int U, int DIN, int STRIDE>
__device__ __forceinline__ void layer_units(const float* in, const float* W,
                                            const float* b, int first,
                                            int cnt, float* out, int lane) {
    float z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) z[u] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DIN; ++d) {
        const float x = in[d * ENVS + lane];
#pragma unroll
        for (int u = 0; u < U; ++u)
            z[u] = fmaf(x, W[d * STRIDE + u], z[u]);
    }
    float* o = out + first * ENVS + lane;
#pragma unroll
    for (int u = 0; u < U; ++u)
        if (u < cnt) o[u * ENVS] = z[u];
#pragma unroll 1
    for (int u = 0; u < cnt; ++u) o[u * ENVS] = tanhf(o[u * ENVS] + b[u]);
}

// layer_units with the weights and bias read from global memory:
// W (in, H) row-major and b (H), units first .. first + cnt - 1, in the
// same fmaf order (for ldg_layer)
template <int U, int DIN, int H>
__device__ __forceinline__ void layer_units_ldg(const float* in,
                                                const float* __restrict__ W,
                                                const float* __restrict__ b,
                                                int first, int cnt, float* out,
                                                int lane) {
    float z[U];
#pragma unroll
    for (int u = 0; u < U; ++u) z[u] = 0.f;
    const float* w = W + first;
#pragma unroll 4
    for (int d = 0; d < DIN; ++d) {
        const float x = in[d * ENVS + lane];
#pragma unroll
        for (int u = 0; u < U; ++u)
            if (u < cnt) z[u] = fmaf(x, __ldg(w + d * H + u), z[u]);
    }
    float* o = out + first * ENVS + lane;
#pragma unroll
    for (int u = 0; u < U; ++u)
        if (u < cnt) o[u * ENVS] = z[u];
#pragma unroll 1
    for (int u = 0; u < cnt; ++u)
        o[u * ENVS] = tanhf(o[u * ENVS] + __ldg(b + first + u));
}

// Hidden layer l's weights and bias into their padded block (none for
// the layer read from global memory).
template <int NJ, int DO, int NT, int l>
__device__ __forceinline__ void stage_layer(const Weights& p, float* smem) {
    if constexpr (l == ldg_layer<NJ, DO>()) return;
    constexpr int Hl = Hidden::width(l), IN = layer_in<DO>(l);
    constexpr int S = slots<NJ>(l), UP = upad<NJ>(l);
    float* blk = smem + layer_off<NJ, DO>(l);
    for (int i = threadIdx.x; i < (IN + 1) * S; i += NT) {
        const int row = i / S, w = (i % S) / UP, u = i % UP;
        const int first = w * Hl / NJ, cnt = (w + 1) * Hl / NJ - first;
        float v = 0.f;
        if (u < cnt) {
            const int k = first + u;
            v = row < IN ? p.W[l][row * Hl + k] : p.b[l][k];
        }
        blk[i] = v;
    }
}

// Hidden layer l for column warp j: layer 0 reads the observation, layer
// l > 0 the buffer layer l - 1 wrote; even layers write H0, odd ones H1.
template <int NJ, int DO, int l>
__device__ __forceinline__ void mlp_layer(const Weights& pol,
                                          const float* smem, const float* sObs,
                                          float* sH0, float* sH1, int j,
                                          int lane) {
    constexpr int Hl = Hidden::width(l), IN = layer_in<DO>(l);
    constexpr int S = slots<NJ>(l), UP = upad<NJ>(l);
    const int first = j * Hl / NJ, cnt = (j + 1) * Hl / NJ - first;
    const float* in = l == 0 ? sObs : (l % 2 ? sH0 : sH1);
    float* out = l % 2 ? sH1 : sH0;
    if constexpr (l == ldg_layer<NJ, DO>()) {
        layer_units_ldg<umax<NJ>(l), IN, Hl>(in, pol.W[l], pol.b[l], first,
                                             cnt, out, lane);
    } else {
        const float* blk = smem + layer_off<NJ, DO>(l);
        layer_units<umax<NJ>(l), IN, S>(in, blk + j * UP,
                                        blk + IN * S + j * UP, first, cnt,
                                        out, lane);
    }
}

template <int NJ, int NTASKS, bool OBST, bool TERM, typename Out>
__global__ void __launch_bounds__((NJ + 1) * ENVS,
                                  min_blocks<NJ, obs_dim<NJ, NTASKS>()>())
rollout3d_kernel(
    Arm3D c, const float* __restrict__ q0, const float* __restrict__ qd0,
    const float* __restrict__ tgt0, const int* __restrict__ task0,
    Weights pol, const float* __restrict__ eps,
    const int64_t* __restrict__ seed,
    const float* __restrict__ fq, const float* __restrict__ fqd,
    const float* __restrict__ ftgt, const int* __restrict__ ftask,
    Out* __restrict__ obs, Out* __restrict__ act, float* __restrict__ rew,
    float* __restrict__ dones, int N, int T) {
    constexpr int NW = NJ + 1;
    constexpr int NT = NW * ENVS;
    constexpr int NCT = NJ * ENVS;       // column warps' threads
    constexpr int DO = obs_dim<NJ, NTASKS>();
    using L = Smem<NJ, DO>;
    extern __shared__ float smem[];
    float* sW2 = smem + L::W2;
    float* sb2 = smem + L::B2;
    float* sObs = smem + L::OBS;
    float* sH0 = smem + L::H0;
    float* sH1 = smem + L::H1;
    const float* sHL = (NL - 1) % 2 ? sH1 : sH0;    // the head's inputs
    float* sZ = smem + L::Z;
    float* sAct = smem + L::ACT;
    float* sM = smem + L::M;
    stage_layer<NJ, DO, NT, 0>(pol, smem);
    if constexpr (NL > 1) stage_layer<NJ, DO, NT, 1>(pol, smem);
    if constexpr (NL > 2) stage_layer<NJ, DO, NT, 2>(pol, smem);
    for (int i = threadIdx.x; i < L::HL * NJ; i += NT) sW2[i] = pol.W[NL][i];
    if (threadIdx.x < NJ) sb2[threadIdx.x] = pol.b[NL][threadIdx.x];

    const int lane = threadIdx.x % ENVS;
    const int wid = threadIdx.x / ENVS;
    const int e_raw = blockIdx.x * ENVS + lane;
    const bool live = e_raw < N;
    const int e = live ? e_raw : N - 1;          // padded lanes shadow env N-1
    float* fr = smem + L::FRAME + lane;
    float* q = smem + L::Q + lane;
    float* cs = sObs + lane;             // cos q, sin q: the obs's rows
    uint2 key = make_uint2(0u, 0u);
    if (eps == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);
    __syncthreads();                     // the weights are in place

    if (wid == NJ) {
        // ------------------------------------------------- the state warp
        float* qd = smem + L::QD + lane;
        float* fn = smem + L::FN + lane;
        float* bias = smem + L::BIAS + lane;
        st3(fr + NJ * FR * ENVS, F_RR, V3{0.f, 0.f, 0.f});
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            q[i * ENVS] = q0[i * N + e];
            qd[i * ENVS] = qd0[i * N + e];
        }
        V3 tgt = {tgt0[e], tgt0[N + e], tgt0[2 * N + e]};
        int task = (NTASKS > 1) ? task0[e] : 0;     // changes only at a reset
        sincos_rows<NJ>(q, cs);
        V3 ee = fk_store<NJ>(c, cs, fr);
        float ctrl = 0.f;
        for (int t = 0; t <= T; ++t) {
            // the rest of this step's observation, then its frames go
#pragma unroll 1
            for (int i = 0; i < NJ; ++i)
                cs[(2 * NJ + i) * ENVS] = c.qd_obs_scale * qd[i * ENVS];
            cs[(3 * NJ) * ENVS] = tgt.x - ee.x;
            cs[(3 * NJ + 1) * ENVS] = tgt.y - ee.y;
            cs[(3 * NJ + 2) * ENVS] = tgt.z - ee.z;
#pragma unroll
            for (int k = 0; k < DO - 3 * NJ - 3; ++k)
                cs[(3 * NJ + 3 + k) * ENVS] = (task == k) ? 1.f : 0.f;
            bar_arrive(BAR_FRAMES, NT);
            // without resets the previous step's frames, qd, target and
            // ctrl stay in place until this step's actions arrive, so its
            // reward is scored here, off the chain
            if (!TERM && t > 0 && live)
                rew[(size_t)(t - 1) * N + e] =
                    score<NJ, NTASKS, OBST>(c, fr, ee, qd, tgt, task, ctrl);
            if (t == T) break;

            for (int s = 0; s < c.n_substeps; ++s) {
                if (s > 0) {
                    fk_store<NJ>(c, cs, fr);
                    bar_arrive(BAR_FRAMES, NT);   // substep s's frames
                }
                bias_pass<NJ>(c, fr, qd, fn, bias);
                bar_sync(BAR_COLS, NT);  // the columns are in sM
#define MUP(i, k) sM[((k) * ((k) + 1) / 2 + (i)) * ENVS + lane]
                float L_[NJ][NJ], inv_d[NJ];
#pragma unroll
                for (int jj = 0; jj < NJ; ++jj) {
                    float sacc = MUP(jj, jj) + c.chol_reg;
#pragma unroll
                    for (int k = 0; k < jj; ++k)
                        sacc = sacc - L_[jj][k] * L_[jj][k];
                    const float inv = 1.0f / sqrtf(sacc);
                    inv_d[jj] = inv;
                    L_[jj][jj] = sacc * inv;
#pragma unroll
                    for (int i = jj + 1; i < NJ; ++i) {
                        float tt = MUP(jj, i);
#pragma unroll
                        for (int k = 0; k < jj; ++k)
                            tt = tt - L_[i][k] * L_[jj][k];
                        L_[i][jj] = tt * inv;
                    }
                }
#undef MUP
                if (s == 0) {
                    bar_sync(BAR_ACT, NT);   // the actions are in sAct
#pragma unroll
                    for (int i = 0; i < NJ; ++i) {
                        const float tq = fminf(fmaxf(sAct[i * ENVS + lane],
                                                     -c.torque_limit),
                                               c.torque_limit);
                        ctrl = (i == 0) ? tq * tq : ctrl + tq * tq;
                    }
                }
                float y[NJ], x[NJ];
#pragma unroll
                for (int i = 0; i < NJ; ++i) {
                    const float tq = fminf(fmaxf(sAct[i * ENVS + lane],
                                                 -c.torque_limit),
                                           c.torque_limit);
                    float sacc = (tq - bias[i * ENVS]) - c.damping * qd[i * ENVS];
#pragma unroll
                    for (int k = 0; k < i; ++k) sacc = sacc - L_[i][k] * y[k];
                    y[i] = sacc * inv_d[i];
                }
#pragma unroll
                for (int i = NJ - 1; i >= 0; --i) {
                    float sacc = y[i];
#pragma unroll
                    for (int k = i + 1; k < NJ; ++k)
                        sacc = sacc - L_[k][i] * x[k];
                    x[i] = sacc * inv_d[i];
                }
#pragma unroll
                for (int i = 0; i < NJ; ++i) {
                    const float v = fminf(fmaxf(qd[i * ENVS] + c.h * x[i],
                                                -c.qd_limit), c.qd_limit);
                    qd[i * ENVS] = v;
                    q[i * ENVS] = q[i * ENVS] + c.h * v;
                }
                bar_arrive(BAR_Q, NT);   // column warp i: cos/sin of q_i
                bar_sync(BAR_TRIG, NT);
            }
            if (NTASKS > 1 && task == 1) {   // the track target moves first
                const float tx = c.track_cos * tgt.x - c.track_sin * tgt.y;
                const float ty = c.track_sin * tgt.x + c.track_cos * tgt.y;
                tgt.x = tx;
                tgt.y = ty;
            }
            ee = fk_store<NJ>(c, cs, fr);   // the reward, next step's obs
            if (TERM) {                 // scored before a reset moves it
                if (live)
                    rew[(size_t)t * N + e] = score<NJ, NTASKS, OBST>(
                        c, fr, ee, qd, tgt, task, ctrl);
                const V3 d = vsub(ee, tgt);
                const bool done = vdot(d, d) < c.done_dist2;
                if (live) dones[(size_t)t * N + e] = done ? 1.f : 0.f;
                if (__any_sync(0xffffffffu, done)) {
                    if (done) {
                        float qn[NJ], qdn[NJ];
                        fresh_episode<NJ, NTASKS>(c, key, e, t, N, fq, fqd,
                                                  ftgt, ftask, qn, qdn, tgt,
                                                  task);
#pragma unroll
                        for (int i = 0; i < NJ; ++i) {
                            q[i * ENVS] = qn[i];
                            qd[i * ENVS] = qdn[i];
                        }
                    }
                    __syncwarp();
                    // the other lanes recompute their own unchanged values
                    sincos_rows<NJ>(q, cs);
                    ee = fk_store<NJ>(c, cs, fr);
                }
            }
        }
    } else {
        // ------------------------------------------------ a column warp
        const int j = wid;
        const float sigma = expf(pol.logstd[j]);
        float* as = smem + L::AS + 3 * (j * NJ - j * (j - 1) / 2) * ENVS
                  + lane;
        // the action normals, drawn by the last column warp a step ahead
        // while the state warp finishes the step
        const bool draws = eps == nullptr && j == NJ - 1;
        if (draws) {
            float zz[NJ];
            normals<NJ>(key, (uint32_t)e, 0u, zz);
#pragma unroll
            for (int i = 0; i < NJ; ++i) sZ[i * ENVS + lane] = zz[i];
        }
        bar_sync(BAR_FRAMES, NT);        // step 0's inputs are in place
        for (int t = 0; t < T; ++t) {
            for (int s = 0; s < c.n_substeps; ++s) {
                column_pass<NJ>(c, fr, j, as, sM + lane);
                bar_arrive(BAR_COLS, NT);
                if (s == 0) {
                    // policy layer 0; this warp stores observation rows
                    // d = j (mod NJ)
                    if (live) {
#pragma unroll 1
                        for (int d = j; d < DO; d += NJ)
                            obs[((size_t)t * DO + d) * N + e] =
                                store_cast<Out>(sObs[d * ENVS + lane]);
                    }
                    mlp_layer<NJ, DO, 0>(pol, smem, sObs, sH0, sH1, j, lane);
                    bar_sync(BAR_MLP, NCT);
                    if constexpr (NL > 1) {
                        mlp_layer<NJ, DO, 1>(pol, smem, sObs, sH0, sH1,
                                             j, lane);
                        bar_sync(BAR_MLP, NCT);
                    }
                    if constexpr (NL > 2) {
                        mlp_layer<NJ, DO, 2>(pol, smem, sObs, sH0, sH1,
                                             j, lane);
                        bar_sync(BAR_MLP, NCT);
                    }
                    // action j: mean, noise, store
                    float mu = 0.f;
#pragma unroll 8
                    for (int k = 0; k < L::HL; ++k)
                        mu = fmaf(sHL[k * ENVS + lane], sW2[k * NJ + j], mu);
                    const float zn = (eps != nullptr)
                                         ? eps[((size_t)t * NJ + j) * N + e]
                                         : sZ[j * ENVS + lane];
                    const float a = (mu + sb2[j]) + sigma * zn;
                    if (live)
                        act[((size_t)t * NJ + j) * N + e] = store_cast<Out>(a);
                    sAct[j * ENVS + lane] = a;
                    bar_arrive(BAR_ACT, NT);
                }
                bar_sync(BAR_Q, NT);     // cos/sin of the new q_j
                {
                    float sn, cn;
                    sincosf(q[j * ENVS], &sn, &cn);
                    cs[j * ENVS] = cn;
                    cs[(NJ + j) * ENVS] = sn;
                }
                bar_arrive(BAR_TRIG, NT);
                if (s + 1 < c.n_substeps) bar_sync(BAR_FRAMES, NT);
            }
            if (draws && t + 1 < T) {
                float zz[NJ];
                normals<NJ>(key, (uint32_t)e, (uint32_t)(t + 1), zz);
#pragma unroll
                for (int i = 0; i < NJ; ++i) sZ[i * ENVS + lane] = zz[i];
            }
            bar_sync(BAR_FRAMES, NT);    // step t + 1's inputs are in place
        }
    }
}

struct Args {
    const float *q0, *qd0, *tgt;
    const int* task;
    Weights pol;
    const float* eps;
    const int64_t* seed;
    const float *fq, *fqd, *ftgt;
    const int* ftask;
    void *obs, *act;
    float *rew, *dones;
    int N, T;
    cudaStream_t stream;
};

// One instantiation: its kernel and its dynamic shared memory.
template <int NJ, int NTASKS, bool OBST, bool TERM, typename Out_>
struct Inst {
    using Out = Out_;
    static constexpr int THREADS = (NJ + 1) * ENVS;
    static constexpr size_t SMEM = Smem<NJ, obs_dim<NJ, NTASKS>()>::BYTES;
    static auto kernel() {
        return &rollout3d_kernel<NJ, NTASKS, OBST, TERM, Out>;
    }
};

template <int NJ, int NTASKS, bool OBST, bool TERM, typename Op>
cudaError_t with_store(int store_bf16, Op op) {
    return store_bf16 ? op(Inst<NJ, NTASKS, OBST, TERM, __nv_bfloat16>{})
                      : op(Inst<NJ, NTASKS, OBST, TERM, float>{});
}

template <int NJ, int NTASKS, bool OBST, typename Op>
cudaError_t with_term(int terminating, int store_bf16, Op op) {
    return terminating ? with_store<NJ, NTASKS, OBST, true>(store_bf16, op)
                       : with_store<NJ, NTASKS, OBST, false>(store_bf16, op);
}

template <int NJ, int NTASKS, typename Op>
cudaError_t with_obstacle(int obstacle, int terminating, int store_bf16,
                          Op op) {
    return obstacle ? with_term<NJ, NTASKS, true>(terminating, store_bf16, op)
                    : with_term<NJ, NTASKS, false>(terminating, store_bf16, op);
}

#ifndef TRPO_NJ
#error "build with -DTRPO_NJ=<joints> (1..8), one library per joint count"
#endif
static_assert(TRPO_NJ >= 1 && TRPO_NJ <= NJ_MAX, "TRPO_NJ out of range");

// The instantiations of this library: n = TRPO_NJ with 1, 2 or 3 task
// families, the obstacle term off or on, each terminating or not, each
// with fp32 or bf16 stores. Another joint count is cudaErrorInvalidValue,
// another number of task families cudaErrorNotSupported.
template <typename Op>
cudaError_t dispatch(int n_joints, int n_tasks, int obstacle, int terminating,
                     int store_bf16, Op op) {
    if (n_joints != TRPO_NJ) return cudaErrorInvalidValue;
    constexpr int NJ = TRPO_NJ;
    switch (n_tasks) {
        case 1:
            return with_obstacle<NJ, 1>(obstacle, terminating, store_bf16, op);
        case 2:
            return with_obstacle<NJ, 2>(obstacle, terminating, store_bf16, op);
        case 3:
            return with_obstacle<NJ, 3>(obstacle, terminating, store_bf16, op);
        default:
            return cudaErrorNotSupported;
    }
}

template <typename I>
cudaError_t set_smem() {
    return cudaFuncSetAttribute(I::kernel(),
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)I::SMEM);
}

}  // namespace

// consts (host array, float32): T_rot[n][9], T_pos[n][3], mass[n],
// com[n][3], inertia[n][9] (link frame, row-major), ee_offset[3], gravity,
// damping, h = dt / n_substeps, torque_limit, qd_limit, qd_obs_scale,
// ctrl_weight, chol_reg, cos and sin of track_omega * dt, push_speed,
// push_weight, obstacle_weight, obstacle_radius, obstacle_center[3],
// done_dist^2, q0_noise, qd0_noise, rmin, rmax, planar (0 or 1).
// q0/qd0 (n, N), tgt (3, N), task (N) int32 (read when n_tasks > 1);
// eps (T, n, N) or NULL for Philox mode with seed: int64[2] on the device.
// terminating != 0 takes the TERM instantiation, which writes dones (T, N)
// fp32 and takes the fresh episodes from fq/fqd (T, n, N), ftgt (T, 3, N)
// and ftask (T, N) int32, or from Philox when fq is NULL.
// hidden (n_hidden ints, host): the policy's hidden widths, which must be
// this library's (policy_shape.cuh), else cudaErrorInvalidValue; weights (host
// array of device pointers): W0, b0, ..., W_L, b_L, L = n_hidden (W_l
// (in, out) row-major), then logstd (n).
// obs (T, 3n+3 (+ n_tasks when > 1), N) and act (T, n, N) are bf16 when
// store_bf16 != 0, else fp32; rew (T, N) fp32. Instantiated as `dispatch`
// lists; another joint count returns cudaErrorInvalidValue, another number
// of task families cudaErrorNotSupported (the wrapper raises both as
// NotImplementedError before it launches).
extern "C" int trpo_rollout3d_launch(
    const float* consts, int n_joints, int n_substeps, int n_tasks,
    int obstacle, int terminating, int store_bf16, const int* hidden,
    int n_hidden, const float* q0, const float* qd0, const float* tgt,
    const int* task, const float* const* weights, const float* eps,
    const int64_t* seed, const float* fq, const float* fqd,
    const float* ftgt, const int* ftask, void* obs, void* act, float* rew,
    float* dones, int N, int T, void* stream) {
    if (n_joints != TRPO_NJ || !policy_shape::same_shape(hidden, n_hidden))
        return (int)cudaErrorInvalidValue;
    constexpr int NJ = TRPO_NJ;
    const Weights pol = policy_shape::weights_of(weights);
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
    c.planar = s[22] != 0.f;
    c.n_substeps = n_substeps;
    const Args a = {q0, qd0, tgt, task, pol, eps, seed, fq, fqd, ftgt, ftask,
                    obs, act, rew, dones, N, T,
                    static_cast<cudaStream_t>(stream)};
    return (int)dispatch(
        n_joints, n_tasks, obstacle, terminating, store_bf16,
        [&](auto inst) -> cudaError_t {
            using I = decltype(inst);
            cudaError_t err = set_smem<I>();
            if (err != cudaSuccess) return err;
            dim3 grid((a.N + ENVS - 1) / ENVS);
            I::kernel()<<<grid, I::THREADS, I::SMEM, a.stream>>>(
                c, a.q0, a.qd0, a.tgt, a.task, a.pol, a.eps, a.seed, a.fq,
                a.fqd, a.ftgt, a.ftask,
                static_cast<typename I::Out*>(a.obs),
                static_cast<typename I::Out*>(a.act), a.rew, a.dones, a.N,
                a.T);
            return cudaGetLastError();
        });
}

// What the card makes of an instantiation: out[0] resident blocks per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor at its block size and
// dynamic shared memory), out[1] registers per thread, out[2] local
// (spill) bytes per thread, out[3] dynamic and out[4] static shared bytes
// per block, out[5] threads per block. Same dispatch and return codes as
// trpo_rollout3d_launch.
extern "C" int trpo_rollout3d_occupancy(int n_joints, int n_tasks,
                                        int obstacle, int terminating,
                                        int store_bf16, int* out) {
    return (int)dispatch(
        n_joints, n_tasks, obstacle, terminating, store_bf16,
        [&](auto inst) -> cudaError_t {
            using I = decltype(inst);
            cudaError_t err = set_smem<I>();
            if (err != cudaSuccess) return err;
            int blocks = 0;
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &blocks, I::kernel(), I::THREADS, I::SMEM);
            if (err != cudaSuccess) return err;
            cudaFuncAttributes fa;
            err = cudaFuncGetAttributes(&fa, I::kernel());
            if (err != cudaSuccess) return err;
            out[0] = blocks;
            out[1] = fa.numRegs;
            out[2] = (int)fa.localSizeBytes;
            out[3] = (int)I::SMEM;
            out[4] = (int)fa.sharedSizeBytes;
            out[5] = I::THREADS;
            return cudaSuccess;
        });
}
