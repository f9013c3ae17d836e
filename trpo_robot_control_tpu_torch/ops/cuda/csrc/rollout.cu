// Fused planar-arm rollout: the whole horizon in one launch.
//
// Replaces `pallas_rollout` (trpo_robot_control_tpu/ops/pallas/
// rollout_kernel.py:490, its pallas_call at :594; body `_rollout_kernel`)
// for 1-8 links and any tanh policy of 1-3 hidden layers of 1-128 units
// (policy_shape.cuh; the JAX package's (64, 64) without -DTRPO_H<l>), with
// obs and actions stored in fp32 or, as its
// store_dtype=bf16 does, in bf16 (rounded once at the store; the
// trajectory, rewards and done flags stay fp32). Per env step: forward
// kinematics, the closed-form
// planar mass matrix and centripetal bias, an unrolled Cholesky solve,
// semi-implicit Euler over n_substeps, the tanh-MLP policy mean, a Gaussian
// action (caller-supplied eps, or Philox4x32-10 + paired Box-Muller), the
// torque clip and the reward at the post-step state. The terminating
// instantiation (TERM, the TPU kernel's `terminating` branch) then flags
// an env done when its post-step end effector is within done_dist of the
// target and gives it a fresh episode: q and qd uniform in +-noise, the
// target at a uniform radius in [rmin, rmax] and a uniform angle, drawn
// from Philox with counter (env, t, block, 1) (the action normals use
// (env, t, block, 0), so the action noise is the same whether the env
// terminates or not), or read from caller-supplied fresh states. TERM is a
// template switch: the non-terminating instantiation is the same code as
// without it.
//
// What bounds it on an H100: not bytes (6.6 MB written at c2, ~2 us) and
// not FLOPs (~1 GFLOP of fp32 FMA, ~15 us at 67 TFLOP/s) but the T
// dependent steps of each env, and how much of each step's latency the
// SMs hide. One step's critical path is the policy (a DO-long dependent
// fmaf chain, a w_{l-1}-long one for each further hidden layer l, then the
// mean over the last layer's w units; a tanhf a layer: at (64, 64) a
// layer-1 unit's 64-long chain and the mean's) and then the dynamics that
// make the next observation
// (solve, Euler step, the trig of FK). c2's 1024 envs are ~8 per SM, so
// the card has no other work to hide that latency behind.
//
// Design: a block holds ENVS = 8 envs (c2: 128 blocks, one per SM; c1: 8)
// in five warps whose roles meet at named barriers (BAR_*):
// - four MLP warps: MLP warp g takes the env pair g, and its lane j hidden
//   units j and j + 32 of each layer where they exist (one unit at widths
//   up to 32; at width 33 lanes 1-31 idle in the second): up to four
//   independent chains a thread, each term's input one 8-byte
//   shared-memory broadcast feeding four fmaf (up to eight in the wide
//   form below). The units' weight columns
//   of layers 0 and 1 are in the thread's registers; a third layer's
//   (two more 64-long columns would not fit 255 registers) in shared
//   memory, a lane's columns side by side, read by the thread's own units.
//   Each layer's outputs go through shared memory, one BAR_MLP round
//   between layers. While the state warp runs
//   the dynamics, the first ENVS lanes of warp NORMALS_WARP draw the next
//   step's action normals (or fetch its eps) and, in TERM, those of warp
//   FRESH_WARP the next step's fresh episodes: neither depends on the state.
// - the state warp does each env's serial work once (lane = part * ENVS +
//   env; its four parts hold the same state): the mean over the last
//   hidden layer's outputs (part m runs the chains of actions m and m + 4,
//   with W_L's column m in registers when there are at most four actions
//   and the last layer is at most 64 wide, else both columns read from
//   shared memory), the action, the solve and Euler
//   step, FK, the reward, the
//   done test and the reset, the observation. Its parts split the trig of
//   FK and the observation (cos and sin of q_i and of the cumulative
//   angles, a sincosf each, which gives cosf's and sinf's bits) and trade
//   the results by shuffles. The mass matrix, the bias and the Cholesky
//   factor depend on q and qd only, so they are formed for step t + 1
//   while the MLP warps run its policy; FK of the post-step q serves the
//   reward and the next step (again only after a reset). A step's stores
//   leave after the observation has been handed over.
// Every sum is one thread's fmaf chain in index order over the layer's
// real width, no padded term added (layer 0 over d from 0, each further
// layer over k from 0, the mean over j from 0), with the precise
// tanhf, trig and rsqrtf, so the outputs are bit for bit those of one
// thread per env. A tree reduction over lanes or a split chain would
// change them. Tensor cores are no help: one step's layer-1 product at c2 is 64 x
// 64 x 1024 MACs, and a split-bf16 mma.sync chain over 8 envs is no
// shorter than the 64-long FMA chain and gives up bit-equality.
// Outputs are feature-first (T, d, N): a row of a block's 8 envs is one
// 32-byte sector. Built with -fmad=false (the dynamics round every
// multiply and add as PyTorch's separate elementwise ops do); the policy
// uses explicit fmaf. The two units' weights (about 150 registers) leave
// room for one block per SM, all that c1 and c2 need; a third layer's
// weights take 16 KB of shared memory at width 64.
// The wide form (WIDE: a layer over policy_shape::PACKED_MAX = 64 units,
// the TPU kernel's unpacked `_policy_ff`): a lane takes up to four units
// (j + 32 u, u < 4) of each layer; layer 0's columns stay in registers
// (at most 4 x 27), every hidden-to-hidden layer's come from dynamic
// shared memory laid out as SmemW's (two 128 x 128 layers are 128 KB,
// past static shared memory's 48 KB), and the state warp reads W_L's
// columns from shared memory when the last layer is over 64 wide. The
// sums, and so the bits, are those of the packed form's rule above. At
// widths up to 64 the packed form compiles the code it had.
// At NJ >= 4 the state warp's unrolled Cholesky (O(NJ^3) terms in
// registers) and the MLP threads' wider W0 columns may spill; `-Xptxas
// -v` reports it.
//
// Instantiations: one library per joint count, built with -DTRPO_NJ=<n>
// (n = 1..8, ops/cuda/build.py) and, for a policy other than (64, 64),
// per hidden shape (-DTRPO_H<l>), each terminating or not, each with fp32
// or bf16 stores.
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

constexpr int ENVS = 8;        // envs per block
constexpr int GROUP = 2;       // envs per MLP thread (a float2 of each input)
constexpr int PARTS = 32 / ENVS;                // state-warp lanes per env
constexpr int MLP_THREADS = 32 * ENVS / GROUP;  // four warps, a pair each
constexpr int THREADS = MLP_THREADS + 32;       // and the state warp
constexpr int NORMALS_WARP = 3, FRESH_WARP = 2;
constexpr int NJ_MAX = 8;
// named barriers (0 is __syncthreads), each a producer/consumer pair, the
// producers arriving and the consumers waiting: OBS (state warp -> MLP
// warps: the observation), MLP (between the policy's layers, MLP warps
// only), ACT (MLP warps -> state warp: layer 1's outputs, the step's
// normals and fresh episodes)
constexpr int BAR_OBS = 1, BAR_MLP = 2, BAR_ACT = 3;
constexpr unsigned FULL = 0xffffffffu;
// the wide form (see the header) and the widths it takes
constexpr bool WIDE = policy_shape::WIDE;
static_assert(Hidden::widest() <= 128, "hidden widths up to 128 (ROADMAP B3)");

// width of hidden layer l (1 for an l past the policy's, which only code
// that NL leaves out names), and the units a lane of an MLP warp takes of
// it: lane j units j + 32 u, u < units(l), where they exist
__host__ __device__ constexpr int wid(int l) {
    return l < NL ? Hidden::width(l) : 1;
}
__host__ __device__ constexpr int units(int l) { return (wid(l) + 31) / 32; }
// whether unit k of layer l exists (always at widths of whole warps)
__host__ __device__ constexpr bool unit_ok(int l, int k) {
    return wid(l) % 32 == 0 || k < wid(l);
}

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

// cos and sin of q_i (the observation) and of the cumulative joint angles
// th_i (FK; th_0 = q_0)
template <int NJ>
struct Trig {
    float cq[NJ], sq[NJ], ct[NJ], st[NJ];
};

// The state warp's trig: the NA = 2 NJ - 1 distinct angles (q_0 .. q_{NJ-1},
// th_1 .. th_{NJ-1}) are dealt to its PARTS lane groups, angle a to part
// a % PARTS in round a / PARTS; each lane takes the sincosf of its angle
// (one argument reduction and one slow-path branch for both), and the
// shuffles hand every lane all of them. Every lane of the warp must call
// it.
template <int NJ>
__device__ __forceinline__ void trig(const float* q, int part, int slot,
                                     Trig<NJ>& g) {
    constexpr int NA = 2 * NJ - 1, ROUNDS = (NA + PARTS - 1) / PARTS;
    float ang[NA];
    float th = q[0];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        if (i > 0) th = th + q[i];
        ang[i] = q[i];
        if (i > 0) ang[NJ + i - 1] = th;
    }
    float cr[ROUNDS], sr[ROUNDS];
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
        const int a = r * PARTS + part;
        float x = ang[0];
#pragma unroll
        for (int k = 1; k < NA; ++k) x = (a == k) ? ang[k] : x;
        sincosf(x, &sr[r], &cr[r]);
    }
#pragma unroll
    for (int a = 0; a < NA; ++a) {
        const int src = (a % PARTS) * ENVS + slot;
        const float cv = __shfl_sync(FULL, cr[a / PARTS], src);
        const float sv = __shfl_sync(FULL, sr[a / PARTS], src);
        if (a < NJ) {
            g.cq[a] = cv;
            g.sq[a] = sv;
        } else {
            g.ct[a - NJ + 1] = cv;
            g.st[a - NJ + 1] = sv;
        }
    }
    g.ct[0] = g.cq[0];
    g.st[0] = g.sq[0];
}

template <int NJ>
__device__ __forceinline__ void fk(const Planar& c, const Trig<NJ>& g,
                                   Fk<NJ>& f) {
    float x = 0.f, y = 0.f;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        f.px[i] = x;
        f.py[i] = y;
        f.cx[i] = x + c.lc[i] * g.ct[i];
        f.cy[i] = y + c.lc[i] * g.st[i];
        x = x + c.l[i] * g.ct[i];
        y = y + c.l[i] * g.st[i];
    }
    f.eex = x;
    f.eey = y;
}

// [cos q, sin q, qd_obs_scale qd, target - ee, 0]
template <int NJ>
__device__ __forceinline__ void observe(const Planar& c, const Trig<NJ>& g,
                                        const float* qd, const Fk<NJ>& f,
                                        float tgtx, float tgty, float* o) {
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        o[i] = g.cq[i];
        o[NJ + i] = g.sq[i];
        o[2 * NJ + i] = c.qd_obs_scale * qd[i];
    }
    o[3 * NJ] = tgtx - f.eex;
    o[3 * NJ + 1] = tgty - f.eey;
    o[3 * NJ + 2] = 0.f;
}

// What a substep needs of q and qd before the action is known: the
// Cholesky factor of M + reg I (L below the diagonal, the pivots' rsqrt),
// the centripetal bias and damping * qd.
template <int NJ>
struct Factor {
    float L[NJ][NJ], inv_d[NJ], bias[NJ], dq[NJ];
};

template <int NJ>
__device__ __forceinline__ void factor(const Planar& c, const Fk<NJ>& f,
                                       const float* qd, Factor<NJ>& F) {
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
    float fx = 0.f, fy = 0.f, nz = 0.f, pcx = 0.f, pcy = 0.f;
#pragma unroll
    for (int i = NJ - 1; i >= 0; --i) {
        float Fx = c.m[i] * acx[i];
        float Fy = c.m[i] * acy[i];
        nz = nz + (f.cx[i] - f.px[i]) * Fy - (f.cy[i] - f.py[i]) * Fx
                + (pcx - f.px[i]) * fy - (pcy - f.py[i]) * fx;
        F.bias[i] = nz;
        fx = Fx + fx;
        fy = Fy + fy;
        pcx = f.px[i];
        pcy = f.py[i];
    }
#pragma unroll
    for (int i = 0; i < NJ; ++i) F.dq[i] = c.damping * qd[i];
    // unrolled Cholesky of (M + reg I), one rsqrt per pivot
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
        float s = M[j][j] + c.chol_reg;
#pragma unroll
        for (int k = 0; k < j; ++k) s = s - F.L[j][k] * F.L[j][k];
        float inv = rsqrtf(s);
        F.inv_d[j] = inv;
#pragma unroll
        for (int i = j + 1; i < NJ; ++i) {
            float t = M[j][i];
#pragma unroll
            for (int k = 0; k < j; ++k) t = t - F.L[i][k] * F.L[j][k];
            F.L[i][j] = t * inv;
        }
    }
}

// The rest of a semi-implicit Euler substep: M qdd = tau - bias - damping
// qd by the two triangular solves, then the velocity clip and the step.
template <int NJ>
__device__ __forceinline__ void solve_step(const Planar& c,
                                           const Factor<NJ>& F,
                                           const float* tau, float* q,
                                           float* qd) {
    float y[NJ], x[NJ];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
        float s = (tau[i] - F.bias[i]) - F.dq[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - F.L[i][k] * y[k];
        y[i] = s * F.inv_d[i];
    }
#pragma unroll
    for (int i = NJ - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < NJ; ++k) s = s - F.L[k][i] * x[k];
        x[i] = s * F.inv_d[i];
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

// What the MLP warps' drawing lanes hand the state warp for step t: the
// action normals (or eps rows) to z (rows of ENVS) when draws_z, else the
// fresh episode (q, qd, target) to fr.
template <int NJ, bool TERM>
__device__ __forceinline__ void draw(
    const Planar& c, uint2 key, int e, int t, int N, bool draws_z,
    const float* __restrict__ eps, const float* __restrict__ fq,
    const float* __restrict__ fqd, const float* __restrict__ ftgt, float* z,
    float* fr) {
    if (draws_z) {
        float zz[NJ];
        if (eps == nullptr) {
            normals<NJ>(key, (uint32_t)e, (uint32_t)t, zz);
        } else {
#pragma unroll
            for (int i = 0; i < NJ; ++i)
                zz[i] = eps[((size_t)t * NJ + i) * N + e];
        }
#pragma unroll
        for (int i = 0; i < NJ; ++i) z[i * ENVS] = zz[i];
    } else if (TERM) {
        float qn[NJ], qdn[NJ], tx, ty;
        fresh_episode<NJ>(c, key, e, t, N, fq, fqd, ftgt, qn, qdn, tx, ty);
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            fr[i * ENVS] = qn[i];
            fr[(NJ + i) * ENVS] = qdn[i];
        }
        fr[2 * NJ * ENVS] = tx;
        fr[(2 * NJ + 1) * ENVS] = ty;
    }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// One hidden layer for an MLP thread: units j + 32 u (u < U) of its env
// pair col, z = sum_d in[d] w(u, d) in d order from 0 (in: (row, env)),
// then tanh(z + b) to out (unit, env) for the units that exist.
// W(u, d) is the weight: the thread's registers, or shared memory.
template <int l, int IN, int U, typename WF>
__device__ __forceinline__ void mlp_layer(const float* in, const WF& W,
                                          const float (&b)[U], float* out,
                                          int j, int col) {
    float z[U][GROUP];
#pragma unroll
    for (int u = 0; u < U; ++u) z[u][0] = z[u][1] = 0.f;
#pragma unroll
    for (int d = 0; d < IN; ++d) {
        const float2 x = *reinterpret_cast<const float2*>(&in[d * ENVS + col]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const float w = W(u, d);
            z[u][0] = fmaf(x.x, w, z[u][0]);
            z[u][1] = fmaf(x.y, w, z[u][1]);
        }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
        const int k = j + 32 * u;
        if (unit_ok(l, k))
            *reinterpret_cast<float2*>(&out[k * ENVS + col]) =
                make_float2(tanhf(z[u][0] + b[u]), tanhf(z[u][1] + b[u]));
    }
}

// the weights of a layer an MLP thread holds in registers, w[u][d]
template <int U, int IN>
struct RegW {
    const float (&w)[U][IN];
    __device__ __forceinline__ float operator()(int u, int d) const {
        return w[u][d];
    }
};
// layer l's weights in shared memory (a third layer's, and in the wide
// form every hidden-to-hidden layer's), (in, 32 U) with the units of a
// lane's warp-wide column side by side: lane j's unit j + 32 u
template <int l>
struct SmemW {
    const float* w;
    int j;
    static constexpr int STRIDE = 32 * units(l);
    __device__ __forceinline__ float operator()(int u, int d) const {
        return w[d * STRIDE + j + 32 * u];
    }
};

template <int NJ, bool TERM, typename Out>
__global__ void __launch_bounds__(THREADS, 1) rollout_kernel(
    Planar c, const float* __restrict__ q0, const float* __restrict__ qd0,
    const float* __restrict__ tgt, const float* __restrict__ W0p,
    const float* __restrict__ b0, const float* __restrict__ W1p,
    const float* __restrict__ b1, const float* __restrict__ W2p,
    const float* __restrict__ b2, const float* __restrict__ W3p,
    const float* __restrict__ b3, const float* __restrict__ logstd,
    const float* __restrict__ eps, const int64_t* __restrict__ seed,
    const float* __restrict__ fq, const float* __restrict__ fqd,
    const float* __restrict__ ftgt, Out* __restrict__ obs,
    Out* __restrict__ act, float* __restrict__ rew,
    float* __restrict__ dones, int N, int T) {
    static_assert(GROUP == 2 && MLP_THREADS == 128, "four MLP warps of float2");
    constexpr int DO = 3 * NJ + 3;
    constexpr int NF = 2 * NJ + 2;       // a fresh episode: q, qd, target
    // actions per state-warp part: part m runs actions m + r PARTS
    constexpr int APP = (NJ + PARTS - 1) / PARTS;
    // hidden widths; the last layer's outputs are the head's inputs
    constexpr int W0 = wid(0), W1 = wid(1), WL = wid(NL - 1);
    // per-env arrays are (row, env of the block)
    __shared__ __align__(16) float sObs[DO * ENVS];
    // the outputs of hidden layer 0 and 1 where another layer follows,
    // and the last one's
    __shared__ __align__(16) float sH0[NL > 1 ? W0 * ENVS : 2];
    __shared__ __align__(16) float sH1[NL > 2 ? W1 * ENVS : 2];
    __shared__ __align__(16) float sA[WL * ENVS];
    __shared__ float sZ[2][NJ * ENVS];   // by step parity
    __shared__ float sFr[2][NF * ENVS];
    // whether the state warp reads W_L from shared memory: more than four
    // actions, or a last layer too wide for a column in registers
    constexpr bool SW2 = APP > 1 || WL > policy_shape::PACKED_MAX;
    // W_L as (unit, action slot m + r PARTS), zero past NJ, when SW2
    __shared__ float sW2[SW2 ? WL * APP * PARTS : 1];
    // a third hidden layer's weights (SmemW), zero past its width
    __shared__ float sWx[NL > 2 && !WIDE ? W1 * SmemW<2>::STRIDE : 1];
    // the wide form's hidden-to-hidden layers (SmemW), layer 1 and then
    // layer 2, zero past their widths
    extern __shared__ __align__(16) float sWide[];
    if (T <= 0) return;
    if constexpr (NL > 2 && !WIDE) {
        for (int i = threadIdx.x; i < W1 * SmemW<2>::STRIDE; i += THREADS) {
            const int d = i / SmemW<2>::STRIDE, k = i % SmemW<2>::STRIDE;
            sWx[i] = k < wid(2) ? W2p[d * wid(2) + k] : 0.f;
        }
        __syncthreads();
    }
    if constexpr (WIDE && NL > 1) {
        constexpr int S1 = SmemW<1>::STRIDE, S2 = SmemW<2>::STRIDE;
        for (int i = threadIdx.x; i < W0 * S1; i += THREADS) {
            const int d = i / S1, k = i % S1;
            sWide[i] = k < wid(1) ? W1p[d * wid(1) + k] : 0.f;
        }
        if constexpr (NL > 2) {
            for (int i = threadIdx.x; i < W1 * S2; i += THREADS) {
                const int d = i / S2, k = i % S2;
                sWide[W0 * S1 + i] = k < wid(2) ? W2p[d * wid(2) + k] : 0.f;
            }
        }
        __syncthreads();
    }

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int slot = lane % ENVS;
    const int e_raw = blockIdx.x * ENVS + slot;
    const bool live = e_raw < N;
    const int e = live ? e_raw : N - 1;          // padded slots shadow env N-1
    uint2 key = make_uint2(0u, 0u);
    if (eps == nullptr) key = make_uint2((uint32_t)seed[0], (uint32_t)seed[1]);

    if (tid < MLP_THREADS) {
        // ------------------------------------------------- the MLP warps
        const int j = lane;                      // units j + 32 u
        const int col = GROUP * warp;            // the pair's first env
        // layers 0 and 1: the thread's units' weight columns in registers
        // (zero for a unit past the width), a third layer's in sWx; in
        // the wide form layer 0's only, the others' in sWide
        constexpr int U0 = units(0), U1 = units(1), U2 = units(2);
        constexpr bool REG1 = NL > 1 && !WIDE;   // layer 1 in registers
        constexpr int K1 = REG1 ? W0 : 1;        // its inputs
        float w0[U0][DO], w1[U1][K1], bu0[U0], bu1[U1], bu2[U2];
        // unit by unit: its layer-0 column, its layer-1 column, the biases
        constexpr int UM = U0 > U1 ? U0 : U1;
#pragma unroll
        for (int u = 0; u < UM; ++u) {
            const int k = j + 32 * u;
            const int u0 = u < U0 ? u : U0 - 1, u1 = u < U1 ? u : U1 - 1;
            const bool ok0 = u < U0 && unit_ok(0, k);
            const bool ok1 = REG1 && u < U1 && unit_ok(1, k);
            if (u < U0) {
#pragma unroll
                for (int d = 0; d < DO; ++d)
                    w0[u0][d] = ok0 ? W0p[d * W0 + k] : 0.f;
            }
            if (REG1 && u < U1) {
#pragma unroll
                for (int kk = 0; kk < K1; ++kk)
                    w1[u1][kk] = ok1 ? W1p[kk * W1 + k] : 0.f;
            }
            if (u < U0) bu0[u0] = ok0 ? b0[k] : 0.f;
            if (NL > 1 && u < U1)
                bu1[u1] = unit_ok(1, k) ? b1[k] : 0.f;
        }
        if constexpr (NL > 2) {
#pragma unroll
            for (int u = 0; u < U2; ++u) {
                const int k = j + 32 * u;
                bu2[u] = unit_ok(2, k) ? b2[k] : 0.f;
            }
        }
        const bool draws_z = warp == NORMALS_WARP && lane < ENVS;
        const bool draws_fresh = TERM && warp == FRESH_WARP && lane < ENVS;
        if (draws_z || draws_fresh)
            draw<NJ, TERM>(c, key, e, 0, N, draws_z, eps, fq, fqd, ftgt,
                           sZ[0] + slot, sFr[0] + slot);
        for (int t = 0; t < T; ++t) {
            bar_sync(BAR_OBS, THREADS);  // step t's observation is in sObs
            // U x GROUP chains a layer, each fmaf in input order from 0;
            // a BAR_MLP round between layers
            mlp_layer<0, DO, U0>(sObs, RegW<U0, DO>{w0}, bu0,
                                 NL > 1 ? sH0 : sA, j, col);
            if constexpr (REG1) {
                bar_sync(BAR_MLP, MLP_THREADS);
                mlp_layer<1, K1, U1>(sH0, RegW<U1, K1>{w1}, bu1,
                                     NL > 2 ? sH1 : sA, j, col);
            } else if constexpr (NL > 1) {
                bar_sync(BAR_MLP, MLP_THREADS);
                mlp_layer<1, W0, U1>(sH0, SmemW<1>{sWide, j}, bu1,
                                     NL > 2 ? sH1 : sA, j, col);
            }
            if constexpr (NL > 2 && !WIDE) {
                bar_sync(BAR_MLP, MLP_THREADS);
                mlp_layer<2, W1, U2>(sH1, SmemW<2>{sWx, j}, bu2, sA, j, col);
            } else if constexpr (NL > 2) {
                bar_sync(BAR_MLP, MLP_THREADS);
                mlp_layer<2, W1, U2>(
                    sH1, SmemW<2>{sWide + W0 * SmemW<1>::STRIDE, j}, bu2, sA,
                    j, col);
            }
            bar_arrive(BAR_ACT, THREADS);
            if (t + 1 < T && (draws_z || draws_fresh))
                draw<NJ, TERM>(c, key, e, t + 1, N, draws_z, eps, fq, fqd, ftgt,
                               sZ[(t + 1) & 1] + slot,
                               sFr[(t + 1) & 1] + slot);
        }
    } else {
        // ------------------------------------------------- the state warp
        const int part = lane / ENVS;
        const bool writer = part == 0 && live;
        // the head (WL, NJ) and its bias: the weights after the last
        // hidden layer's
        const float* __restrict__ W2 = NL == 1 ? W1p : NL == 2 ? W2p : W3p;
        const float* __restrict__ bh = NL == 1 ? b1 : NL == 2 ? b2 : b3;
        float q[NJ], qd[NJ], sigma[NJ], bias2[NJ];
#pragma unroll
        for (int i = 0; i < NJ; ++i) {
            q[i] = q0[i * N + e];
            qd[i] = qd0[i * N + e];
            sigma[i] = expf(logstd[i]);
            bias2[i] = bh[i];
        }
        float tgtx = tgt[e], tgty = tgt[N + e];
        float w2[SW2 ? 1 : WL];          // its column `part` (action part)
        if constexpr (!SW2) {
#pragma unroll
            for (int k = 0; k < WL; ++k)
                w2[k] = part < NJ ? W2[k * NJ + part] : 0.f;
        } else {
            for (int i = lane; i < WL * APP * PARTS; i += 32) {
                const int k = i / (APP * PARTS), m = i % (APP * PARTS);
                sW2[i] = m < NJ ? W2[k * NJ + m] : 0.f;
            }
            __syncwarp();
        }
        Trig<NJ> g;
        Fk<NJ> f;
        float o[DO];
        trig<NJ>(q, part, slot, g);
        fk<NJ>(c, g, f);
        observe<NJ>(c, g, qd, f, tgtx, tgty, o);
        // (every part writes its env's row: the same value to one address)
#pragma unroll
        for (int d = 0; d < DO; ++d) sObs[d * ENVS + slot] = o[d];
        bar_arrive(BAR_OBS, THREADS);
        if (writer) {
#pragma unroll
            for (int d = 0; d < DO; ++d)
                obs[(size_t)d * N + e] = store_cast<Out>(o[d]);
        }
        Factor<NJ> F;
        factor<NJ>(c, f, qd, F);
        for (int t = 0; t < T; ++t) {
            bar_sync(BAR_ACT, THREADS);  // the last layer, step t's normals
            float sz[NJ];
#pragma unroll
            for (int i = 0; i < NJ; ++i)
                sz[i] = sigma[i] * sZ[t & 1][i * ENVS + slot];
            // policy mean W_L^T h + b_L (h: the last hidden layer's tanh
            // outputs): part m runs the chains of actions m + r PARTS < NJ,
            // then every lane takes all NJ
            float acc[APP];
#pragma unroll
            for (int r = 0; r < APP; ++r) acc[r] = 0.f;
#pragma unroll
            for (int jj = 0; jj < WL; ++jj) {
                const float hj = sA[jj * ENVS + slot];
                if constexpr (!SW2) {
                    acc[0] = fmaf(hj, w2[jj], acc[0]);
                } else {
#pragma unroll
                    for (int r = 0; r < APP; ++r)
                        acc[r] = fmaf(
                            hj, sW2[jj * APP * PARTS + part + r * PARTS],
                            acc[r]);
                }
            }
            float a[NJ], tau[NJ];
            float ctrl = 0.f;
#pragma unroll
            for (int i = 0; i < NJ; ++i) {
                a[i] = (__shfl_sync(FULL, acc[i / PARTS],
                                    (i % PARTS) * ENVS + slot) + bias2[i])
                     + sz[i];
                tau[i] = fminf(fmaxf(a[i], -c.torque_limit), c.torque_limit);
                ctrl = (i == 0) ? tau[0] * tau[0] : ctrl + tau[i] * tau[i];
            }
            solve_step<NJ>(c, F, tau, q, qd);
            for (int s = 1; s < c.n_substeps; ++s) {
                trig<NJ>(q, part, slot, g);
                fk<NJ>(c, g, f);
                factor<NJ>(c, f, qd, F);
                solve_step<NJ>(c, F, tau, q, qd);
            }
            // the reward at the post-step state; its FK is the next step's
            trig<NJ>(q, part, slot, g);
            fk<NJ>(c, g, f);
            const float dx = f.eex - tgtx, dy = f.eey - tgty;
            const float dist2 = dx * dx + dy * dy;
            const bool done = TERM && dist2 < c.done_dist2;
            if (TERM && t + 1 < T && __any_sync(FULL, done)) {
                // a done env starts step t's fresh episode; the other lanes
                // recompute their own unchanged values
                const float* fr = sFr[t & 1] + slot;
#pragma unroll
                for (int i = 0; i < NJ; ++i) {
                    q[i] = done ? fr[i * ENVS] : q[i];
                    qd[i] = done ? fr[(NJ + i) * ENVS] : qd[i];
                }
                tgtx = done ? fr[2 * NJ * ENVS] : tgtx;
                tgty = done ? fr[(2 * NJ + 1) * ENVS] : tgty;
                trig<NJ>(q, part, slot, g);
                fk<NJ>(c, g, f);
            }
            if (t + 1 < T) {
                observe<NJ>(c, g, qd, f, tgtx, tgty, o);
#pragma unroll
                for (int d = 0; d < DO; ++d) sObs[d * ENVS + slot] = o[d];
                bar_arrive(BAR_OBS, THREADS);
            }
            // step t's outputs and step t + 1's observation leave while the
            // MLP warps run step t + 1's policy
            if (writer) {
#pragma unroll
                for (int i = 0; i < NJ; ++i)
                    act[((size_t)t * NJ + i) * N + e] = store_cast<Out>(a[i]);
                rew[(size_t)t * N + e] = -(dist2 + c.ctrl_weight * ctrl);
                if (TERM) dones[(size_t)t * N + e] = done ? 1.f : 0.f;
                if (t + 1 < T) {
#pragma unroll
                    for (int d = 0; d < DO; ++d)
                        obs[((size_t)(t + 1) * DO + d) * N + e] =
                            store_cast<Out>(o[d]);
                }
            }
            if (t + 1 < T) factor<NJ>(c, f, qd, F);
        }
    }
}

struct Args {
    const float *q0, *qd0, *tgt;
    Weights pol;
    const float* eps;
    const int64_t* seed;
    const float *fq, *fqd, *ftgt;
    void *obs, *act;
    float *rew, *dones;
    int N, T;
    cudaStream_t stream;
};

// the wide form's dynamic shared memory: its hidden-to-hidden layers'
// weights as SmemW lays them out (none in the packed form)
constexpr int WIDE_SMEM =
    !WIDE || NL < 2 ? 0
    : (int)sizeof(float) * (wid(0) * SmemW<1>::STRIDE +
                            (NL > 2 ? wid(1) * SmemW<2>::STRIDE : 0));
static_assert(WIDE_SMEM <= 200 * 1024, "the wide form's layers fit an SM");

template <int NJ, bool TERM, typename Out>
struct Launch {
    static cudaError_t set_smem() {
        if (WIDE_SMEM == 0) return cudaSuccess;
        return cudaFuncSetAttribute(rollout_kernel<NJ, TERM, Out>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    WIDE_SMEM);
    }
    static cudaError_t run(const Planar& c, const Args& a) {
        dim3 grid((a.N + ENVS - 1) / ENVS);
        cudaError_t err = set_smem();
        if (err != cudaSuccess) return err;
        rollout_kernel<NJ, TERM, Out><<<grid, THREADS, WIDE_SMEM, a.stream>>>(
            c, a.q0, a.qd0, a.tgt, a.pol.W[0], a.pol.b[0], a.pol.W[1],
            a.pol.b[1], a.pol.W[2], a.pol.b[2], a.pol.W[3], a.pol.b[3],
            a.pol.logstd, a.eps, a.seed, a.fq, a.fqd, a.ftgt,
            static_cast<Out*>(a.obs), static_cast<Out*>(a.act), a.rew,
            a.dones, a.N, a.T);
        return cudaGetLastError();
    }
    // resident blocks per SM, registers and local bytes per thread, static
    // shared bytes per block, threads and envs per block, dynamic shared
    // bytes per block (the wide form's)
    static cudaError_t occupancy(int* out) {
        int blocks = 0;
        cudaError_t err = set_smem();
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, rollout_kernel<NJ, TERM, Out>, THREADS, WIDE_SMEM);
        if (err != cudaSuccess) return err;
        cudaFuncAttributes fa;
        err = cudaFuncGetAttributes(&fa, rollout_kernel<NJ, TERM, Out>);
        if (err != cudaSuccess) return err;
        out[0] = blocks;
        out[1] = fa.numRegs;
        out[2] = (int)fa.localSizeBytes;
        out[3] = (int)fa.sharedSizeBytes;
        out[4] = THREADS;
        out[5] = ENVS;
        out[6] = WIDE_SMEM;
        return cudaSuccess;
    }
};

#ifndef TRPO_NJ
#error "build with -DTRPO_NJ=<joints> (1..8), one library per joint count"
#endif
static_assert(TRPO_NJ >= 1 && TRPO_NJ <= NJ_MAX, "TRPO_NJ out of range");

template <bool TERM, typename Op>
cudaError_t with_store(int store_bf16, Op op) {
    return store_bf16 ? op(Launch<TRPO_NJ, TERM, __nv_bfloat16>{})
                      : op(Launch<TRPO_NJ, TERM, float>{});
}

// The instantiations of this library: n = TRPO_NJ, terminating or not,
// fp32 or bf16 stores; another joint count is cudaErrorInvalidValue.
template <typename Op>
cudaError_t dispatch(int n_joints, int terminating, int store_bf16, Op op) {
    if (n_joints != TRPO_NJ) return cudaErrorInvalidValue;
    return terminating ? with_store<true>(store_bf16, op)
                       : with_store<false>(store_bf16, op);
}

}  // namespace

// consts (host array): l[n], lc[n], m[n], iz[n], damping, h, torque_limit,
// qd_limit, qd_obs_scale, ctrl_weight, chol_reg, done_dist^2, q0_noise,
// qd0_noise, rmin, rmax.
// hidden (n_hidden ints, host): the policy's hidden widths, which must be
// this library's (policy_shape.cuh), else cudaErrorInvalidValue; weights
// (host array of device pointers): W0, b0, ..., W_L, b_L, L = n_hidden
// (W_l (in, out) row-major), then logstd (n).
// eps: (T, n, N) or NULL for Philox mode with seed: int64[2] on the device.
// terminating != 0 takes the TERM instantiation, which writes dones (T, N)
// and takes the fresh episodes from fq/fqd (T, n, N) and ftgt (T, 2, N),
// or from Philox when fq is NULL. obs (T, 3n+3, N) and act (T, n, N) are
// bf16 when store_bf16 != 0, else fp32; rew and dones fp32.
extern "C" int trpo_rollout_launch(
    const float* consts, int n_substeps, int n_joints, int terminating,
    int store_bf16, const int* hidden, int n_hidden, const float* q0,
    const float* qd0, const float* tgt, const float* const* weights,
    const float* eps, const int64_t* seed, const float* fq, const float* fqd,
    const float* ftgt, void* obs, void* act, float* rew, float* dones,
    int N, int T, void* stream) {
    Planar c;
    const int n = n_joints;
    if (n < 1 || n > NJ_MAX || !policy_shape::same_shape(hidden, n_hidden))
        return (int)cudaErrorInvalidValue;
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
    const Args a = {q0, qd0, tgt, policy_shape::weights_of(weights), eps, seed,
                    fq, fqd, ftgt, obs, act, rew, dones, N, T,
                    static_cast<cudaStream_t>(stream)};
    return (int)dispatch(n, terminating, store_bf16,
                         [&](auto inst) { return inst.run(c, a); });
}

// out: int[7], as Launch::occupancy fills it.
extern "C" int trpo_rollout_occupancy(int n_joints, int terminating,
                                      int store_bf16, int* out) {
    return (int)dispatch(n_joints, terminating, store_bf16,
                         [&](auto inst) { return inst.occupancy(out); });
}
