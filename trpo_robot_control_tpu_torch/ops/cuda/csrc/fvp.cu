// Gauss-Newton Fisher-vector product for the tanh policy on batch-major
// samples, on the tensor cores.
//
// Replaces `make_pallas_gn_fvp` / `_fvp_kernel` (and its pair-packed twin
// `_fvp_kernel_packed`) in trpo_robot_control_tpu/ops/pallas/fvp_kernel.py.
// The policy has 1-3 hidden layers of 1-128 units (policy_shape.cuh; the
// JAX package's (64, 64) without -DTRPO_H<l>); a layer over 64 units
// selects the wide form further down (`namespace wide`: the same plane
// products, a chain of launches), as the TPU kernel's widths select its
// unpacked `_fvp_kernel`. The one-pass form below takes widths up to 64.
// One pass over the (B, do)
// samples per CG call; the hidden activations h_l (B, w_l) are computed
// once per update outside and read here, not recomputed. Per sample, the
// fp32 function of the plain version, with W_L the da-wide head:
//   forward tangent  dh0 = (1-h0^2)(x dW0 + db0)
//                    dh_l = (1-h_l^2)(dh_{l-1} W_l + h_{l-1} dW_l + db_l)
//                    dmu = dh_{L-1} W_L + h_{L-1} dW_L + db_L
//   Fisher scaling   u   = dmu * inv_var / B
//   reverse          gW_L = h_{L-1}^T u, g_{L-1} = (u W_L^T)(1-h_{L-1}^2),
//                    gW_l = h_{l-1}^T g_l, g_{l-1} = (g_l W_l^T)(1-h_{l-1}^2),
//                    gW0 = x^T g0 (+ bias sums)
// At (64, 64): dh0, dh1 = (1-h1^2)(dh0 W1 + h0 dW1 + db1), dmu, then
// gW2 = h1^T u, g1, gW1 = h0^T g1, g0 = (g1 W1^T)(1-h0^2), gW0.
// The logstd block 2 v and the damping are added in the reduce pass
// (fvp_tile.cuh's, shared with fvp_ff.cu, as is the split into planes).
//
// The hidden layers' products (x dW0, and per hidden-to-hidden layer l:
// dh_{l-1} W_l, h_{l-1} dW_l, g_l W_l^T, h_{l-1}^T g_l; then x^T g0: six
// at (64, 64), none hidden-to-hidden at one layer) run on the tensor cores
// as split-bf16 plane products (plane_mma below), exact to fp32 as K6's
// are; the da-wide head (dmu, u, gW_L, u W_L^T, the bias sums) runs on the
// CUDA cores in fp32. Every width is padded to the m16n8k16 tile's 16 with
// zeros, in the weights' and v's planes and in the staged activations, so
// a padded unit's h, dh and g are exact zeros (as in fvp_ff.cu). The
// hidden-to-hidden weights' planes are split once per update
// (trpo_fvp_split_launch), v's blocks dW0 .. dW_{L-1} once per call in a
// small pass ahead of the kernel; blocks copy them from L2 in their
// prologue.
//
// Layout: samples are the mma's M, hidden units its N, features its K. A
// warp owns 16 samples, so the forward products chain in registers: an
// m16n8 accumulator pair is the A fragment of the next product (dh_{l-1}
// -> dh_{l-1} W_l, g_l -> g_l W_l^T), split into planes in place. Only the
// weight gradients, sums over samples, cross warps: a tile is 16 samples a
// warp, and after the forward each warp puts its g_{L-1} (then each
// further g_l) planes in shared memory; the warps then share gW_l's 16 x
// 32 blocks, summing each over the tile's samples from h_{l-1}, staged in
// fp32 and split as it is read (at (64, 64), 8 warps: warp (mt, nh) rows
// 16 mt.. and columns 32 nh.. of gW1), and warp w sums gW0's columns
// 16 (w % CG).. the same way from x over a share of the tile's samples
// (the shares added at the end). Two __syncthreads per weight gradient
// of a tile (four at (64, 64)). x and h_0 .. h_{L-2} are staged by
// cp.async into one or two buffers, the next tile's loads under this
// tile's products (a row that is not a whole number of 16-byte chunks, as
// at width 33, is staged as part of one packed run); h_{L-1}, used only
// where each thread's fragment lies, is read straight from global memory
// a chunk ahead of its use. Each plane_mma call issues its products plane
// pair by plane pair across up to four n-tiles, so that consecutive
// mma.sync are independent: with two warps per SM sub-partition (255
// registers a thread) nothing else hides the tensor cores' latency. The
// tile is chosen at compile time by what fits one block's shared memory
// (Pick): 8 warps with two staging buffers up to two 64-wide layers
// (206,112 B at (64, 64)), else fewer buffers, else 4 warps.
//
// What bounds it on an H100: at c2 (B' = 25,600, do 12, da 3, (64, 64))
// the function is 18.7k MACs a sample, 0.96 GFLOP (0.001 ms at the 989
// TFLOP/s bf16 peak), its inputs 14.3 MB (0.0043 ms at 3.35 TB/s), so the
// bytes bound it. The six plane products make it 5.7 GFLOP of mma.sync,
// and at two warps per sub-partition their latency, the ldmatrix of the
// weights' planes (~78 KB a warp and tile) and the splits set its time;
// PERF.md has the measurements. One block per SM, a grid of at most 132
// blocks: c2's 200 tiles take two rounds on 68 SMs, c1's 25 tiles one
// round on 25 SMs.
//
// No float atomics: blocks keep their share of the gradient in registers
// across their tiles and write per-block partials over a fixed grid; the
// reduce pass sums them in a fixed order.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "fvp_tile.cuh"
#include "mma_bf16.cuh"
#include "policy_shape.cuh"

namespace {

using bf16 = __nv_bfloat16;
using policy_shape::Flat;
using policy_shape::Hidden;
using policy_shape::NL;
using policy_shape::Weights;
static_assert(Hidden::widest() <= 128, "hidden widths up to 128 (ROADMAP B3)");

constexpr int PL = 3;          // planes of an fp32 operand: hi, mid, lo
constexpr int SW = 16;         // samples per warp: the mma's M
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int HMP = (Hidden::widest() + 15) / 16 * 16;   // widest, padded
constexpr int RS = HMP + 8;    // bf16 row stride of the plane tiles (144 B
                               // at 64: an odd number of 16 bytes, so the 8
                               // rows of an ldmatrix hit distinct bank
                               // groups)
constexpr int HS = HMP + 4;    // fp32 row stride of a staged h_l
constexpr unsigned FULL = 0xffffffffu;

using fvp_tile::split3;
using fvp_tile::split_pair;
using fvp_tile::zero;

// width of hidden layer l and the same up to a multiple of 16 (16 for an
// l outside 0 .. NL-1, which only code that NL leaves out names)
__host__ __device__ constexpr int wid(int l) {
    return l >= 0 && l < NL ? Hidden::width(l) : 16;
}
__host__ __device__ constexpr int pad(int l) { return (wid(l) + 15) / 16 * 16; }
__host__ __device__ constexpr int ntiles(int l) { return pad(l) / 8; }
__host__ __device__ constexpr int ksteps(int l) { return pad(l) / 16; }
constexpr int NTL = ntiles(NL - 1);   // the last hidden layer's n-tiles
constexpr int EXP = SW * RS;          // a warp's exchange plane, bf16
// whether h_l's rows are whole 16-byte chunks: staged at row stride HS,
// the padded columns zero; else staged as one packed run of w_l a row
__host__ __device__ constexpr bool rows16(int l) { return wid(l) % 4 == 0; }
// whether every width is a multiple of the tile's 16 (no padding anywhere)
__host__ __device__ constexpr bool dense() {
    for (int l = 0; l < NL; ++l)
        if (wid(l) % 16) return false;
    return true;
}

// bf16 elements of a plane of hidden-to-hidden layer l's weights in
// shared memory, (pad(l-1), RS) [in][out]; byte offsets of W_l's and
// dW_l's three planes, l = 1 .. NL-1, one layer after another from 0
__host__ __device__ constexpr int wplane(int l) { return pad(l - 1) * RS; }
__host__ __device__ constexpr int w_off(int l) {
    int o = 0;
    for (int m = 1; m < l; ++m) o += 2 * PL * wplane(m) * 2;
    return o;
}
__host__ __device__ constexpr int dw_off(int l) {
    return w_off(l) + PL * wplane(l) * 2;
}
// In global memory: the workspace's planes of W_l, (3, pad(l-1), pad(l))
// after those of W_1 .. W_{l-1}; the per-call planes of v's blocks, each
// plane of (VP) holding dW0 (do, pad(0)) and then dW_l (pad(l-1), pad(l)).
__host__ __device__ constexpr int gw_off(int l) {
    int o = 0;
    for (int m = 1; m < l; ++m) o += PL * pad(m - 1) * pad(m);
    return o;
}
__host__ __device__ inline int gv_off(int l, int DO) {
    int o = 0;
    for (int m = 0; m < l; ++m) o += (m == 0 ? DO : pad(m - 1)) * pad(m);
    return o;
}

// shared memory, byte offsets; XT k-steps of x (do <= 16 XT), DT head
// outputs (da <= DT), NW warps a block, NB staging buffers
template <int XT, int DT, int NW_, int NB_>
struct Layout {
    static constexpr int NW = NW_, NB = NB_;
    static constexpr int XR = 16 * XT;               // dW0's rows, zero past do
    static constexpr int W0P = XR * RS;              // bf16 elements a plane
    // a warp's staged floats: x [s][do], then h_0 .. h_{L-2}, SW x HS each
    static constexpr int STG = SW * XR + (NL - 1) * SW * HS;
    static constexpr int DW0 = w_off(NL);            // 3 x (XR, RS) [d][h]
    static constexpr int EX = DW0 + PL * W0P * 2;    // [warp][3][s][RS]: g_l
    static constexpr int ST = EX + NW * PL * EXP * 2;   // [buf][warp]
    static constexpr int W2 = ST + NB * NW * STG * 4;   // W_L [o][DT] fp32
    static constexpr int DW2 = W2 + HMP * DT * 4;
    static constexpr int BI = DW2 + HMP * DT * 4;    // db_l, HMP each
    static constexpr int C = BI + NL * HMP * 4;      // db_L, scale
    static constexpr int BYTES = C + 2 * DT * 4;
    // gW0's column groups and the shares of the tile's samples they split
    static constexpr int CG = pad(0) / 16;
    static constexpr int S = NW / CG;
    // the final sums' scratch: W_L's gradient [warp][64][DT], the bias
    // sums [l][warp][64] and [warp][DT], gW0's shares [S][XR][pad(0)];
    // over the staging buffers where it fits, else from the exchange on
    static constexpr int SCRATCH =
        (NW * 64 * DT + NL * NW * 64 + NW * DT + S * XR * pad(0)) * 4;
    static constexpr int SCR = SCRATCH <= W2 - ST ? ST : EX;
    static constexpr bool FITS = BYTES <= 232448 && SCRATCH <= W2 - EX;
    static_assert(DW0 % 16 == 0 && EX % 16 == 0 && ST % 16 == 0 &&
                  (STG * 4) % 16 == 0 && (SW * XR * 4) % 16 == 0 &&
                  W2 % 16 == 0, "16-byte aligned tiles");
};

// The tile: 8 warps with two staging buffers where that fits one block's
// shared memory (every shape up to two 64-wide layers), else 8 with one,
// else 4 with two, else 4 with one (three 64-wide layers)
template <int XT_, int DT_>
struct Pick {
    static constexpr int XT = XT_, DT = DT_;
    static constexpr int NW = (Layout<XT_, DT_, 8, 2>::FITS ||
                               Layout<XT_, DT_, 8, 1>::FITS) ? 8 : 4;
    static constexpr int NB = Layout<XT_, DT_, NW, 2>::FITS ? 2 : 1;
    using L = Layout<XT_, DT_, NW, NB>;
    static constexpr int NT = 32 * NW, TS = NW * SW;
    // gW_l's 16 x 32 blocks a warp: at most 8 a layer (64 x 64)
    static constexpr int JPW = (8 + NW - 1) / NW;
    static_assert(L::FITS, "one block's shared memory");
};

// i / n and i % n for i >= 0, as a shift and a mask where n is a power of
// two (signed division would add a rounding fix-up)
template <int n>
__device__ __forceinline__ int div_(int i) {
    if constexpr ((n & (n - 1)) == 0) {
        int b = 0;
        while ((1 << b) < n) ++b;
        return i >> b;
    } else {
        return i / n;
    }
}
template <int n>
__device__ __forceinline__ int mod_(int i) {
    if constexpr ((n & (n - 1)) == 0) return i & (n - 1);
    else return i % n;
}

template <int R, int C, int D>
__device__ __forceinline__ void zero3(float (&a)[R][C][D]) {
#pragma unroll
    for (int i = 0; i < R; ++i) zero(a[i]);
}

// the first N n-tiles of four
template <int N>
__device__ __forceinline__ auto first(float (&a)[4][4]) -> float (&)[N][4] {
    return *reinterpret_cast<float(*)[N][4]>(&a[0]);
}

// The plane products of an A fragment with the B fragments of N n8 tiles:
// hi += A_0 B_0, ml += the five other plane pairs with p + q <= 2 (hi mid,
// mid hi, hi lo, lo hi, mid mid), issued pair by pair across the tiles so
// that consecutive mma are independent. r: x4 loads of each plane, two
// tiles a load; loaded transposed from a [k][n] tile (TRANS) tile e of a
// load is (r[2e], r[2e + 1]), loaded as stored from an [n][k] tile it is
// (r[e], r[e + 2]).
template <int N, bool TRANS>
__device__ __forceinline__ void plane_mma(float (&hi)[N][4],
                                          float (&ml)[N][4],
                                          const uint32_t (&a)[PL][4],
                                          const uint32_t (&r)[N / 2][PL][4]) {
    uint32_t b[N][PL][2];
#pragma unroll
    for (int t = 0; t < N; ++t)
#pragma unroll
        for (int p = 0; p < PL; ++p) {
            const int e = t & 1;
            b[t][p][0] = r[t >> 1][p][TRANS ? 2 * e : e];
            b[t][p][1] = r[t >> 1][p][TRANS ? 2 * e + 1 : e + 2];
        }
    constexpr int PA[6] = {0, 0, 1, 0, 2, 1}, PB[6] = {0, 1, 0, 2, 0, 1};
#pragma unroll
    for (int k = 0; k < 6; ++k)
#pragma unroll
        for (int t = 0; t < N; ++t)
            mma_bf16(k == 0 ? hi[t] : ml[t], a[PA[k]], b[t][PB[k]][0],
                     b[t][PB[k]][1], false);
}

// t[16] summed over the 8 lanes g of this lane's column c, in a fixed
// order (halving over g's bits 2, 1, 0); lane g keeps the sums of t[2g]
// and t[2g + 1]
__device__ __forceinline__ float2 reduce_scatter16(const float (&t)[16],
                                                   int g) {
    float a[8], b[4];
    const bool u2 = g & 4, u1 = g & 2, u0 = g & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const float keep = u2 ? t[i + 8] : t[i], give = u2 ? t[i] : t[i + 8];
        a[i] = keep + __shfl_xor_sync(FULL, give, 16);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float keep = u1 ? a[i + 4] : a[i], give = u1 ? a[i] : a[i + 4];
        b[i] = keep + __shfl_xor_sync(FULL, give, 8);
    }
    float2 r;
    {
        const float keep = u0 ? b[2] : b[0], give = u0 ? b[0] : b[2];
        r.x = keep + __shfl_xor_sync(FULL, give, 4);
    }
    {
        const float keep = u0 ? b[3] : b[1], give = u0 ? b[1] : b[3];
        r.y = keep + __shfl_xor_sync(FULL, give, 4);
    }
    return r;
}

// h_l staged for a warp's 16 samples: sample r, unit k (0 past the width)
template <int l>
__device__ __forceinline__ float hval(const float* sh, int r, int k) {
    if constexpr (rows16(l)) return sh[r * HS + k];
    else return k < wid(l) ? sh[r * wid(l) + k] : 0.f;
}
// units k, k + 1 (k even)
template <int l>
__device__ __forceinline__ float2 hpair(const float* sh, int r, int k) {
    if constexpr (rows16(l))
        return *reinterpret_cast<const float2*>(sh + r * HS + k);
    else return make_float2(hval<l>(sh, r, k), hval<l>(sh, r, k + 1));
}
// h_l (B, w_l) in global memory: sample s, units k, k + 1 (k even; 0
// past the width)
template <int l>
__device__ __forceinline__ float2 hglobal(const float* H, size_t s, int k) {
    constexpr int Wl = wid(l);
    if constexpr (Wl % 2 == 0) {
        if (Wl == pad(l) || k < Wl)
            return __ldg(reinterpret_cast<const float2*>(H + s * Wl + k));
        return make_float2(0.f, 0.f);
    } else {
        const float* p = H + s * Wl + k;
        return make_float2(k < Wl ? __ldg(p) : 0.f,
                           k + 1 < Wl ? __ldg(p + 1) : 0.f);
    }
}

// h_l of a warp's 16 samples from s0 (ns of them real) into sh by
// cp.async: rows of whole 16-byte chunks one by one at stride HS (the
// padded columns zero), other rows as one packed run (16-byte aligned:
// s0 is a multiple of 16); rows past B zero
template <int l>
__device__ __forceinline__ void stage_h(float* sh, const float* H, int s0,
                                        int ns, int lane) {
    constexpr int Wl = wid(l);
    const float* src = H + (size_t)s0 * Wl;
    if constexpr (rows16(l)) {
        constexpr int CH = pad(l) / 4, CW = Wl / 4;
#pragma unroll
        for (int i = 0; i < SW * CH / 32; ++i) {
            const int q = lane + 32 * i, r = div_<CH>(q), k = mod_<CH>(q);
            const bool ok = r < ns && (CW == CH || k < CW);
            cp_async16(sh + r * HS + 4 * k, ok ? src + r * Wl + 4 * k : H,
                       ok ? 16 : 0);
        }
    } else {
        const int bytes = ns * Wl * 4;
        for (int q = lane; q < 4 * Wl; q += 32) {
            const int nb = min(16, max(0, bytes - 16 * q));
            cp_async16(sh + 4 * q, nb > 0 ? src + 4 * q : H, nb);
        }
    }
}

// Hidden layer l's weight planes (workspace) and v's (per call) into
// shared memory, l >= 1
template <int l>
__device__ __forceinline__ void load_planes(char* smem, const bf16* Wp,
                                            const bf16* Vp, int VP, int DO,
                                            int tid, int NT) {
    constexpr int R = pad(l - 1), C = pad(l), CPR = C / 8;
    bf16* sw = reinterpret_cast<bf16*>(smem + w_off(l));
    bf16* sdw = reinterpret_cast<bf16*>(smem + dw_off(l));
    const bf16* gw = Wp + gw_off(l);
    const bf16* gv = Vp + gv_off(l, DO);
    for (int i = tid; i < PL * R * CPR; i += NT) {
        const int p = i / (R * CPR), r = div_<CPR>(i) % R, q = mod_<CPR>(i);
        cp_async16(sw + p * wplane(l) + r * RS + 8 * q,
                   gw + (p * R + r) * C + 8 * q, 16);
        cp_async16(sdw + p * wplane(l) + r * RS + 8 * q,
                   gv + p * VP + r * C + 8 * q, 16);
    }
}

// x dW0 over every n-tile of layer 0, NG groups of up to four (the
// products of layer 0; the last group two n-tiles where pad(0) is an odd
// number of 16s)
template <int XT, int NG>
__device__ __forceinline__ void x_product(float (&hi)[NG][4][4],
                                          float (&ml)[NG][4][4],
                                          const float* sx, int DO,
                                          const bf16* sdW0, int g, int c,
                                          int lr, int lc) {
    constexpr int W0P = 16 * XT * RS;
    zero3(hi);
    zero3(ml);
#pragma unroll
    for (int kk = 0; kk < XT; ++kk) {
        uint32_t ax[PL][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int r = g + 8 * (q & 1);
            const int d = 16 * kk + 2 * c + 8 * (q >> 1);
            const float e0 = d < DO ? sx[r * DO + d] : 0.f;
            const float e1 = d + 1 < DO ? sx[r * DO + d + 1] : 0.f;
            split_pair(e0, e1, ax[0][q], ax[1][q], ax[2][q]);
        }
#pragma unroll
        for (int hh = 0; hh < NG; ++hh) {      // n-tiles 4 hh..
            const bf16* w = sdW0 + (16 * kk + lr) * RS + 32 * hh + lc;
            if (4 * hh + 4 <= ntiles(0)) {
                uint32_t r[2][PL][4];
#pragma unroll
                for (int pp = 0; pp < 2; ++pp)
#pragma unroll
                    for (int pl = 0; pl < PL; ++pl)
                        ldmatrix_x4_trans(r[pp][pl], w + pl * W0P + 16 * pp);
                plane_mma<4, true>(hi[hh], ml[hh], ax, r);
            } else {
                uint32_t r[1][PL][4];
#pragma unroll
                for (int pl = 0; pl < PL; ++pl)
                    ldmatrix_x4_trans(r[0][pl], w + pl * W0P);
                plane_mma<2, true>(first<2>(hi[hh]), first<2>(ml[hh]), ax, r);
            }
        }
    }
}

// dh_l = (1 - h_l^2)(acc + db_l) at n-tile nt (acc = th + tm; h_l staged
// at sh), into its planes as the A fragments of the next product (k-step
// kk: n-tiles 2 kk, 2 kk + 1)
template <int l, int KS>
__device__ __forceinline__ void dh_frag(uint32_t (&ad)[KS][PL][4],
                                        const float (&th)[4],
                                        const float (&tm)[4], int nt,
                                        const float* sh, const float* sdb,
                                        int g, int c) {
    const int h = 8 * nt + 2 * c;
    const float2 db = *reinterpret_cast<const float2*>(sdb + h);
    float d[4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const float2 hv = hpair<l>(sh, g + 8 * hf, h);
        d[2 * hf] = (1.f - hv.x * hv.x) * ((th[2 * hf] + tm[2 * hf]) + db.x);
        d[2 * hf + 1] =
            (1.f - hv.y * hv.y) * ((th[2 * hf + 1] + tm[2 * hf + 1]) + db.y);
    }
    const int kk = nt >> 1, j = 2 * (nt & 1);
    split_pair(d[0], d[1], ad[kk][0][j], ad[kk][1][j], ad[kk][2][j]);
    split_pair(d[2], d[3], ad[kk][0][j + 1], ad[kk][1][j + 1],
               ad[kk][2][j + 1]);
}

// dh_l W_{l} + h_{l-1} dW_l for the N n-tiles of layer l from column c0,
// over layer l-1's KS k-steps: dh_{l-1}'s A fragments in ad, h_{l-1}'s
// split from its staged fp32 (shp) as read
template <int l, int N, int KS>
__device__ __forceinline__ void fwd_chunk(float (&hi)[N][4], float (&ml)[N][4],
                                          uint32_t (&ad)[KS][PL][4],
                                          const float* shp, const bf16* sw,
                                          const bf16* sdw, int c0, int g,
                                          int c, int lr, int lc) {
    zero(hi);
    zero(ml);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        uint32_t ah[PL][4];    // h_{l-1}'s planes, split as staged
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float2 hv = hpair<l - 1>(shp, g + 8 * (q & 1),
                                           16 * kk + 2 * c + 8 * (q >> 1));
            split_pair(hv.x, hv.y, ah[0][q], ah[1][q], ah[2][q]);
        }
        // dh_{l-1} W_l, then h_{l-1} dW_l, over the chunk's n-tiles
#pragma unroll
        for (int term = 0; term < 2; ++term) {
            const bf16* w = term == 0 ? sw : sdw;
            uint32_t r[N / 2][PL][4];
#pragma unroll
            for (int pp = 0; pp < N / 2; ++pp)
#pragma unroll
                for (int pl = 0; pl < PL; ++pl)
                    ldmatrix_x4_trans(r[pp][pl], w + pl * wplane(l) +
                                                     (16 * kk + lr) * RS + c0 +
                                                     16 * pp + lc);
            plane_mma<N, true>(hi, ml, term == 0 ? ad[kk] : ah, r);
        }
    }
}

// The last hidden layer's h at n-tile nt in the accumulator layout, from
// global memory (0 on samples past B)
__device__ __forceinline__ void load_hl(float (&hv)[4], const float* HL,
                                        int s0, int ns, int nt, int g,
                                        int c) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int r = g + 8 * hf, o = 8 * nt + 2 * c;
        float2 x = make_float2(0.f, 0.f);
        if (r < ns) x = hglobal<NL - 1>(HL, (size_t)(s0 + r), o);
        hv[2 * hf] = x.x;
        hv[2 * hf + 1] = x.y;
    }
}

// dh_{L-1} = (1 - h^2)(acc + db) at n-tile nt of the last hidden layer
// (acc = th + tm, h = hv), and dmu's partial sums over this lane's
// columns: dmu += dh W_L + h dW_L
template <int DT>
__device__ __forceinline__ void head_tile(float (&dmu)[2][DT],
                                          const float (&th)[4],
                                          const float (&tm)[4],
                                          const float (&hv)[4], int nt,
                                          int c, const float* sdb,
                                          const float* sW2,
                                          const float* sdW2) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int o = 8 * nt + 2 * c + e;
        const float db = sdb[o];
        float w[DT], dw[DT];
#pragma unroll
        for (int m = 0; m < DT; m += 4) {
            const float4 a = *reinterpret_cast<const float4*>(sW2 + o * DT + m);
            const float4 b = *reinterpret_cast<const float4*>(sdW2 + o * DT + m);
            w[m] = a.x; w[m + 1] = a.y; w[m + 2] = a.z; w[m + 3] = a.w;
            dw[m] = b.x; dw[m + 1] = b.y; dw[m + 2] = b.z; dw[m + 3] = b.w;
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int q = 2 * hf + e;
            const float h = hv[q];
            const float dh = (1.f - h * h) * ((th[q] + tm[q]) + db);
#pragma unroll
            for (int m = 0; m < DT; ++m)
                dmu[hf][m] = fmaf(h, dw[m], fmaf(dh, w[m], dmu[hf][m]));
        }
    }
}

// The last hidden layer l = L-1 >= 1, 32 columns at a time: its h read
// into hv a chunk ahead of its use, dh_l from dh_{l-1}'s fragments ad and
// h_{l-1} (staged at shp), and dmu
template <int DT, int KS>
__device__ __forceinline__ void last_layer(float (&hv)[NTL][4],
                                           float (&dmu)[2][DT],
                                           uint32_t (&ad)[KS][PL][4],
                                           const float* shp, char* smem,
                                           const float* HL, int s0, int ns,
                                           const float* sdb, const float* sW2,
                                           const float* sdW2, int g, int c,
                                           int lr, int lc) {
    constexpr int l = NL - 1;
    const bf16* sw = reinterpret_cast<const bf16*>(smem + w_off(l));
    const bf16* sdw = reinterpret_cast<const bf16*>(smem + dw_off(l));
#pragma unroll
    for (int ch = 0; ch < NTL / 4; ++ch) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
            load_hl(hv[4 * ch + i], HL, s0, ns, 4 * ch + i, g, c);
        float hi[4][4], ml[4][4];
        fwd_chunk<l, 4, KS>(hi, ml, ad, shp, sw, sdw, 32 * ch, g, c, lr, lc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            head_tile<DT>(dmu, hi[i], ml[i], hv[4 * ch + i], 4 * ch + i, c,
                          sdb, sW2, sdW2);
    }
    if constexpr (NTL % 4 != 0) {           // a last chunk of 16 columns
        constexpr int nt0 = NTL / 4 * 4;
#pragma unroll
        for (int i = 0; i < 2; ++i)
            load_hl(hv[nt0 + i], HL, s0, ns, nt0 + i, g, c);
        float hi[2][4], ml[2][4];
        fwd_chunk<l, 2, KS>(hi, ml, ad, shp, sw, sdw, 8 * nt0, g, c, lr, lc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
            head_tile<DT>(dmu, hi[i], ml[i], hv[nt0 + i], nt0 + i, c, sdb,
                          sW2, sdW2);
    }
}

// The middle layer of three: dh1 = (1 - h1^2)(dh0 W1 + h0 dW1 + db1) from
// dh0's fragments ai into dh1's, ao, 32 columns at a time
template <int KSI, int KSO>
__device__ __forceinline__ void mid_layer(uint32_t (&ao)[KSO][PL][4],
                                          uint32_t (&ai)[KSI][PL][4],
                                          const float* sh0, const float* sh1,
                                          char* smem, const float* sdb1,
                                          int g, int c, int lr, int lc) {
    const bf16* sw = reinterpret_cast<const bf16*>(smem + w_off(1));
    const bf16* sdw = reinterpret_cast<const bf16*>(smem + dw_off(1));
#pragma unroll
    for (int ch = 0; ch < ntiles(1) / 4; ++ch) {
        float hi[4][4], ml[4][4];
        fwd_chunk<1, 4, KSI>(hi, ml, ai, sh0, sw, sdw, 32 * ch, g, c, lr, lc);
#pragma unroll
        for (int i = 0; i < 4; ++i)
            dh_frag<1, KSO>(ao, hi[i], ml[i], 4 * ch + i, sh1, sdb1, g, c);
    }
    if constexpr (ntiles(1) % 4 != 0) {
        constexpr int nt0 = ntiles(1) / 4 * 4;
        float hi[2][4], ml[2][4];
        fwd_chunk<1, 2, KSI>(hi, ml, ai, sh0, sw, sdw, 8 * nt0, g, c, lr, lc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
            dh_frag<1, KSO>(ao, hi[i], ml[i], nt0 + i, sh1, sdb1, g, c);
    }
}

// g_l W_l^T for the N n-tiles of layer l-1 from column c0, over layer l's
// KS k-steps (g_l's A fragments in ag)
template <int l, int N, int KS>
__device__ __forceinline__ void rev_chunk(float (&hi)[N][4], float (&ml)[N][4],
                                          uint32_t (&ag)[KS][PL][4],
                                          const bf16* sw, int c0, int lr,
                                          int lc) {
    zero(hi);
    zero(ml);
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
        uint32_t r[N / 2][PL][4];
#pragma unroll
        for (int pp = 0; pp < N / 2; ++pp)
#pragma unroll
            for (int pl = 0; pl < PL; ++pl)
                ldmatrix_x4(r[pp][pl], sw + pl * wplane(l) +
                                           (c0 + 16 * pp + lr) * RS +
                                           16 * kk + lc);
        plane_mma<N, false>(hi, ml, ag[kk], r);
    }
}

// g_{l-1} at the N n-tiles from nt0 = (acc)(1 - h_{l-1}^2), h_{l-1}
// staged at shp; the per-column sums of this lane's two rows into cs
template <int l, int N>
__device__ __forceinline__ void rev_epi(float (&gv)[ntiles(l - 1)][4],
                                        float (&cs)[16],
                                        const float (&hi)[N][4],
                                        const float (&ml)[N][4], int nt0,
                                        const float* shp, int g, int c) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        const int nt = nt0 + i, k = 8 * nt + 2 * c;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const float2 hv = hpair<l - 1>(shp, g + 8 * hf, k);
            gv[nt][2 * hf] = (hi[i][2 * hf] + ml[i][2 * hf]) *
                             (1.f - hv.x * hv.x);
            gv[nt][2 * hf + 1] = (hi[i][2 * hf + 1] + ml[i][2 * hf + 1]) *
                                 (1.f - hv.y * hv.y);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) cs[2 * nt + e] = gv[nt][e] + gv[nt][2 + e];
    }
}

// g_{l-1} = (g_l W_l^T)(1 - h_{l-1}^2) in the accumulator layout, 32
// columns at a time, from g_l's A fragments ag; its column sums over this
// warp's samples added to gb (lane g keeping rows 8 g + 2 c + e)
template <int l, int KS>
__device__ __forceinline__ void rev_layer(float (&gv)[ntiles(l - 1)][4],
                                          float (&gb)[2],
                                          uint32_t (&ag)[KS][PL][4],
                                          char* smem, const float* shp,
                                          int g, int c, int lr, int lc) {
    constexpr int NTO = ntiles(l - 1);
    const bf16* sw = reinterpret_cast<const bf16*>(smem + w_off(l));
    float cs[16];
#pragma unroll
    for (int i = 2 * NTO; i < 16; ++i) cs[i] = 0.f;
#pragma unroll
    for (int ch = 0; ch < NTO / 4; ++ch) {
        float hi[4][4], ml[4][4];
        rev_chunk<l, 4, KS>(hi, ml, ag, sw, 32 * ch, lr, lc);
        rev_epi<l, 4>(gv, cs, hi, ml, 4 * ch, shp, g, c);
    }
    if constexpr (NTO % 4 != 0) {
        constexpr int nt0 = NTO / 4 * 4;
        float hi[2][4], ml[2][4];
        rev_chunk<l, 2, KS>(hi, ml, ag, sw, 8 * nt0, lr, lc);
        rev_epi<l, 2>(gv, cs, hi, ml, nt0, shp, g, c);
    }
    const float2 r = reduce_scatter16(cs, g);
    gb[0] += r.x;
    gb[1] += r.y;
}

// g_l's planes (gv, the accumulator layout) into this warp's exchange
// [3][s][RS] and, when FRAG, into the A fragments a of g_l W_l^T
template <int l, bool FRAG>
__device__ __forceinline__ void gv_planes(const float (&gv)[ntiles(l)][4],
                                          bf16* ex,
                                          uint32_t (*a)[PL][4], int g,
                                          int c) {
#pragma unroll
    for (int nt = 0; nt < ntiles(l); ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            uint32_t p[PL];
            split_pair(gv[nt][2 * hf], gv[nt][2 * hf + 1], p[0], p[1], p[2]);
#pragma unroll
            for (int pl = 0; pl < PL; ++pl) {
                *reinterpret_cast<uint32_t*>(
                    ex + pl * EXP + (g + 8 * hf) * RS + 8 * nt + 2 * c) = p[pl];
                if constexpr (FRAG) a[nt >> 1][pl][2 * (nt & 1) + hf] = p[pl];
            }
        }
}

// One 16 x (8 N) block of gW_l = h_{l-1}^T g_l (rows 16 mt.., columns
// 32 nh..) summed over the tile's samples, warp j's as k-step j: fresh
// sums, then into tot. h_{l-1} is staged fp32, split as it is read; g_l's
// planes are in the exchange.
template <int l, int N, int NW, int STG, int XR>
__device__ __forceinline__ void gw_job(float (&tot)[N][4], int mt, int nh,
                                       const float* sbuf, const bf16* sEx,
                                       int g, int c, int lr, int lc) {
    float fh[N][4], fm[N][4];
    zero(fh);
    zero(fm);
#pragma unroll
    for (int j = 0; j < NW; ++j) {
        const float* shj = sbuf + j * STG + SW * XR + (l - 1) * SW * HS;
        const bf16* exj = sEx + j * PL * EXP;
        uint32_t a[PL][4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int k = 16 * mt + g + 8 * (q & 1);
            const int s = 2 * c + 8 * (q >> 1);
            split_pair(hval<l - 1>(shj, s, k), hval<l - 1>(shj, s + 1, k),
                       a[0][q], a[1][q], a[2][q]);
        }
        uint32_t r[N / 2][PL][4];
#pragma unroll
        for (int qq = 0; qq < N / 2; ++qq)
#pragma unroll
            for (int pl = 0; pl < PL; ++pl)
                ldmatrix_x4_trans(r[qq][pl], exj + pl * EXP + lr * RS +
                                                 32 * nh + 16 * qq + lc);
        plane_mma<N, true>(fh, fm, a, r);
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[i][q] += fh[i][q] + fm[i][q];
}

// gW_l's 16 x 32 blocks (a 16-column one last where pad(l) is an odd
// number of 16s): block j = mt + MT nh to warp j % NW, its i-th as j =
// warp + NW i
template <int l>
struct GwJobs {
    static constexpr int MT = pad(l - 1) / 16, NC = (pad(l) + 31) / 32;
    static constexpr int JOBS = MT * NC;
};

template <int l, int NW, int JPW, int STG, int XR>
__device__ __forceinline__ void gw_tile(float (&tot)[JPW][4][4],
                                        const float* sbuf, const bf16* sEx,
                                        int warp, int g, int c, int lr,
                                        int lc) {
    using J = GwJobs<l>;
#pragma unroll
    for (int i = 0; i < JPW; ++i) {
        const int j = warp + NW * i;
        if (J::JOBS < NW * JPW && j >= J::JOBS) continue;
        const int mt = mod_<J::MT>(j), nh = div_<J::MT>(j);
        if (pad(l) % 32 == 0 || 32 * nh + 32 <= pad(l))
            gw_job<l, 4, NW, STG, XR>(tot[i], mt, nh, sbuf, sEx, g, c, lr,
                                      lc);
        else
            gw_job<l, 2, NW, STG, XR>(first<2>(tot[i]), mt, nh, sbuf, sEx, g,
                                      c, lr, lc);
    }
}

// gW_l's blocks of this warp into the block's partial (out at gW_l)
template <int l, int NW, int JPW>
__device__ __forceinline__ void write_gw(float* out,
                                         const float (&tot)[JPW][4][4],
                                         int warp, int g, int c) {
    using J = GwJobs<l>;
    constexpr int WI = wid(l - 1), WO = wid(l);
#pragma unroll
    for (int i = 0; i < JPW; ++i) {
        const int j = warp + NW * i;
        if (J::JOBS < NW * JPW && j >= J::JOBS) continue;
        const int mt = mod_<J::MT>(j), nh = div_<J::MT>(j);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int k = 16 * mt + g + 8 * hf, o = 32 * nh + 8 * nt + 2 * c;
                if (WI != pad(l - 1) && k >= WI) continue;
                if (WO % 32 == 0 || o < WO) out[k * WO + o] = tot[i][nt][2 * hf];
                if (WO % 32 == 0 || o + 1 < WO)
                    out[k * WO + o + 1] = tot[i][nt][2 * hf + 1];
            }
    }
}

// gW0 += x^T g0 over a share of the tile: warp w < CG S, columns
// 16 (w % CG).., the samples of warps j = w / CG, + S, ...
template <int XT, int NW, int STG, int CG, int S>
__device__ __forceinline__ void gw0_tile(float (&tot0)[XT][2][4],
                                         const float* sbuf, const bf16* sEx,
                                         int DO, int warp, int g, int c,
                                         int lr, int lc) {
    if (CG * S < NW && warp >= CG * S) return;
    const int cg = mod_<CG>(warp);
    float fh[XT][2][4], fm[XT][2][4];
    zero3(fh);
    zero3(fm);
#pragma unroll
    for (int j = div_<CG>(warp); j < NW; j += S) {
        const float* sxj = sbuf + j * STG;
        const bf16* exj = sEx + j * PL * EXP;
        uint32_t r[1][PL][4];
#pragma unroll
        for (int pl = 0; pl < PL; ++pl)
            ldmatrix_x4_trans(r[0][pl], exj + pl * EXP + lr * RS + 16 * cg + lc);
#pragma unroll
        for (int mi = 0; mi < XT; ++mi) {
            uint32_t a[PL][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int d = 16 * mi + g + 8 * (q & 1);
                const int s = 2 * c + 8 * (q >> 1);
                const bool ok = d < DO;
                split_pair(ok ? sxj[s * DO + d] : 0.f,
                           ok ? sxj[(s + 1) * DO + d] : 0.f, a[0][q], a[1][q],
                           a[2][q]);
            }
            plane_mma<2, true>(fh[mi], fm[mi], a, r);
        }
    }
#pragma unroll
    for (int i = 0; i < XT; ++i)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int q = 0; q < 4; ++q) tot0[i][t][q] += fh[i][t][q] + fm[i][t][q];
}

// H0, H1, H2: the hidden activations h_0 .. h_{L-1} (B, w_l), those past
// h_{L-1} unused
template <int XT, int DT>
__global__ void __launch_bounds__(Pick<XT, DT>::NT, 1) fvp_tc_kernel(
    const float* __restrict__ X, const float* __restrict__ H0,
    const float* __restrict__ H1, const float* __restrict__ H2,
    const bf16* __restrict__ Wp,
    const bf16* __restrict__ Vp, const float* __restrict__ WL,
    const float* __restrict__ scale, const float* __restrict__ v,
    float* __restrict__ partial, int B, int DO, int DA) {
    using PK = Pick<XT, DT>;
    using L = typename PK::L;
    // NL as a value of the template, so that the branches it leaves out
    // are not instantiated
    constexpr int NL = policy_shape::NL + 0 * XT;
    constexpr int NW = PK::NW, NT = PK::NT, TS = PK::TS, JPW = PK::JPW;
    constexpr int NB = L::NB, XR = L::XR, STG = L::STG;
    extern __shared__ __align__(16) char smem[];
    bf16* sdW0 = reinterpret_cast<bf16*>(smem + L::DW0);
    bf16* sEx = reinterpret_cast<bf16*>(smem + L::EX);
    float* sSt = reinterpret_cast<float*>(smem + L::ST);
    float* sW2 = reinterpret_cast<float*>(smem + L::W2);
    float* sdW2 = reinterpret_cast<float*>(smem + L::DW2);
    float* sdb = reinterpret_cast<float*>(smem + L::BI);   // db_l at l HMP
    float* sdb2 = reinterpret_cast<float*>(smem + L::C);
    float* sscale = sdb2 + DT;

    // flat parameter order (sorted keys): W0 .. W_L, b0 .. b_L, logstd
    const Flat f = policy_shape::flat(DO, DA);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    // ldmatrix lane addresses: rows lr, cols lc
    const int lr = lane & 15, lc = (lane >> 4) << 3;

    // prologue: the hidden-to-hidden weights' planes (per update) and v's
    // (per call; rows of dW0 past DO zero) from L2; the head's fp32
    // operands
    const int VP = gv_off(NL, DO);     // a plane of v's hidden-layer blocks
    if constexpr (NL > 1) load_planes<1>(smem, Wp, Vp, VP, DO, tid, NT);
    if constexpr (NL > 2) load_planes<2>(smem, Wp, Vp, VP, DO, tid, NT);
    {
        constexpr int CPR = pad(0) / 8;
        for (int i = tid; i < PL * XR * CPR; i += NT) {
            const int p = i / (XR * CPR), r = div_<CPR>(i) % XR,
                      q = mod_<CPR>(i);
            const bool ok = r < DO;
            cp_async16(sdW0 + p * L::W0P + r * RS + 8 * q,
                       Vp + p * VP + (ok ? r : 0) * pad(0) + 8 * q,
                       ok ? 16 : 0);
        }
    }
    for (int i = tid; i < HMP * DT; i += NT) {        // outputs padded
        const int k = i / DT, m = i % DT;
        const bool ok = m < DA && (wid(NL - 1) == HMP || k < wid(NL - 1));
        sW2[i] = ok ? WL[k * DA + m] : 0.f;
        sdW2[i] = ok ? v[f.W[NL] + k * DA + m] : 0.f;
    }
    if (tid < HMP) {
#pragma unroll
        for (int l = 0; l < NL; ++l)
            sdb[l * HMP + tid] =
                (wid(l) == HMP || tid < wid(l)) ? v[f.b[l] + tid] : 0.f;
    }
    if (tid < DT) {
        sdb2[tid] = tid < DA ? v[f.b[NL] + tid] : 0.f;
        sscale[tid] = tid < DA ? scale[tid] : 0.f;
    }

    const int n_tiles = (B + TS - 1) / TS;
    const int G = gridDim.x;
    // this warp's x (16 rows of DO floats, contiguous in X) and h_0 ..
    // h_{L-2} of a tile into staging buffer b; rows past B are zero
    auto stage = [&](int tile, int b) {
        float* sx = sSt + (b * NW + warp) * STG;
        const int s0 = tile * TS + warp * SW;
        const int ns = max(0, min(SW, B - s0));
        const int xbytes = ns * DO * 4;
        const char* xsrc = reinterpret_cast<const char*>(X + (size_t)s0 * DO);
        for (int q = lane; q < 4 * DO; q += 32) {
            const int nb = min(16, max(0, xbytes - 16 * q));
            cp_async16(sx + 4 * q, nb > 0 ? xsrc + 16 * q : (const char*)X, nb);
        }
        if constexpr (NL > 1) stage_h<0>(sx + SW * XR, H0, s0, ns, lane);
        if constexpr (NL > 2)
            stage_h<1>(sx + SW * XR + SW * HS, H1, s0, ns, lane);
    };

    // the block's weight-gradient totals: gW_l's blocks (tw[l - 1]);
    // gW0 rows 16 mi.., cols 16 (warp % CG).., this warp's share of the
    // samples
    float tw[NL > 1 ? NL - 1 : 1][JPW][4][4];
#pragma unroll
    for (int l = 0; l < (NL > 1 ? NL - 1 : 1); ++l) zero3(tw[l]);
    float tot0[XT][2][4];
    zero3(tot0);
    float aW2[2][DT];                  // gW_L rows 8 g + 2 c + e, this warp's
    zero(aW2);                         // samples
    float gb[NL][2];                   // the same rows of each db_l
    zero(gb);
    float gb2[(DT + 3) / 4];           // outputs c + 4 j, this lane's rows
#pragma unroll
    for (int j = 0; j < (DT + 3) / 4; ++j) gb2[j] = 0.f;

    if (NB == 2 && blockIdx.x < n_tiles) stage(blockIdx.x, 0);
    cp_async_commit();

    int buf = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += G, buf ^= NB - 1) {
        if constexpr (NB == 1) {
            __syncthreads();   // the last tile's reads done
            stage(tile, 0);
            cp_async_commit();
        }
        cp_async_wait<0>();
        __syncthreads();   // staged tile visible; the last tile's reads done
        if constexpr (NB == 2) {
            if (tile + G < n_tiles) stage(tile + G, buf ^ 1);
            cp_async_commit();
        }
        const float* sbuf = sSt + buf * NW * STG;
        const float* sx = sbuf + warp * STG;
        const float* sh0 = sx + SW * XR;           // h_0 (NL > 1)
        const float* sh1 = sh0 + SW * HS;          // h_1 (NL > 2)
        const int s0 = tile * TS + warp * SW;
        const int ns = max(0, min(SW, B - s0));
        bf16* ex = sEx + warp * PL * EXP;
        float gv[ntiles(NL > 1 ? NL - 2 : 0)][4];   // g_{L-2} (NL > 1)

        {   // the forward and the head over this warp's 16 samples; padding
            // rows (a warp past B has 16) get u = 0, so every g is 0 there
            constexpr int NG0 = (ntiles(0) + 3) / 4;
            float hv[NTL][4];          // h_{L-1} in the accumulator layout
            float dmu[2][DT];
            zero(dmu);
            if constexpr (NL == 1) {
                // ---- dmu from dh0 = (1 - h0^2)(x dW0 + db0)
#pragma unroll
                for (int nt = 0; nt < NTL; ++nt)
                    load_hl(hv[nt], H0, s0, ns, nt, g, c);
                float hi[NG0][4][4], ml[NG0][4][4];
                x_product<XT, NG0>(hi, ml, sx, DO, sdW0, g, c, lr, lc);
#pragma unroll
                for (int nt = 0; nt < NTL; ++nt)
                    head_tile<DT>(dmu, hi[nt >> 2][nt & 3], ml[nt >> 2][nt & 3],
                                  hv[nt], nt, c, sdb, sW2, sdW2);
            } else {
                // ---- dh0 = (1 - h0^2)(x dW0 + db0), into its planes as
                // the A fragments of the next product (k-step kk: n-tiles
                // 2 kk, 2 kk + 1)
                uint32_t ad0[ksteps(0)][PL][4];
                {
                    float hi[NG0][4][4], ml[NG0][4][4];    // n-tiles 4 hh + i
                    x_product<XT, NG0>(hi, ml, sx, DO, sdW0, g, c, lr, lc);
#pragma unroll
                    for (int nt = 0; nt < ntiles(0); ++nt)
                        dh_frag<0, ksteps(0)>(ad0, hi[nt >> 2][nt & 3],
                                              ml[nt >> 2][nt & 3], nt, sh0,
                                              sdb, g, c);
                }
                // ---- dh_l for l = 1 .. L-1, 32 columns at a time; the
                // last one's into dmu's partial sums over this lane's
                // columns
                if constexpr (NL == 2) {
                    last_layer<DT, ksteps(0)>(hv, dmu, ad0, sh0, smem,
                                              H1, s0, ns, sdb + HMP, sW2,
                                              sdW2, g, c, lr, lc);
                } else {
                    uint32_t ad1[ksteps(1)][PL][4];
                    mid_layer<ksteps(0), ksteps(1)>(ad1, ad0, sh0, sh1, smem,
                                                    sdb + HMP, g, c, lr, lc);
                    last_layer<DT, ksteps(1)>(hv, dmu, ad1, sh1, smem,
                                              H2, s0, ns, sdb + 2 * HMP,
                                              sW2, sdW2, g, c, lr, lc);
                }
            }

            // ---- u = (dmu + db_L) * scale (0 on padded samples): the
            // quad's four column shares summed; every lane of the quad gets
            // the same
            float u[2][DT];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf)
#pragma unroll
                for (int m = 0; m < DT; ++m) {
                    u[hf][m] = 0.f;
                    if (m < DA) {
                        float s = dmu[hf][m];
                        s += __shfl_xor_sync(FULL, s, 1);
                        s += __shfl_xor_sync(FULL, s, 2);
                        if (g + 8 * hf < ns) u[hf][m] = (s + sdb2[m]) * sscale[m];
                    }
                }
#pragma unroll
            for (int m = 0; m < DT; ++m)
                if ((m & 3) == c) gb2[m >> 2] += u[0][m] + u[1][m];
            // gW_L += h_{L-1}^T u, over the warp's rows, lane g keeping rows
            // 8 g + 2 c + e
#pragma unroll
            for (int m = 0; m < DT; ++m) {
                if (m >= DA) break;
                float t[16];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        if (nt < NTL)
                            t[2 * nt + e] = fmaf(hv[nt][2 + e], u[1][m],
                                                 hv[nt][e] * u[0][m]);
                        else
                            t[2 * nt + e] = 0.f;
                    }
                const float2 r = reduce_scatter16(t, g);
                aW2[0][m] += r.x;
                aW2[1][m] += r.y;
            }
            // g_{L-1} = (u W_L^T)(1 - h_{L-1}^2): its planes as the A
            // fragments of g_{L-1} W_{L-1}^T and into the exchange; gb_{L-1}
            uint32_t ag[ksteps(NL - 1)][PL][4];
            {
                float cs[16];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    if (nt >= NTL) {
                        cs[2 * nt] = cs[2 * nt + 1] = 0.f;
                        continue;
                    }
                    float gt[4];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int o = 8 * nt + 2 * c + e;
                        float w[DT];
#pragma unroll
                        for (int m = 0; m < DT; m += 4) {
                            const float4 a = *reinterpret_cast<const float4*>(sW2 + o * DT + m);
                            w[m] = a.x; w[m + 1] = a.y; w[m + 2] = a.z; w[m + 3] = a.w;
                        }
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            float s = u[hf][0] * w[0];
#pragma unroll
                            for (int m = 1; m < DT; ++m) s = fmaf(u[hf][m], w[m], s);
                            const float h = hv[nt][2 * hf + e];
                            gt[2 * hf + e] = s * (1.f - h * h);
                        }
                        cs[2 * nt + e] = gt[e] + gt[2 + e];
                    }
                    const int kk = nt >> 1, j = 2 * (nt & 1);
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        uint32_t (&a)[PL][4] = ag[kk];
                        split_pair(gt[2 * hf], gt[2 * hf + 1], a[0][j + hf],
                                   a[1][j + hf], a[2][j + hf]);
#pragma unroll
                        for (int pl = 0; pl < PL; ++pl)
                            *reinterpret_cast<uint32_t*>(
                                ex + pl * EXP + (g + 8 * hf) * RS + 8 * nt + 2 * c) =
                                a[pl][j + hf];
                    }
                }
                const float2 r = reduce_scatter16(cs, g);
                gb[NL - 1][0] += r.x;
                gb[NL - 1][1] += r.y;
            }

            // ---- g_{L-2} = (g_{L-1} W_{L-1}^T)(1 - h_{L-2}^2), 32 columns
            // at a time; gb_{L-2}
            if constexpr (NL > 1)
                rev_layer<NL - 1, ksteps(NL - 1)>(gv, gb[NL - 2], ag, smem,
                                                  NL > 2 ? sh1 : sh0, g, c,
                                                  lr, lc);
        }
        __syncthreads();   // every warp's g_{L-1} planes in the exchange

        if constexpr (NL > 1) {
            // gW_{L-1} += h_{L-2}^T g_{L-1} over the tile
            gw_tile<NL - 1, NW, JPW, STG, XR>(tw[NL - 2], sbuf, sEx, warp, g,
                                              c, lr, lc);
            __syncthreads();   // every warp done with g_{L-1}'s planes
            if constexpr (NL > 2) {
                // g1's planes into the exchange and into the A fragments of
                // g1 W1^T; g0 = (g1 W1^T)(1 - h0^2)
                uint32_t a1[ksteps(1)][PL][4];
                gv_planes<1, true>(gv, ex, a1, g, c);
                float g0v[ntiles(0)][4];
                rev_layer<1, ksteps(1)>(g0v, gb[0], a1, smem, sh0, g, c, lr,
                                        lc);
                __syncthreads();   // every warp's g1 planes in the exchange
                gw_tile<1, NW, JPW, STG, XR>(tw[0], sbuf, sEx, warp, g, c, lr,
                                             lc);
                __syncthreads();   // every warp done with the g1 planes
                gv_planes<0, false>(g0v, ex, nullptr, g, c);
            } else {
                gv_planes<0, false>(gv, ex, nullptr, g, c);
            }
            __syncthreads();   // every warp's g0 planes in the exchange
        }

        // gW0 += x^T g0 over a share of the tile
        gw0_tile<XT, NW, STG, L::CG, L::S>(tot0, sbuf, sEx, DO, warp, g, c,
                                           lr, lc);
    }
    cp_async_wait<0>();
    __syncthreads();

    // the block's partial: gW_l straight from the fragments; gW0's shares,
    // gW_L and the bias sums through shared scratch, summed over the warps
    // in order
    float* out = partial + (size_t)blockIdx.x * f.ls;
    if constexpr (NL > 1) write_gw<1, NW, JPW>(out + f.W[1], tw[0], warp, g, c);
    if constexpr (NL > 2) write_gw<2, NW, JPW>(out + f.W[2], tw[1], warp, g, c);
    float* rW2 = reinterpret_cast<float*>(smem + L::SCR);   // [warp][o][DT]
    float* rB = rW2 + NW * 64 * DT;    // [l][warp][o]
    float* rB2 = rB + NL * NW * 64;    // [warp][m]
    float* rW0 = rB2 + NW * DT;        // [share][d][h]
    if (L::CG * L::S == NW || warp < L::CG * L::S) {
        const int cg = mod_<L::CG>(warp), sp = div_<L::CG>(warp);
#pragma unroll
        for (int mi = 0; mi < XT; ++mi)
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int d = 16 * mi + g + 8 * hf;
                    const int h = 16 * cg + 8 * t + 2 * c;
                    float* o = rW0 + (sp * XR + d) * pad(0) + h;
                    o[0] = tot0[mi][t][2 * hf];
                    o[1] = tot0[mi][t][2 * hf + 1];
                }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int o = 8 * g + 2 * c + e;
#pragma unroll
        for (int m = 0; m < DT; ++m) rW2[(warp * 64 + o) * DT + m] = aW2[e][m];
#pragma unroll
        for (int l = 0; l < NL; ++l) rB[(l * NW + warp) * 64 + o] = gb[l][e];
    }
#pragma unroll
    for (int j = 0; j < (DT + 3) / 4; ++j) {
        float s = gb2[j];
        s += __shfl_xor_sync(FULL, s, 4);
        s += __shfl_xor_sync(FULL, s, 8);
        s += __shfl_xor_sync(FULL, s, 16);
        if (g == 0 && c + 4 * j < DT) rB2[warp * DT + c + 4 * j] = s;
    }
    __syncthreads();
    constexpr int W0 = wid(0);
    for (int e = tid; e < DO * W0; e += NT) {
        // gW0's (d, h) in the shares' (XR, pad(0)) rows
        const int i = W0 == pad(0) ? e : e / W0 * pad(0) + e % W0;
        float s = rW0[i];
#pragma unroll
        for (int sp = 1; sp < L::S; ++sp) s += rW0[sp * XR * pad(0) + i];
        out[e] = s;
    }
    constexpr int WLI = wid(NL - 1);    // the head's inputs
    for (int e = tid; e < WLI * DA; e += NT) {
        const int k = e / DA, m = e % DA;
        float s = rW2[k * DT + m];
        for (int w = 1; w < NW; ++w) s += rW2[(w * 64 + k) * DT + m];
        out[f.W[NL] + e] = s;
    }
    if (tid < HMP) {                   // every layer's sum at once
        float s[NL];
#pragma unroll
        for (int l = 0; l < NL; ++l) s[l] = rB[l * NW * 64 + tid];
        for (int w = 1; w < NW; ++w)
#pragma unroll
            for (int l = 0; l < NL; ++l) s[l] += rB[(l * NW + w) * 64 + tid];
#pragma unroll
        for (int l = 0; l < NL; ++l)
            if (wid(l) == HMP || tid < wid(l)) out[f.b[l] + tid] = s[l];
    }
    if (tid < DA) {
        float s = rB2[tid];
        for (int w = 1; w < NW; ++w) s += rB2[w * DT + tid];
        out[f.b[NL] + tid] = s;
    }
}


// ------------------------------------------------------------ wide form
// At a hidden layer over 64 units (policy_shape::WIDE; the TPU kernel's
// unpacked `_fvp_kernel`, which JAX runs past its packed width) the layout
// above does not fit one block: W_l's and dW_l's three bf16 planes alone
// come to 253 KB at (100, 50, 25) and 418 KB at (128, 128, 128) at its row
// strides, and a warp's 16 samples of two 128-wide layers' A fragments
// and accumulators pass 255 registers. The wide form keeps its arithmetic
// (every fp32 operand of a hidden layer's product split into three bf16
// planes, the six plane products that hold fp32's 24 bits summed on
// mma.sync m16n8k16, hi hi in its own accumulator; the da-wide head in
// fp32 on the CUDA cores) and runs a CG call as a chain of launches, each
// holding one layer's planes in shared memory for its whole grid, so every
// staged byte serves all of a block's samples:
//   fwd<0>       dh0 = (1-h0^2)(x dW0 + db0)                     -> buf0
//                (made inside fwd<1> instead, k-step by k-step, where
//                dW0's planes fit beside W1's: Fwd::FUSE0)
//   fwd<l>       dh_l = (1-h_l^2)(dh_{l-1} W_l + h_{l-1} dW_l + db_l)
//                -> buf_l, l = 1 .. L-2
//   fwd<L-1>     the same, then the head: dmu = dh W_L + h dW_L + db_L,
//                u = dmu scale (0 past B), g_{L-1} = (u W_L^T)(1-h^2)
//                -> buf_{L-1}, u
//   rev<l>       g_{l-1} = (g_l W_l^T)(1-h_{l-1}^2) -> buf_{l-1} (dh_{l-1}
//                there is dead), l = L-1 .. 1
//   grad         every [a_j; 1]^T g_j (a_0 = x, a_j = h_{j-1}, g_L = u):
//                the weight gradients with the bias sums as their last
//                row, over a fixed split of the samples a block
//   reduce       fvp_tile.cuh's, over the splits, with 2 v and damping v
// The per-sample launches (fwd, rev) take samples as the mma's M, 16 a
// warp, as the form above does: a warp loads its rows of the fp32 inputs
// from global memory straight into the A fragment's layout, splits them in
// registers and accumulates every output column of its rows at once (hi
// and ml over pad(l) / 8 n-tiles), so each input element is read and split
// once; the output's accumulator layout is the next launch's A fragment
// layout, lane for lane. B operands (W_l and dW_l as [in][out], W_l^T as
// [out][in]) are kept in fragment order (frag_index): the weights split
// once per update in both orientations (trpo_fvp_split_launch), v's blocks
// once per call, each block copying them whole into shared memory and
// reading each n-pair's fragments of a plane as one 16-byte load a lane.
// Nothing sums across samples there, so the grid (as many blocks as are
// resident, occupancy) changes no result. The grad launch takes features
// as M and samples as K: a block owns a GT x GT tile of one layer's
// gradient over one split of SPLIT samples, stages KC samples of both
// operands at a time as planes (each element split once) and keeps its
// sums in registers; the splits' partials are summed by the reduce pass in
// a fixed order. No float atomics, so repeat calls are bit-identical.
// What bounds it on an H100: at c3-rllab ((100, 50, 25), 102,400 samples,
// do 24, da 7) the function is 30.5k MACs a sample, 6.25 GFLOP a call
// (0.006 ms at the bf16 peak), and its inputs 81.5 MB (0.024 ms at 3.35
// TB/s): the bytes bound it. This form moves more: the inputs two or
// three times and each buf_l written and read back, about 0.55 GB at
// c3-rllab (0.16 ms at 3.35 TB/s before L2 hits), the price of one
// layer's planes a launch; grad's reads are most of its time (PERF.md).
namespace wide {

constexpr int NW = 8, NT = 32 * NW;    // warps, threads a block
constexpr int KC = 32;                 // samples a chunk of the grad launch
constexpr int GT = 64;                 // its output tile, rows and columns
constexpr int GS = GT + 8;             // bf16 row stride of its staged planes
constexpr int GST = 4;                 // its fp32 stages (GST - 1 in flight)
constexpr int G_PLANES = 2 * PL * KC * GS * 2;    // its bytes: the planes,
constexpr int G_SMEM = G_PLANES + 2 * GST * KC * GT * 4;   // and the stages
constexpr int SPLIT = 512;             // samples a split (trpo_fvp_tile)

// bf16 elements of the three planes of a (K, N) B operand (multiples of 16)
__host__ __device__ constexpr int frag(int K, int N) { return PL * K * N; }

// Fragment order: for each k-step kk, n-pair np (n-tiles 2 np, 2 np + 1)
// and plane p, 32 lanes of 16 bytes, lane (g, c) holding b0, b1 of n-tile
// 2 np and b0, b1 of 2 np + 1 (b0: rows 2c, 2c + 1 of the k-step, b1: rows
// 2c + 8, 2c + 9, column g; the lower row in the low half). The index of
// element (k, n) of plane p:
__host__ __device__ inline int frag_index(int N, int p, int k, int n) {
    const int kr = k & 15;
    const int lane = (n & 7) * 4 + ((kr & 7) >> 1);
    const int r = ((n >> 3) & 1) * 2 + (kr >> 3);
    return (((((k >> 4) * (N >> 4) + (n >> 4)) * PL + p) * 32 + lane) * 4 +
            r) * 2 + (kr & 1);
}

// The workspace's planes: W_1 .. W_{L-1} as B of the forward (K = pad(l-1),
// N = pad(l)), then as B of the reverse (W_l^T: K = pad(l), N = pad(l-1))
__host__ __device__ constexpr int wf_off(int l) {
    int o = 0;
    for (int m = 1; m < l; ++m) o += frag(pad(m - 1), pad(m));
    return o;
}
__host__ __device__ constexpr int wt_off(int l) { return wf_off(NL) + wf_off(l); }
// v's planes, per call: dW0 (K = 16 XT, N = pad(0)), then dW_l as W_l's
__host__ __device__ constexpr int vf_off(int l, int XT) {
    return l == 0 ? 0 : frag(16 * XT, pad(0)) + wf_off(l);
}

// The scratch after the grad launch's partials (n_blocks x Pg floats,
// rounded up to 64): buf_l (B, pad(l)), l = 0 .. L-1, then u (B, DT)
inline size_t scratch_off(int n_blocks, int Pg) {
    return ((size_t)n_blocks * Pg + 63) / 64 * 64;
}
inline size_t scratch_floats(int B, int DT) {
    size_t n = (size_t)B * DT;
    for (int l = 0; l < NL; ++l) n += (size_t)B * pad(l);
    return n;
}

// what every launch of a call reads and writes
struct Args {
    const float* X;          // (B, do)
    const float* H[3];       // h_0 .. h_{L-1} (B, w_l)
    const bf16* Wp;          // the workspace's planes
    const bf16* Vp;          // v's planes
    const float* WL;         // the head's weights (w_{L-1}, da)
    const float* scale;      // (da) exp(-2 logstd) / B
    const float* v;
    float* buf[3];           // buf_l (B, pad(l))
    float* u;                // (B, DT)
    int B, DO, DA;
    int fW[4], fb[4], ls;    // policy_shape::flat(DO, DA)'s offsets
};

// elements k, k + 1 (k even) of row r of a row-major fp32 array of row
// stride S, zero from column W on; EVEN: S even, so that the pair is one
// aligned 8-byte load
template <bool EVEN>
__device__ __forceinline__ float2 pair(const float* M, int r, int S, int W,
                                       int k) {
    const float* p = M + (size_t)r * S + k;
    if constexpr (EVEN) {
        return k < W ? __ldg(reinterpret_cast<const float2*>(p))
                     : make_float2(0.f, 0.f);
    } else {
        return make_float2(k < W ? __ldg(p) : 0.f,
                           k + 1 < W ? __ldg(p + 1) : 0.f);
    }
}

// The A fragment of k-step kk for the 16 rows from s0 (zero from row B on),
// split into its planes
template <bool EVEN>
__device__ __forceinline__ void a_planes(uint32_t (&a)[PL][4], const float* M,
                                         int S, int W, int s0, int B, int kk,
                                         int g, int c) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        const int r = s0 + g + 8 * (q & 1), k = 16 * kk + 2 * c + 8 * (q >> 1);
        const float2 e = r < B ? pair<EVEN>(M, r, S, W, k)
                               : make_float2(0.f, 0.f);
        split_pair(e.x, e.y, a[0][q], a[1][q], a[2][q]);
    }
}

// n-tiles i .. i + N - 1 of a
template <int N, int M>
__device__ __forceinline__ auto at(float (&a)[M][4], int i) -> float (&)[N][4] {
    return *reinterpret_cast<float(*)[N][4]>(&a[i]);
}

// hi, ml += the plane products of A (ap) with k-step kk of a B operand of
// NP n-pairs in fragment order (sB, shared memory), over its PN n-pairs
// from p0, two n-pairs at a time
template <int NP, int PN>
__device__ __forceinline__ void products(float (&hi)[2 * PN][4],
                                         float (&ml)[2 * PN][4],
                                         const uint32_t (&ap)[PL][4],
                                         const bf16* sB, int kk, int p0,
                                         int lane) {
    const uint4* b =
        reinterpret_cast<const uint4*>(sB) + (kk * NP + p0) * PL * 32 + lane;
#pragma unroll
    for (int q = 0; q < PN; q += 2) {
        if (q + 2 <= PN) {
            uint32_t r[2][PL][4];
#pragma unroll
            for (int pp = 0; pp < 2; ++pp)
#pragma unroll
                for (int pl = 0; pl < PL; ++pl) {
                    const uint4 x = b[((q + pp) * PL + pl) * 32];
                    r[pp][pl][0] = x.x; r[pp][pl][1] = x.y;
                    r[pp][pl][2] = x.z; r[pp][pl][3] = x.w;
                }
            plane_mma<4, true>(at<4>(hi, 2 * q), at<4>(ml, 2 * q), ap, r);
        } else {
            uint32_t r[1][PL][4];
#pragma unroll
            for (int pl = 0; pl < PL; ++pl) {
                const uint4 x = b[(q * PL + pl) * 32];
                r[0][pl][0] = x.x; r[0][pl][1] = x.y;
                r[0][pl][2] = x.z; r[0][pl][3] = x.w;
            }
            plane_mma<2, true>(at<2>(hi, 2 * q), at<2>(ml, 2 * q), ap, r);
        }
    }
}

// bytes 16 at a time, global -> shared, by the block's threads
__device__ __forceinline__ void copy16(char* dst, const void* src, int bytes,
                                       int tid) {
    const char* s = static_cast<const char*>(src);
    for (int i = 16 * tid; i < bytes; i += 16 * NT)
        cp_async16(dst + i, s + i, 16);
}

// shared memory of fwd<l>: [W_l's planes (l >= 1)] [dW_l's (dW0's at l =
// 0)] [db_l (pad(l))] and, where fwd<1> takes layer 0 in (FUSE0: its
// planes fit), [dW0's planes] [db0]; for the last layer then the head's
// fp32 W_L and dW_L (pad(l), DT) [o][m], db_L and scale (DT)
template <int l, int XT, int DT>
struct Fwd {
    static constexpr bool LAST = l == NL - 1;
    static constexpr int K = l == 0 ? 16 * XT : pad(l - 1), N = pad(l);
    static constexpr int PB = frag(K, N) * 2;
    static constexpr int PB0 = frag(16 * XT, pad(0)) * 2;
    static constexpr int W = 0, DW = l == 0 ? 0 : PB;
    static constexpr int DB = DW + PB;
    static constexpr int F0 = DB + N * 4;          // dW0's planes, db0
    static constexpr int HEAD = 2 * N * DT * 4 + 2 * DT * 4;
    static constexpr bool FUSE0 =
        l == 1 && NL > 1 && F0 + PB0 + pad(0) * 4 + (LAST ? HEAD : 0) <= 232448;
    static constexpr int DW0 = F0, DB0 = F0 + PB0;
    static constexpr int HW = FUSE0 ? DB0 + pad(0) * 4 : F0;
    static constexpr int HDW = HW + N * DT * 4, HC = HDW + N * DT * 4;
    static constexpr int BYTES = LAST ? HW + HEAD : HW;
    // the k-steps rolled, not unrolled, where unrolling them would spill
    static constexpr bool ROLL = (LAST || FUSE0) && N > 96;
    // two blocks an SM where a narrow layer's registers and planes allow
    static constexpr int MINB = N <= 64 && !FUSE0 && 2 * BYTES <= 232448 ? 2 : 1;
    static_assert(BYTES <= 232448, "one block's shared memory");
};

// hi, ml over PN n-pairs from P0 of layer l for the warp's 16 samples
// from s0: x dW0 at l = 0, else dh_{l-1} W_l + h_{l-1} dW_l, k-step by
// k-step (each A fragment loaded and split once). With layer 0 fused in
// (l = 1), k-step kk's dh0 is made here, from x's planes and n-pair kk of
// dW0's, as fwd<0> makes it; h0's values serve both (1 - h0^2) and the
// A fragment of h0 dW1.
template <int l, int XT, int DT, int P0, int PN>
__device__ __forceinline__ void fwd_acc(float (&hi)[2 * PN][4],
                                        float (&ml)[2 * PN][4], const Args& a,
                                        const char* smem, int s0, int g,
                                        int c, int lane) {
    using F = Fwd<l, XT, DT>;
    constexpr int K = F::K, NP = F::N / 16;
    const bf16* sW = reinterpret_cast<const bf16*>(smem + F::W);
    const bf16* sDW = reinterpret_cast<const bf16*>(smem + F::DW);
    zero(hi);
    zero(ml);
    uint32_t ax[F::FUSE0 ? XT : 1][PL][4];
    if constexpr (F::FUSE0)
#pragma unroll
        for (int kx = 0; kx < XT; ++kx)
            a_planes<false>(ax[kx], a.X, a.DO, a.DO, s0, a.B, kx, g, c);
    auto step = [&](int kk) {
        uint32_t ap[PL][4];
        if constexpr (l == 0) {
            a_planes<false>(ap, a.X, a.DO, a.DO, s0, a.B, kk, g, c);
            products<NP, PN>(hi, ml, ap, sDW, kk, P0, lane);
        } else if constexpr (F::FUSE0) {
            const bf16* sDW0 = reinterpret_cast<const bf16*>(smem + F::DW0);
            const float* sdb0 = reinterpret_cast<const float*>(smem + F::DB0);
            float th[2][4], tm[2][4];
            zero(th);
            zero(tm);
#pragma unroll
            for (int kx = 0; kx < XT; ++kx)
                products<pad(0) / 16, 1>(th, tm, ax[kx], sDW0, kx, kk, lane);
            uint32_t ah[PL][4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int r = s0 + g + 8 * (q & 1), hf = q & 1, nt = q >> 1;
                const int k = 16 * kk + 2 * c + 8 * nt;
                const float2 hv = r < a.B
                    ? pair<wid(0) % 2 == 0>(a.H[0], r, wid(0), wid(0), k)
                    : make_float2(0.f, 0.f);
                const float d0 = (1.f - hv.x * hv.x) *
                                 ((th[nt][2 * hf] + tm[nt][2 * hf]) + sdb0[k]);
                const float d1 = (1.f - hv.y * hv.y) *
                                 ((th[nt][2 * hf + 1] + tm[nt][2 * hf + 1]) + sdb0[k + 1]);
                split_pair(d0, d1, ap[0][q], ap[1][q], ap[2][q]);
                split_pair(hv.x, hv.y, ah[0][q], ah[1][q], ah[2][q]);
            }
            products<NP, PN>(hi, ml, ap, sW, kk, P0, lane);
            products<NP, PN>(hi, ml, ah, sDW, kk, P0, lane);
        } else {
            a_planes<true>(ap, a.buf[l - 1], K, K, s0, a.B, kk, g, c);
            products<NP, PN>(hi, ml, ap, sW, kk, P0, lane);
            a_planes<wid(l - 1) % 2 == 0>(ap, a.H[l - 1], wid(l - 1),
                                          wid(l - 1), s0, a.B, kk, g, c);
            products<NP, PN>(hi, ml, ap, sDW, kk, P0, lane);
        }
    };
    if constexpr (F::ROLL) {
#pragma unroll 1
        for (int kk = 0; kk < K / 16; ++kk) step(kk);
    } else {
#pragma unroll
        for (int kk = 0; kk < K / 16; ++kk) step(kk);
    }
}

// The head's share of n-pairs P0 .. P0 + PN - 1 of the last hidden layer:
// dh = (1 - h^2)(acc + db), dmu += dh W_L + h dW_L over this lane's columns
template <int l, int XT, int DT, int P0, int PN>
__device__ __forceinline__ void head_cols(float (&dmu)[2][DT], const Args& a,
                                          const char* smem, const float* sdb,
                                          const float* sW2, const float* sdW2,
                                          int s0, int g, int c, int lane) {
    constexpr bool HEVEN = wid(l) % 2 == 0;
    float hi[2 * PN][4], ml[2 * PN][4];
    fwd_acc<l, XT, DT, P0, PN>(hi, ml, a, smem, s0, g, c, lane);
#pragma unroll
    for (int i = 0; i < 2 * PN; ++i) {
        const int nt = 2 * P0 + i;
        float2 hv[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = s0 + g + 8 * hf;
            hv[hf] = r < a.B ? pair<HEVEN>(a.H[l], r, wid(l), wid(l),
                                           8 * nt + 2 * c)
                             : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const int o = 8 * nt + 2 * c + e;
            const float db = sdb[o];
            float w[DT], dw[DT];
#pragma unroll
            for (int m = 0; m < DT; m += 4) {
                const float4 x = *reinterpret_cast<const float4*>(sW2 + o * DT + m);
                const float4 y = *reinterpret_cast<const float4*>(sdW2 + o * DT + m);
                w[m] = x.x; w[m + 1] = x.y; w[m + 2] = x.z; w[m + 3] = x.w;
                dw[m] = y.x; dw[m + 1] = y.y; dw[m + 2] = y.z; dw[m + 3] = y.w;
            }
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const float h = e ? hv[hf].y : hv[hf].x;
                const float dh = (1.f - h * h) *
                                 ((hi[i][2 * hf + e] + ml[i][2 * hf + e]) + db);
#pragma unroll
                for (int m = 0; m < DT; ++m)
                    dmu[hf][m] = fmaf(h, dw[m], fmaf(dh, w[m], dmu[hf][m]));
            }
        }
    }
}

// head_cols over the last layer's n-pairs P0 .. NP - 1, NPC at a time
template <int l, int XT, int DT, int P0, int NPC, int NP>
__device__ __forceinline__ void head_passes(float (&dmu)[2][DT],
                                            const Args& a, const char* smem,
                                            const float* sdb, const float* sW2,
                                            const float* sdW2, int s0, int g,
                                            int c, int lane) {
    if constexpr (P0 < NP) {
        constexpr int PN = NPC < NP - P0 ? NPC : NP - P0;
        head_cols<l, XT, DT, P0, PN>(dmu, a, smem, sdb, sW2, sdW2, s0, g, c,
                                     lane);
        head_passes<l, XT, DT, P0 + PN, NPC, NP>(dmu, a, smem, sdb, sW2, sdW2,
                                                 s0, g, c, lane);
    }
}

template <int l, int XT, int DT>
__global__ void __launch_bounds__(NT, (Fwd<l, XT, DT>::MINB)) fwd_kernel(Args a) {
    using F = Fwd<l, XT, DT>;
    constexpr int N = F::N, NTN = N / 8, NP = N / 16;
    // the last layer's columns in passes (of 64, or of 32 with the widest
    // head) past 96 units, so that its accumulators and the head's
    // operands fit the registers
    constexpr int NPC = F::LAST && NP > 6 ? (DT > 4 ? 2 : 4) : NP;
    extern __shared__ __align__(16) char smem[];
    float* sdb = reinterpret_cast<float*>(smem + F::DB);
    float* sW2 = reinterpret_cast<float*>(smem + F::HW);
    float* sdW2 = reinterpret_cast<float*>(smem + F::HDW);
    float* sdb2 = reinterpret_cast<float*>(smem + F::HC);
    float* sscale = sdb2 + DT;
    const Flat f = policy_shape::flat(a.DO, a.DA);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;

    // prologue: the planes (v's per call, W_l's per update), db_l, the head
    copy16(smem + F::DW, a.Vp + vf_off(l, XT), F::PB, tid);
    if constexpr (l > 0) copy16(smem + F::W, a.Wp + wf_off(l), F::PB, tid);
    if constexpr (F::FUSE0) {
        copy16(smem + F::DW0, a.Vp + vf_off(0, XT), F::PB0, tid);
        float* sdb0 = reinterpret_cast<float*>(smem + F::DB0);
        for (int i = tid; i < pad(0); i += NT)
            sdb0[i] = i < wid(0) ? a.v[f.b[0] + i] : 0.f;
    }
    cp_async_commit();
    for (int i = tid; i < N; i += NT) sdb[i] = i < wid(l) ? a.v[f.b[l] + i] : 0.f;
    if constexpr (F::LAST) {
        for (int i = tid; i < N * DT; i += NT) {
            const int k = i / DT, m = i % DT;
            const bool ok = m < a.DA && k < wid(l);
            sW2[i] = ok ? a.WL[k * a.DA + m] : 0.f;
            sdW2[i] = ok ? a.v[f.W[NL] + k * a.DA + m] : 0.f;
        }
        if (tid < DT) {
            sdb2[tid] = tid < a.DA ? a.v[f.b[NL] + tid] : 0.f;
            sscale[tid] = tid < a.DA ? a.scale[tid] : 0.f;
        }
    }
    cp_async_wait<0>();
    __syncthreads();

    constexpr bool HEVEN = wid(l) % 2 == 0;     // h_l's rows a whole float2
    const float* H = a.H[l];
    const int n_chunks = (a.B + 15) / 16;
    for (int ch = blockIdx.x * NW + warp; ch < n_chunks; ch += gridDim.x * NW) {
        const int s0 = 16 * ch;
        if constexpr (!F::LAST) {
            // dh_l = (1 - h_l^2)(acc + db_l) into buf_l
            float hi[NTN][4], ml[NTN][4];
            fwd_acc<l, XT, DT, 0, NP>(hi, ml, a, smem, s0, g, c, lane);
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt) {
                const int k = 8 * nt + 2 * c;
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int r = s0 + g + 8 * hf;
                    if (r >= a.B) continue;
                    const float2 hv = pair<HEVEN>(H, r, wid(l), wid(l), k);
                    float2 d;
                    d.x = (1.f - hv.x * hv.x) *
                          ((hi[nt][2 * hf] + ml[nt][2 * hf]) + sdb[k]);
                    d.y = (1.f - hv.y * hv.y) *
                          ((hi[nt][2 * hf + 1] + ml[nt][2 * hf + 1]) + sdb[k + 1]);
                    *reinterpret_cast<float2*>(a.buf[l] + (size_t)r * N + k) = d;
                }
            }
        } else {
            // the head: dmu over the columns, then u and g_{L-1}
            float dmu[2][DT];
            zero(dmu);
            head_passes<l, XT, DT, 0, NPC, NP>(dmu, a, smem, sdb, sW2, sdW2,
                                               s0, g, c, lane);
            // u = (dmu + db_L) scale (0 past B): the quad's four column
            // shares summed, every lane of the quad the same; lane c
            // writes outputs c, c + 4
            float u[2][DT];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int r = s0 + g + 8 * hf;
#pragma unroll
                for (int m = 0; m < DT; ++m) {
                    float s = dmu[hf][m];
                    s += __shfl_xor_sync(FULL, s, 1);
                    s += __shfl_xor_sync(FULL, s, 2);
                    u[hf][m] = m < a.DA && r < a.B ? (s + sdb2[m]) * sscale[m] : 0.f;
                }
                if (r < a.B)
#pragma unroll
                    for (int m = 0; m < DT; ++m)
                        if ((m & 3) == c) a.u[(size_t)r * DT + m] = u[hf][m];
            }
            // g_{L-1} = (u W_L^T)(1 - h^2) into buf_{L-1}
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt) {
                const int k = 8 * nt + 2 * c;
                float w[2][DT];
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int m = 0; m < DT; m += 4) {
                        const float4 x = *reinterpret_cast<const float4*>(sW2 + (k + e) * DT + m);
                        w[e][m] = x.x; w[e][m + 1] = x.y; w[e][m + 2] = x.z; w[e][m + 3] = x.w;
                    }
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int r = s0 + g + 8 * hf;
                    if (r >= a.B) continue;
                    const float2 hv = pair<HEVEN>(H, r, wid(l), wid(l), k);
                    float s[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        s[e] = u[hf][0] * w[e][0];
#pragma unroll
                        for (int m = 1; m < DT; ++m) s[e] = fmaf(u[hf][m], w[e][m], s[e]);
                    }
                    *reinterpret_cast<float2*>(a.buf[l] + (size_t)r * N + k) =
                        make_float2(s[0] * (1.f - hv.x * hv.x),
                                    s[1] * (1.f - hv.y * hv.y));
                }
            }
        }
    }
}

// rev<l>: g_{l-1} = (g_l W_l^T)(1 - h_{l-1}^2), W_l^T's planes in shared
// memory, l = L-1 .. 1
template <int l>
struct Rev {
    static constexpr int K = pad(l), N = pad(l - 1);
    static constexpr int BYTES = frag(K, N) * 2;
    static constexpr int MINB = N <= 64 && 2 * BYTES <= 232448 ? 2 : 1;
    static_assert(BYTES <= 232448, "one block's shared memory");
};

template <int l>
__global__ void __launch_bounds__(NT, (Rev<l>::MINB)) rev_kernel(Args a) {
    using R = Rev<l>;
    constexpr int K = R::K, N = R::N, KS = K / 16, NTN = N / 8, NP = N / 16;
    extern __shared__ __align__(16) char smem[];
    const bf16* sWT = reinterpret_cast<const bf16*>(smem);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    copy16(smem, a.Wp + wt_off(l), R::BYTES, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();

    constexpr int WI = wid(l - 1);
    const float* H = a.H[l - 1];
    const int n_chunks = (a.B + 15) / 16;
    for (int ch = blockIdx.x * NW + warp; ch < n_chunks; ch += gridDim.x * NW) {
        const int s0 = 16 * ch;
        float hi[NTN][4], ml[NTN][4];
        zero(hi);
        zero(ml);
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
            uint32_t ap[PL][4];
            a_planes<true>(ap, a.buf[l], K, K, s0, a.B, kk, g, c);
            products<NP, NP>(hi, ml, ap, sWT, kk, 0, lane);
        }
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt) {
            const int k = 8 * nt + 2 * c;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int r = s0 + g + 8 * hf;
                if (r >= a.B) continue;
                const float2 hv = pair<WI % 2 == 0>(H, r, WI, WI, k);
                *reinterpret_cast<float2*>(a.buf[l - 1] + (size_t)r * N + k) =
                    make_float2((hi[nt][2 * hf] + ml[nt][2 * hf]) * (1.f - hv.x * hv.x),
                                (hi[nt][2 * hf + 1] + ml[nt][2 * hf + 1]) *
                                    (1.f - hv.y * hv.y));
            }
        }
    }
}

// The grad launch's work: layer j's [a_j; 1]^T g_j (j = L: the head, g_L =
// u) in tiles of GT x GT, MT(j) row tiles (the features and the ones row;
// do + 1 <= 33 rows at j = 0) by NTL(j) column tiles
__host__ __device__ constexpr int g_mt(int j) {
    return j == 0 ? 1 : (wid(j - 1) + 1 + GT - 1) / GT;
}
__host__ __device__ constexpr int g_nt(int j) {
    return j == NL ? 1 : (pad(j) + GT - 1) / GT;
}
__host__ __device__ constexpr int g_items() {
    int n = 0;
    for (int j = 0; j <= NL; ++j) n += g_mt(j) * g_nt(j);
    return n;
}

// N (4 or 8) bytes global -> shared, the bytes past src_bytes zero
// (mma_bf16.cuh's cp_async16 for 16)
template <int N>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src,
                                            int src_bytes) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(N), "r"(src_bytes));
}

// the samples [s, s + KC) (those past b1 zero) of columns c0 .. c0 + GT - 1
// of a row-major fp32 array of row stride and width w (zero past it) into
// dst [KC][GT] by cp.async of V-byte vectors (w 4 / V-aligned rows). A
// thread keeps one column vector over rows r0, r0 + RPP, ..., walking one
// pointer down them, so that few addresses stay live across the chunks.
template <int V>
__device__ __forceinline__ void stage_rows(float (*dst)[GT], const float* M,
                                          int w, int c0, int s, int b1,
                                          int tid) {
    constexpr int E = V / 4, VPR = GT / E, RPP = NT / VPR, PER = KC / RPP;
    const int cl = E * (tid % VPR), r0 = tid / VPR;
    const int cb = min(V, max(0, 4 * (w - c0 - cl)));   // bytes in the width
    const int lim = b1 - s - r0;                        // rows RPP q < lim
    const float* p = M + (size_t)(s + r0) * w + c0 + cl;
    const size_t step = (size_t)RPP * w;
#pragma unroll
    for (int q = 0; q < PER; ++q, p += step) {
        const int nb = RPP * q < lim ? cb : 0;
        float* d = &dst[r0 + RPP * q][cl];
        if constexpr (V == 16) cp_async16(d, nb > 0 ? p : M, nb);
        else cp_async_ca<V>(d, nb > 0 ? p : M, nb);
    }
}

// A grad block's work: layer j's operands a_j (A, width in) and g_j (G,
// row stride gs, out columns), its tile's first row and column, and the
// flat offsets of gW_j and gb_j
struct Item {
    const float* A;
    const float* G;
    int in, gs, out, m0, n0, wo, bo;
};

template <int DT>
__device__ __forceinline__ Item item_of(const Args& a) {
    int item = blockIdx.x % g_items();
    Item it = {a.X, a.buf[0], a.DO, pad(0), wid(0), 0, 0, a.fW[0], a.fb[0]};
    bool found = false;
#pragma unroll
    for (int jj = 0; jj <= NL; ++jj) {
        const int n = g_mt(jj) * g_nt(jj);
        if (!found && item < n) {
            found = true;
            if (jj > 0) {
                it.A = a.H[jj > 0 ? jj - 1 : 0];
                it.in = wid(jj - 1);
            }
            if (jj < NL) {
                it.G = a.buf[jj < NL ? jj : 0];
                it.gs = pad(jj);
                it.out = wid(jj);
            } else {
                it.G = a.u;
                it.gs = DT;
                it.out = a.DA;
            }
            it.wo = a.fW[jj];
            it.bo = a.fb[jj];
            const int mtn = g_mt(jj);
            it.m0 = GT * (item % mtn);
            it.n0 = GT * (item / mtn);
        } else if (!found) {
            item -= n;
        }
    }
    return it;
}

// grad: block (item, split) sums its tile over samples [split span,
// (split + 1) span) into the split's partial. Warp (wm, wn) owns rows
// 16 wm.., columns 32 wn.. of the tile (a warp wholly in the tile's
// padding skips its products). The operands come by cp.async into a ring
// of GST fp32 stages, GST - 1 chunks ahead, 16 bytes at a time where the
// rows allow (VA bytes for a's, one loop a width so that only its
// addresses stay live); each chunk of KC samples is split into planes once
// and summed on the tensor cores into fresh accumulators (a chain of many
// k-steps in one would lose low bits), added to the totals in fp32.
template <int DT, int VA>
__device__ __forceinline__ void grad_tile(const Args& a, float* partial,
                                          int span, char* smem) {
    bf16 (*sA)[KC][GS] = reinterpret_cast<bf16 (*)[KC][GS]>(smem);
    bf16 (*sB)[KC][GS] = reinterpret_cast<bf16 (*)[KC][GS]>(smem + G_PLANES / 2);
    float (*fA)[KC][GT] = reinterpret_cast<float (*)[KC][GT]>(smem + G_PLANES);
    float (*fB)[KC][GT] =
        reinterpret_cast<float (*)[KC][GT]>(smem + G_PLANES + GST * KC * GT * 4);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp & 3, wn = warp >> 2;
    const Item it = item_of<DT>(a);
    const int in = it.in, m0 = it.m0;
    const int b0 = blockIdx.x / g_items() * span, b1 = min(a.B, b0 + span);
    const int n_ch = b1 > b0 ? (b1 - b0 + KC - 1) / KC : 0;
    const bool busy = m0 + 16 * wm <= in && it.n0 + 32 * wn < it.out;

    // chunk i's operands into stage i % GST (zero past the sample range and
    // the widths; the ones row is set as it is split)
    auto issue = [&](int i) {
        if (i < n_ch) {
            const int st = i % GST, s = b0 + KC * i;
            stage_rows<16>(fB[st], it.G, it.gs, it.n0, s, b1, tid);
            stage_rows<VA>(fA[st], it.A, in, m0, s, b1, tid);
        }
        cp_async_commit();
    };
    float tot[4][4];
    zero(tot);
#pragma unroll
    for (int i = 0; i < GST - 1; ++i) issue(i);
    for (int i = 0; i < n_ch; ++i) {
        cp_async_wait<GST - 2>();   // chunk i's stage landed
        __syncthreads();            // for every thread; the planes free
        const int st = i % GST, s = b0 + KC * i;
#pragma unroll 2   // fully unrolled, its temporaries would spill
        for (int q = 0; q < KC * GT / 2 / NT; ++q) {
            const int p = tid + NT * q, sr = p / (GT / 2), cp = 2 * (p % (GT / 2));
            float2 x = *reinterpret_cast<const float2*>(&fA[st][sr][cp]);
            if (s + sr < b1) {
                if (m0 + cp == in) x.x = 1.f;
                if (m0 + cp + 1 == in) x.y = 1.f;
            }
            const float2 y = *reinterpret_cast<const float2*>(&fB[st][sr][cp]);
            uint32_t pa[PL], pb[PL];
            split_pair(x.x, x.y, pa[0], pa[1], pa[2]);
            split_pair(y.x, y.y, pb[0], pb[1], pb[2]);
#pragma unroll
            for (int pl = 0; pl < PL; ++pl) {
                *reinterpret_cast<uint32_t*>(&sA[pl][sr][cp]) = pa[pl];
                *reinterpret_cast<uint32_t*>(&sB[pl][sr][cp]) = pb[pl];
            }
        }
        __syncthreads();            // the planes in place; stage st free
        issue(i + GST - 1);
        if (!busy) continue;
#pragma unroll
        for (int qq = 0; qq < 2; ++qq) {     // n-pair by n-pair
            float hi[2][4], ml[2][4];
            zero(hi);
            zero(ml);
#pragma unroll
            for (int ks = 0; ks < KC / 16; ++ks) {
                uint32_t ap[PL][4], r[1][PL][4];
#pragma unroll
                for (int pl = 0; pl < PL; ++pl) {
                    ldmatrix_x4_trans(ap[pl], &sA[pl][16 * ks + (lane & 7) + 8 * (lane >> 4)]
                                                 [16 * wm + 8 * ((lane >> 3) & 1)]);
                    ldmatrix_x4_trans(r[0][pl], &sB[pl][16 * ks + (lane & 15)]
                                                   [32 * wn + 16 * qq + ((lane >> 4) << 3)]);
                }
                plane_mma<2, true>(hi, ml, ap, r);
            }
#pragma unroll
            for (int t = 0; t < 2; ++t)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                    tot[2 * qq + t][q] += hi[t][q] + ml[t][q];
        }
    }
    cp_async_wait<0>();
    // the tile into the split's partial: row k < in of gW_j, the ones row
    // k = in of gb_j (the item found again here, not kept live above)
    const Item o = item_of<DT>(a);
    float* part = partial + (size_t)(blockIdx.x / g_items()) * a.ls;
    const int g = lane >> 2, c = lane & 3;
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int k = o.m0 + 16 * wm + g + 8 * hf;
                const int n = o.n0 + 32 * wn + 8 * t + 2 * c + e;
                if (n >= o.out || k > o.in) continue;
                part[k < o.in ? o.wo + k * o.out + n : o.bo + n] =
                    tot[t][2 * hf + e];
            }
}

template <int DT>
__global__ void __launch_bounds__(NT, 2) grad_kernel(Args a, float* partial,
                                                     int span) {
    extern __shared__ __align__(16) char smem[];
    const int in = item_of<DT>(a).in;   // a's rows: 16-, 8- or 4-byte vectors
    if (in % 4 == 0) grad_tile<DT, 16>(a, partial, span, smem);
    else if (in % 2 == 0) grad_tile<DT, 8>(a, partial, span, smem);
    else grad_tile<DT, 4>(a, partial, span, smem);
}

// Fragment-order splits of up to four row-major fp32 matrices (R, C) into
// (K, N) B operands: B (k, n) = W (k, n), or W (n, k) where trans
struct FragJob {
    const float* w;
    bf16* out;
    int R, C, K, N, trans;
};
struct FragJobs {
    FragJob job[4];
    int n;
};

template <int U>   // U: unused; instantiated by the wide form only
__global__ void frag_split_kernel(FragJobs js) {
#pragma unroll
    for (int jb = 0; jb < 4; ++jb) {
        if (jb >= js.n) break;
        const FragJob j = js.job[jb];
        for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < j.K * j.N;
             i += gridDim.x * blockDim.x) {
            const int k = i / j.N, n = i % j.N;
            const int r = j.trans ? n : k, cc = j.trans ? k : n;
            bf16 p[PL];
            split3(r < j.R && cc < j.C ? j.w[r * j.C + cc] : 0.f, p);
#pragma unroll
            for (int pl = 0; pl < PL; ++pl) j.out[frag_index(j.N, pl, k, n)] = p[pl];
        }
    }
}

template <int U = 0>   // a template, so that only the wide form builds it
cudaError_t frag_split(const FragJobs& js, cudaStream_t st) {
    if (js.n == 0) return cudaSuccess;
    frag_split_kernel<U><<<132, 256, 0, st>>>(js);
    return cudaGetLastError();
}

// The wide form's tag: (do, da) instantiation XT, DT; TS, the grid's unit
// of work (trpo_fvp_tile), is a split of the grad launch
template <int XT_, int DT_>
struct Pick {
    static constexpr int XT = XT_, DT = DT_;
    static constexpr int TS = SPLIT;
    static constexpr int NT = wide::NT;
};

// One per-sample launch over B samples (16 a warp) with `smem` bytes of
// dynamic shared memory: as many blocks as are resident on the card
// (counted once per kernel), or fewer where B needs fewer
template <void (*K)(Args)>
cudaError_t per_sample(int smem, const Args& a, cudaStream_t st) {
    static int resident = 0;
    cudaError_t err = cudaFuncSetAttribute(
        K, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (resident == 0) {
        int dev = 0, sms = 0, blocks = 0;
        if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
            (err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess ||
            (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &blocks, K, NT, smem)) != cudaSuccess)
            return err;
        if (blocks < 1) return cudaErrorInvalidConfiguration;
        resident = sms * blocks;
    }
    const int need = (a.B + 16 * NW - 1) / (16 * NW);
    void* args[] = {const_cast<Args*>(&a)};
    err = cudaLaunchKernel(reinterpret_cast<const void*>(K),
                           dim3(need < resident ? need : resident), dim3(NT),
                           args, smem, st);
    return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace wide

// w -> planes[q n + i], q = 0, 1, 2
__global__ void split_kernel(const float* __restrict__ w,
                             bf16* __restrict__ planes, int n) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
         i += gridDim.x * blockDim.x) {
        bf16 p[PL];
        split3(w[i], p);
#pragma unroll
        for (int q = 0; q < PL; ++q) planes[q * n + i] = p[q];
    }
}

cudaError_t split(const float* w, bf16* planes, int n, cudaStream_t st) {
    const int blocks = (n + 255) / 256;
    split_kernel<<<blocks < 64 ? blocks : 64, 256, 0, st>>>(w, planes, n);
    return cudaGetLastError();
}

// w (rin, cin) row-major -> its planes zero-padded to (R, C):
// planes[q plane + r C + k], q = 0, 1, 2
__global__ void split_pad_kernel(const float* __restrict__ w,
                                 bf16* __restrict__ planes, int plane,
                                 int rin, int cin, int R, int C) {
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < R * C;
         i += gridDim.x * blockDim.x) {
        const int r = i / C, k = i % C;
        bf16 p[PL];
        split3(r < rin && k < cin ? w[r * cin + k] : 0.f, p);
#pragma unroll
        for (int q = 0; q < PL; ++q) planes[q * plane + i] = p[q];
    }
}

cudaError_t split_pad(const float* w, bf16* planes, int plane, int rin,
                      int cin, int R, int C, cudaStream_t st) {
    if (rin == R && cin == C && plane == R * C)
        return split(w, planes, R * C, st);
    const int blocks = (R * C + 255) / 256;
    split_pad_kernel<<<blocks < 64 ? blocks : 64, 256, 0, st>>>(
        w, planes, plane, rin, cin, R, C);
    return cudaGetLastError();
}

// The weights' planes of this library's form, once per update: the
// tensor-core form's W_1 .. W_{L-1} row by row, the wide form's in
// fragment order, as B of the forward and of the reverse
template <int XT, int DT>
cudaError_t split_weights(Pick<XT, DT>, const Weights& w, bf16* p,
                          cudaStream_t st) {
    for (int l = 1; l < NL; ++l) {
        const cudaError_t err = split_pad(
            w.W[l], p + gw_off(l), pad(l - 1) * pad(l), wid(l - 1), wid(l),
            pad(l - 1), pad(l), st);
        if (err != cudaSuccess) return err;
    }
    return cudaSuccess;
}

template <int XT, int DT>
cudaError_t split_weights(wide::Pick<XT, DT>, const Weights& w, bf16* p,
                          cudaStream_t st) {
    wide::FragJobs js = {};
    for (int l = 1; l < NL; ++l) {
        js.job[js.n++] = wide::FragJob{w.W[l], p + wide::wf_off(l), wid(l - 1),
                                       wid(l), pad(l - 1), pad(l), 0};
        js.job[js.n++] = wide::FragJob{w.W[l], p + wide::wt_off(l), wid(l - 1),
                                       wid(l), pad(l), pad(l - 1), 1};
    }
    return wide::frag_split(js, st);
}

// floats of the launch's `partial` scratch
template <int XT, int DT>
size_t partial_floats(Pick<XT, DT>, int, int n_blocks, int Pg) {
    return (size_t)n_blocks * Pg;
}
template <int XT, int DT>
size_t partial_floats(wide::Pick<XT, DT>, int B, int n_blocks, int Pg) {
    return wide::scratch_off(n_blocks, Pg) + wide::scratch_floats(B, DT);
}

// What the card makes of a kernel: out[0] resident blocks per SM, out[1]
// registers per thread, out[2] local (spill) bytes per thread, out[3]
// dynamic and out[4] static shared bytes per block, out[5] threads per
// block, out[6] samples a unit of its work
template <typename Kern>
cudaError_t occupancy_of(Kern k, int smem, int threads, int ts, int* out) {
    cudaError_t err = cudaFuncSetAttribute(
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, k);
    if (err != cudaSuccess) return err;
    out[0] = blocks;
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = smem;
    out[4] = (int)fa.sharedSizeBytes;
    out[5] = threads;
    out[6] = ts;
    return cudaSuccess;
}

// kernel k of the form: out[0 .. 6] as above, out[7] how many kernels
// the form launches, out[8] which (0 the tensor-core form's, 1 fwd, 2 rev,
// 3 grad), out[9] its layer, out[10] 1 where it takes layer 0 in (fwd<1>)
// plus 2 where it holds the head; in the wide form's launch order
template <int XT, int DT>
cudaError_t occupancy(Pick<XT, DT>, int k, int* out) {
    using PK = Pick<XT, DT>;
    out[7] = 1;
    out[8] = out[9] = out[10] = 0;
    if (k != 0) return cudaErrorInvalidValue;
    return occupancy_of(fvp_tc_kernel<XT, DT>, PK::L::BYTES, PK::NT, PK::TS,
                        out);
}

template <int XT, int DT>
cudaError_t occupancy(wide::Pick<XT, DT>, int k, int* out) {
    using namespace wide;
    constexpr int NL_ = NL + 0 * XT;
    constexpr bool F0 = Fwd<1, XT, DT>::FUSE0;
    constexpr int ROUND = 16 * wide::NW;     // samples a round of a block
    out[7] = (F0 ? 0 : 1) + 2 * (NL_ - 1) + 1;
    auto fwd = [&](auto kern, int l, int bytes, bool last) {
        out[8] = 1;
        out[9] = l;
        out[10] = (l == 1 && F0 ? 1 : 0) + (last ? 2 : 0);
        return occupancy_of(kern, bytes, wide::NT, ROUND, out);
    };
    auto rev = [&](auto kern, int l, int bytes) {
        out[8] = 2;
        out[9] = l;
        out[10] = 0;
        return occupancy_of(kern, bytes, wide::NT, ROUND, out);
    };
    int i = k;
    if (!F0 && i-- == 0)
        return fwd(fwd_kernel<0, XT, DT>, 0, Fwd<0, XT, DT>::BYTES, NL_ == 1);
    if constexpr (NL_ > 1)
        if (i-- == 0)
            return fwd(fwd_kernel<1, XT, DT>, 1, Fwd<1, XT, DT>::BYTES, NL_ == 2);
    if constexpr (NL_ > 2) {
        if (i-- == 0)
            return fwd(fwd_kernel<2, XT, DT>, 2, Fwd<2, XT, DT>::BYTES, true);
        if (i-- == 0) return rev(rev_kernel<2>, 2, Rev<2>::BYTES);
    }
    if constexpr (NL_ > 1)
        if (i-- == 0) return rev(rev_kernel<1>, 1, Rev<1>::BYTES);
    if (i == 0) {
        out[8] = 3;
        out[9] = NL_;
        out[10] = 0;
        return occupancy_of(grad_kernel<DT>, G_SMEM, wide::NT, KC, out);
    }
    return cudaErrorInvalidValue;
}

template <int XT, int DT>
cudaError_t launch(Pick<XT, DT>, const float* X, const float* const (&hs)[3],
                   const bf16* Wp, const bf16* Vp, const Weights& w,
                   const float* scale, const float* v, float* partial, int B,
                   int DO, int DA, int n_blocks, cudaStream_t st) {
    using PK = Pick<XT, DT>;
    constexpr int smem = PK::L::BYTES;
    const float* WL = w.W[NL];
    cudaError_t err = cudaFuncSetAttribute(
        fvp_tc_kernel<XT, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    fvp_tc_kernel<XT, DT><<<n_blocks, PK::NT, smem, st>>>(
        X, hs[0], hs[1], hs[2], Wp, Vp, WL, scale, v, partial, B, DO, DA);
    return cudaGetLastError();
}

// the wide form: v's blocks into fragment order, the per-sample launches
// through the scratch after the partials, then grad over n_blocks splits
template <int XT, int DT>
cudaError_t launch(wide::Pick<XT, DT>, const float* X,
                   const float* const (&hs)[3], const bf16* Wp, bf16* Vp,
                   const Weights& w, const float* scale, const float* v,
                   float* partial, int B, int DO, int DA, int n_blocks,
                   cudaStream_t st) {
    using namespace wide;
    constexpr int NL_ = NL + 0 * XT;
    const Flat f = policy_shape::flat(DO, DA);
    FragJobs js = {};
    js.job[js.n++] = FragJob{v + f.W[0], Vp + vf_off(0, XT), DO, wid(0),
                             16 * XT, pad(0), 0};
    for (int l = 1; l < NL_; ++l)
        js.job[js.n++] = FragJob{v + f.W[l], Vp + vf_off(l, XT), wid(l - 1),
                                 wid(l), pad(l - 1), pad(l), 0};
    cudaError_t err = frag_split(js, st);
    if (err != cudaSuccess) return err;
    Args a = {};
    a.X = X;
    a.Wp = Wp;
    a.Vp = Vp;
    a.WL = w.W[NL_];
    a.scale = scale;
    a.v = v;
    a.B = B;
    a.DO = DO;
    a.DA = DA;
    for (int l = 0; l <= NL_; ++l) {
        a.fW[l] = f.W[l];
        a.fb[l] = f.b[l];
    }
    a.ls = f.ls;
    float* s = partial + scratch_off(n_blocks, f.ls);
    for (int l = 0; l < NL_; ++l) {
        a.H[l] = hs[l];
        a.buf[l] = s;
        s += (size_t)B * pad(l);
    }
    a.u = s;
    if constexpr (!Fwd<1, XT, DT>::FUSE0)
        err = per_sample<fwd_kernel<0, XT, DT>>(Fwd<0, XT, DT>::BYTES, a, st);
    if constexpr (NL_ > 1)
        if (err == cudaSuccess)
            err = per_sample<fwd_kernel<1, XT, DT>>(Fwd<1, XT, DT>::BYTES, a,
                                                    st);
    if constexpr (NL_ > 2) {
        if (err == cudaSuccess)
            err = per_sample<fwd_kernel<2, XT, DT>>(Fwd<2, XT, DT>::BYTES, a,
                                                    st);
        if (err == cudaSuccess)
            err = per_sample<rev_kernel<2>>(Rev<2>::BYTES, a, st);
    }
    if constexpr (NL_ > 1)
        if (err == cudaSuccess)
            err = per_sample<rev_kernel<1>>(Rev<1>::BYTES, a, st);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(grad_kernel<DT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               G_SMEM);
    if (err != cudaSuccess) return err;
    const int span = ((B + n_blocks - 1) / n_blocks + KC - 1) / KC * KC;
    grad_kernel<DT><<<g_items() * n_blocks, wide::NT, G_SMEM, st>>>(
        a, partial, span);
    return cudaGetLastError();
}

// The form of this library's policy: the tensor-core one, or the wide
// one where a layer is over 64 units (only the one named is instantiated)
template <int XT, int DT>
using Form = std::conditional_t<policy_shape::WIDE, wide::Pick<XT, DT>,
                                Pick<XT, DT>>;

// The instantiation for (do, da): XT k-steps of x, DT head outputs
template <typename Op>
cudaError_t dispatch(int DO, int DA, Op op) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX)
        return cudaErrorInvalidValue;
    if (DO <= 16)
        return DA <= 4 ? op(Form<1, 4>{}) : op(Form<1, 8>{});
    return DA <= 4 ? op(Form<2, 4>{}) : op(Form<2, 8>{});
}

}  // namespace

// The weights' planes, once per update; every CG call's launch reads
// them. hidden (n_hidden ints, host): the policy's hidden widths, which
// must be this library's (policy_shape.cuh), else cudaErrorInvalidValue;
// weights (host array of device pointers): W0, b0, ..., W_L, b_L, logstd.
// planes: the tensor-core form's 3 sum_{l=1}^{L-1} pad(w_{l-1}) pad(w_l)
// bf16, each W_l's three planes (pad(w_{l-1}), pad(w_l)) after the last,
// zero past its widths (pad: up to a multiple of 16); the wide form's
// twice that, the same planes in fragment order as B of the forward, then
// W_l^T's as B of the reverse.
extern "C" int trpo_fvp_split_launch(const int* hidden, int n_hidden,
                                     const float* const* weights,
                                     void* planes, void* stream) {
    if (!policy_shape::same_shape(hidden, n_hidden))
        return (int)cudaErrorInvalidValue;
    return (int)split_weights(Form<1, 4>{},
                              policy_shape::weights_of(weights),
                              static_cast<bf16*>(planes),
                              static_cast<cudaStream_t>(stream));
}

// X (B, do), hs: a host array of the device pointers h_0 .. h_{L-1}
// (B, w_l), Wp: the planes from trpo_fvp_split_launch, weights as there
// (the kernel reads the head W_L (w_{L-1}, da)), scale (da) =
// exp(-2 logstd) / B, v and out (P) in flat sorted-key order, all on the
// device; vplanes: 3 (pad16(do) pad(w_0) + sum_{l>=1} pad(w_{l-1})
// pad(w_l)) bf16 (do pad(w_0) in the tensor-core form) and partial:
// trpo_fvp_partial_floats floats of scratch. Launches the split of v's W0
// .. W_{L-1} blocks, the kernel (the wide form: its chain of launches) and
// the reduce pass over n_blocks partials.
extern "C" int trpo_fvp_launch(const int* hidden, int n_hidden,
                               const float* const* weights, const float* X,
                               const float* const* hs, const void* Wp,
                               const float* scale, const float* v,
                               void* vplanes, float* partial, float* out,
                               int B, int DO, int DA, float damping,
                               int n_blocks, void* stream) {
    if (B < 1 || n_blocks < 1 || DO < 1 || DO > DO_MAX || DA < 1 ||
        DA > DA_MAX || !policy_shape::same_shape(hidden, n_hidden))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const policy_shape::Weights w = policy_shape::weights_of(weights);
    const float* a[3] = {};
    for (int l = 0; l < NL; ++l) a[l] = hs[l];
    const Flat f = policy_shape::flat(DO, DA);
    const int VP = gv_off(NL, DO);
    bf16* Vp = static_cast<bf16*>(vplanes);
    cudaError_t err = cudaSuccess;
    if (policy_shape::WIDE) {
        // the wide form splits v in fragment order as it launches
    } else if (dense()) {     // v's blocks are the planes' blocks, unpadded
        err = split(v, Vp, VP, st);
    } else {
        for (int l = 0; l < NL && err == cudaSuccess; ++l)
            err = split_pad(v + f.W[l], Vp + gv_off(l, DO), VP,
                            policy_shape::in_width(l, DO), wid(l),
                            l == 0 ? DO : pad(l - 1), pad(l), st);
    }
    if (err != cudaSuccess) return (int)err;
    const bf16* wp = static_cast<const bf16*>(Wp);
    err = dispatch(DO, DA, [&](auto pk) -> cudaError_t {
        return launch(pk, X, a, wp, Vp, w, scale, v, partial, B, DO, DA,
                      n_blocks, st);
    });
    if (err != cudaSuccess) return (int)err;
    return (int)fvp_tile::reduce(partial, v, out, n_blocks, f.ls, f.P,
                                 damping, st);
}

// Samples a unit of the grid's work for (do, da) (n_blocks = min(ceil(B /
// tile), 132)): a tile of the tensor-core form, a split of the wide
// form's grad launch; -1 for a (do, da) it does not take.
extern "C" int trpo_fvp_tile(int DO, int DA) {
    int ts = -1;
    dispatch(DO, DA, [&](auto pk) -> cudaError_t {
        ts = decltype(pk)::TS;
        return cudaSuccess;
    });
    return ts;
}

// Floats of trpo_fvp_launch's `partial` scratch for B samples over
// n_blocks: the per-block partials and, in the wide form, the per-sample
// buffers after them; -1 for arguments it does not take.
extern "C" int trpo_fvp_partial_floats(int B, int DO, int DA, int n_blocks) {
    if (B < 1 || n_blocks < 1) return -1;
    const int Pg = policy_shape::flat(DO, DA).ls;
    size_t n = 0;
    if (dispatch(DO, DA, [&](auto pk) -> cudaError_t {
            n = partial_floats(pk, B, n_blocks, Pg);
            return cudaSuccess;
        }) != cudaSuccess || n > 0x7fffffff)
        return -1;
    return (int)n;
}

// What the card makes of kernel k of the instantiation for (do, da)
// (occupancy above): out[0 .. 10].
extern "C" int trpo_fvp_occupancy(int DO, int DA, int k, int* out) {
    return (int)dispatch(DO, DA, [&](auto pk) -> cudaError_t {
        return occupancy(pk, k, out);
    });
}
