// Gauss-Newton Fisher-vector product for the tanh policy on batch-major
// samples, on the tensor cores.
//
// Replaces `make_pallas_gn_fvp` / `_fvp_kernel` (and its pair-packed twin
// `_fvp_kernel_packed`) in trpo_robot_control_tpu/ops/pallas/fvp_kernel.py.
// The policy has 1-3 hidden layers of 1-128 units (policy_shape.cuh; the
// JAX package's (64, 64) without -DTRPO_H<l>); a layer over 64 units
// selects the wide form at the end of this file, on the CUDA cores, as
// the TPU kernel's widths select its unpacked `_fvp_kernel`. The tensor-
// core form below takes widths up to 64. One pass over the (B, do)
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
// unpacked `_fvp_kernel`, which JAX runs past its packed width) the
// tensor-core layout above does not fit one block: W_l's and dW_l's
// three bf16 planes alone come to 253 KB at (100, 50, 25) and 418 KB at
// (128, 128, 128). This form is fp32 on the CUDA cores, one pass over the
// samples per CG call, the same function as the plain version:
// - a block walks its tiles of TS samples (64, or 32 or 16 where the
//   layout below would outgrow one block's 227 KB: 16 at (128, 128, 128));
//   it stages x and h_0 .. h_{L-1} of a tile in shared memory (read once
//   from device memory), then runs the forward tangent layer by layer,
//   the head and u, and the reverse layer by layer through two work
//   buffers, one __syncthreads between layers;
// - each layer's products are small matrix products over the tile
//   (`gemm`): a thread takes RI x RJ outputs strided over the output
//   (output i = ig + GI ii), each one thread's fmaf chain over its inputs
//   in order; the weights and v's blocks are read from L2 (__ldg, rows
//   read across lanes), the tile's activations from shared memory (rows
//   at odd strides, so the lanes' rows fall in distinct banks);
// - the weight gradient (every gW_l and bias sum, in flat order) is
//   summed in shared memory, each entry owned by one thread that adds its
//   tile's chain over the samples in order; the block writes it as its
//   partial, and fvp_tile.cuh's reduce pass sums the partials in a fixed
//   order. No float atomics, so repeat calls are bit-identical.
// What bounds it: at c3-rllab ((100, 50, 25), 102,400 samples, do 24)
// the function is 30.5k MACs a sample, 6.25 GFLOP a call: 0.093 ms at
// the fp32-FMA peak; with its products on the tensor cores the 81.5 MB of
// inputs would bound it (0.024 ms). Here its operand loads per FMA (four
// of each operand per 16 fmaf) and one block per SM set its time
// (PERF.md). A tensor-core form at these widths is ROADMAP B4's.
namespace wide {

constexpr int NT = 512;        // threads a block: one block an SM
constexpr int RI = 4, RJ = 4;  // a thread's outputs per item

// row stride of a staged row of w floats: odd, so that the rows the
// lanes of a warp read at one column fall in distinct banks
__host__ __device__ constexpr int odd(int w) { return w | 1; }
__host__ __device__ constexpr int maxi(int a, int b) { return a > b ? a : b; }

// row stride of a staged h_l
__host__ __device__ constexpr int hs(int l) { return odd(wid(l)); }
// offset of the staged h_l after x (TS, XS)
__host__ __device__ constexpr int h_off(int TS, int XS, int l) {
    int o = TS * XS;
    for (int m = 0; m < l; ++m) o += TS * hs(m);
    return o;
}
// the gradient's entries but logstd at do = DOM, da = DT
__host__ __device__ constexpr int pg(int DOM, int DT) {
    int n = DOM * wid(0) + wid(NL - 1) * DT + DT;
    for (int l = 0; l < NL; ++l) n += wid(l);
    for (int l = 1; l < NL; ++l) n += wid(l - 1) * wid(l);
    return n;
}

// shared memory in floats for do <= 16 XT, da <= DT and TS samples a
// tile: x (TS, XS), h_l (TS, hs(l)) each, two work buffers (TS, WS), the
// block's gradient (flat order, the most a (do, da) takes)
template <int XT, int DT, int TS>
struct Layout {
    static constexpr int T = TS;
    static constexpr int XS = odd(16 * XT);
    static constexpr int WS = odd(maxi(Hidden::widest(), DT));
    __host__ __device__ static int h(int l) { return h_off(TS, XS, l); }
    static constexpr int WA = h_off(TS, XS, NL);
    static constexpr int WB = WA + TS * WS;
    static constexpr int ACC = WB + TS * WS;
    static constexpr int BYTES = (ACC + pg(16 * XT, DT)) * 4;
    static constexpr bool FITS = BYTES <= 232448;
};

// the tile: the most samples (64, 32, 16) whose layout fits one block
template <int XT_, int DT_>
struct Pick {
    static constexpr int XT = XT_, DT = DT_;
    static constexpr int TS = Layout<XT, DT, 64>::FITS   ? 64
                              : Layout<XT, DT, 32>::FITS ? 32
                                                         : 16;
    using L = Layout<XT, DT, TS>;
    static constexpr int NT = wide::NT;
    static_assert(L::FITS, "one block's shared memory");
};

// operands: (row, column) -> a[row sr + column sc], from shared memory
// (S) or read-only from global memory (G); B1 also 1 past its rows
// (the bias's row of a weight gradient)
struct S {
    const float* p;
    int sr, sc;
    __device__ __forceinline__ float operator()(int r, int c) const {
        return p[r * sr + c * sc];
    }
};
struct G {
    const float* __restrict__ p;
    int sr, sc;
    __device__ __forceinline__ float operator()(int r, int c) const {
        return __ldg(p + r * sr + c * sc);
    }
};
struct SOne {           // rows < n from shared memory, row n all ones
    const float* p;
    int sr, sc, n;
    __device__ __forceinline__ float operator()(int r, int c) const {
        return r < n ? p[r * sr + c * sc] : 1.f;
    }
};

// out(i, j) = sum_{r < K1} a1(i, r) b1(r, j) + sum_{r < K2} a2(i, r)
// b2(r, j) over i < M, j < N, one fmaf chain an output in r order, first
// term then second; epi(i, j, sum) takes each
template <typename A1, typename B1, typename A2, typename B2, typename Epi>
__device__ __forceinline__ void gemm(int M, int N, int K1, A1 a1, B1 b1,
                                     int K2, A2 a2, B2 b2, Epi epi) {
    const int GI = (M + RI - 1) / RI, GJ = (N + RJ - 1) / RJ;
    for (int it = threadIdx.x; it < GI * GJ; it += NT) {
        const int ig = it / GJ, jg = it % GJ;
        int ri[RI], cj[RJ];
#pragma unroll
        for (int ii = 0; ii < RI; ++ii) ri[ii] = min(ig + GI * ii, M - 1);
#pragma unroll
        for (int jj = 0; jj < RJ; ++jj) cj[jj] = min(jg + GJ * jj, N - 1);
        float acc[RI][RJ];
#pragma unroll
        for (int ii = 0; ii < RI; ++ii)
#pragma unroll
            for (int jj = 0; jj < RJ; ++jj) acc[ii][jj] = 0.f;
#pragma unroll 4
        for (int r = 0; r < K1; ++r) {
            float x[RI], y[RJ];
#pragma unroll
            for (int ii = 0; ii < RI; ++ii) x[ii] = a1(ri[ii], r);
#pragma unroll
            for (int jj = 0; jj < RJ; ++jj) y[jj] = b1(r, cj[jj]);
#pragma unroll
            for (int ii = 0; ii < RI; ++ii)
#pragma unroll
                for (int jj = 0; jj < RJ; ++jj)
                    acc[ii][jj] = fmaf(x[ii], y[jj], acc[ii][jj]);
        }
#pragma unroll 4
        for (int r = 0; r < K2; ++r) {
            float x[RI], y[RJ];
#pragma unroll
            for (int ii = 0; ii < RI; ++ii) x[ii] = a2(ri[ii], r);
#pragma unroll
            for (int jj = 0; jj < RJ; ++jj) y[jj] = b2(r, cj[jj]);
#pragma unroll
            for (int ii = 0; ii < RI; ++ii)
#pragma unroll
                for (int jj = 0; jj < RJ; ++jj)
                    acc[ii][jj] = fmaf(x[ii], y[jj], acc[ii][jj]);
        }
#pragma unroll
        for (int ii = 0; ii < RI; ++ii)
#pragma unroll
            for (int jj = 0; jj < RJ; ++jj) {
                const int i = ig + GI * ii, j = jg + GJ * jj;
                if (i < M && j < N) epi(i, j, acc[ii][jj]);
            }
    }
}

// dh_l = (1 - h_l^2)(dh_{l-1} W_l + h_{l-1} dW_l + db_l) into the work
// buffer of layer l (l % 2), l = 1 .. NL-1
template <typename LT, int l>
__device__ __forceinline__ void fwd_layer(float* sm, const Weights& w,
                                          const float* v, const Flat& f) {
    constexpr int K = wid(l - 1), N = wid(l);
    const float* din = sm + ((l - 1) % 2 ? LT::WB : LT::WA);
    const float* hin = sm + LT::h(l - 1);
    const float* h = sm + LT::h(l);
    float* out = sm + (l % 2 ? LT::WB : LT::WA);
    const float* db = v + f.b[l];
    gemm(LT::T, N, K, S{din, LT::WS, 1}, G{w.W[l], N, 1}, K,
         S{hin, hs(l - 1), 1}, G{v + f.W[l], N, 1},
         [&](int s, int o, float z) {
             const float hv = h[s * hs(l) + o];
             out[s * LT::WS + o] = (1.f - hv * hv) * (z + __ldg(db + o));
         });
}

// gW_l += h_{l-1}^T g_l and db_l += sum g_l (g_l in layer l's buffer,
// out_l wide), then g_{l-1} = (g_l W_l^T)(1 - h_{l-1}^2) into layer
// l-1's; l = 1 .. NL (l = NL: the head, g_NL = u)
template <typename LT, int l>
__device__ __forceinline__ void rev_layer(float* sm, const Weights& w,
                                          const Flat& f, int DA) {
    constexpr int K = wid(l - 1);
    const int N = l == NL ? DA : wid(l);
    const float* g = sm + (l % 2 ? LT::WB : LT::WA);
    const float* hin = sm + LT::h(l - 1);
    float* acc = sm + LT::ACC;
    gemm(K + 1, N, LT::T, SOne{hin, 1, hs(l - 1), K},
         S{g, LT::WS, 1}, 0, S{nullptr, 0, 0}, S{nullptr, 0, 0},
         [&](int k, int o, float z) {
             acc[k < K ? f.W[l] + k * N + o : f.b[l] + o] += z;
         });
    float* gout = sm + ((l - 1) % 2 ? LT::WB : LT::WA);
    gemm(LT::T, K, N, S{g, LT::WS, 1}, G{w.W[l], 1, N}, 0,
         S{nullptr, 0, 0}, S{nullptr, 0, 0},
         [&](int s, int k, float z) {
             const float hv = hin[s * hs(l - 1) + k];
             gout[s * LT::WS + k] = z * (1.f - hv * hv);
         });
}

template <int XT, int DT>
__global__ void __launch_bounds__(NT, 1) fvp_wide_kernel(
    policy_shape::Weights w, const float* __restrict__ X,
    const float* __restrict__ H0, const float* __restrict__ H1,
    const float* __restrict__ H2, const float* __restrict__ scale,
    const float* __restrict__ v, float* __restrict__ partial, int B,
    int DO, int DA) {
    using PK = Pick<XT, DT>;
    using LT = typename PK::L;
    constexpr int TS = PK::TS;
    constexpr int NL_ = policy_shape::NL + 0 * XT;   // a template value
    extern __shared__ __align__(16) float sm[];
    float* sx = sm;
    float* acc = sm + LT::ACC;
    const Flat f = policy_shape::flat(DO, DA);
    const float* hg[3] = {H0, H1, H2};
    for (int i = threadIdx.x; i < f.ls; i += NT) acc[i] = 0.f;
    const int n_tiles = (B + TS - 1) / TS;
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int s0 = tile * TS, ns = min(TS, B - s0);
        __syncthreads();   // the last tile's reads done
        // x and h_0 .. h_{L-1} of the tile; rows past B zero
        for (int i = threadIdx.x; i < TS * DO; i += NT) {
            const int r = i / DO, d = i - r * DO;
            sx[r * LT::XS + d] =
                r < ns ? __ldg(X + (size_t)(s0 + r) * DO + d) : 0.f;
        }
#pragma unroll
        for (int l = 0; l < NL_; ++l) {
            const int W = wid(l);
            float* sh = sm + LT::h(l);
            for (int i = threadIdx.x; i < TS * W; i += NT) {
                const int r = i / W, k = i - r * W;
                sh[r * hs(l) + k] =
                    r < ns ? __ldg(hg[l] + (size_t)(s0 + r) * W + k) : 0.f;
            }
        }
        __syncthreads();
        {   // dh0 = (1 - h0^2)(x dW0 + db0)
            constexpr int N = wid(0);
            const float* h = sm + LT::h(0);
            float* out = sm + LT::WA;
            const float* db = v + f.b[0];
            gemm(TS, N, DO, S{sx, LT::XS, 1}, G{v + f.W[0], N, 1}, 0,
                 S{nullptr, 0, 0}, S{nullptr, 0, 0},
                 [&](int s, int o, float z) {
                     const float hv = h[s * hs(0) + o];
                     out[s * LT::WS + o] =
                         (1.f - hv * hv) * (z + __ldg(db + o));
                 });
        }
        __syncthreads();
        if constexpr (NL_ > 1) {
            fwd_layer<LT, 1>(sm, w, v, f);
            __syncthreads();
        }
        if constexpr (NL_ > 2) {
            fwd_layer<LT, 2>(sm, w, v, f);
            __syncthreads();
        }
        {   // u = (dh_{L-1} W_L + h_{L-1} dW_L + db_L) scale, 0 past B
            constexpr int K = wid(NL_ - 1);
            const float* din = sm + ((NL_ - 1) % 2 ? LT::WB : LT::WA);
            const float* hin = sm + LT::h(NL_ - 1);
            float* out = sm + (NL_ % 2 ? LT::WB : LT::WA);
            const float* db = v + f.b[NL_];
            gemm(TS, DA, K, S{din, LT::WS, 1}, G{w.W[NL_], DA, 1}, K,
                 S{hin, hs(NL_ - 1), 1}, G{v + f.W[NL_], DA, 1},
                 [&](int s, int m, float z) {
                     out[s * LT::WS + m] =
                         s < ns ? (z + __ldg(db + m)) * __ldg(scale + m)
                                : 0.f;
                 });
        }
        __syncthreads();
        rev_layer<LT, NL_>(sm, w, f, DA);
        __syncthreads();
        if constexpr (NL_ > 2) {
            rev_layer<LT, 2>(sm, w, f, DA);
            __syncthreads();
        }
        if constexpr (NL_ > 1) {
            rev_layer<LT, 1>(sm, w, f, DA);
            __syncthreads();
        }
        {   // gW0 += x^T g0, db0 += sum g0
            constexpr int N = wid(0);
            const float* g = sm + LT::WA;
            gemm(DO + 1, N, TS, SOne{sx, 1, LT::XS, DO}, S{g, LT::WS, 1}, 0,
                 S{nullptr, 0, 0}, S{nullptr, 0, 0},
                 [&](int d, int o, float z) {
                     acc[d < DO ? f.W[0] + d * N + o : f.b[0] + o] += z;
                 });
        }
    }
    __syncthreads();
    float* out = partial + (size_t)blockIdx.x * f.ls;
    for (int i = threadIdx.x; i < f.ls; i += NT) out[i] = acc[i];
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

// An instantiation's kernel: the tensor-core form's (Pick) or the wide
// form's (wide::Pick)
template <int XT, int DT>
auto kernel_of(Pick<XT, DT>) { return fvp_tc_kernel<XT, DT>; }
template <int XT, int DT>
auto kernel_of(wide::Pick<XT, DT>) { return wide::fvp_wide_kernel<XT, DT>; }

template <typename PK>
cudaError_t occupancy(PK pk, int* out) {
    constexpr int smem = PK::L::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        kernel_of(pk), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, kernel_of(pk), PK::NT, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel_of(pk));
    if (err != cudaSuccess) return err;
    out[0] = blocks;
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = smem;
    out[4] = (int)fa.sharedSizeBytes;
    out[5] = PK::NT;
    out[6] = PK::TS;
    return cudaSuccess;
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

// the wide form: the fp32 weights and v as they are (no planes)
template <int XT, int DT>
cudaError_t launch(wide::Pick<XT, DT>, const float* X,
                   const float* const (&hs)[3], const bf16*, const bf16*,
                   const Weights& w, const float* scale, const float* v,
                   float* partial, int B, int DO, int DA, int n_blocks,
                   cudaStream_t st) {
    using PK = wide::Pick<XT, DT>;
    constexpr int smem = PK::L::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        wide::fvp_wide_kernel<XT, DT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    wide::fvp_wide_kernel<XT, DT><<<n_blocks, PK::NT, smem, st>>>(
        w, X, hs[0], hs[1], hs[2], scale, v, partial, B, DO, DA);
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

// The hidden-to-hidden weights' planes, once per update; every CG call's
// launch reads them. hidden (n_hidden ints, host): the policy's hidden
// widths, which must be this library's (policy_shape.cuh), else
// cudaErrorInvalidValue; weights (host array of device pointers): W0, b0,
// ..., W_L, b_L, logstd. planes: 3 sum_{l=1}^{L-1} pad(w_{l-1}) pad(w_l)
// bf16, each W_l's three planes (pad(w_{l-1}), pad(w_l)) after the last,
// zero past its widths (pad: up to a multiple of 16).
extern "C" int trpo_fvp_split_launch(const int* hidden, int n_hidden,
                                     const float* const* weights,
                                     void* planes, void* stream) {
    if (!policy_shape::same_shape(hidden, n_hidden))
        return (int)cudaErrorInvalidValue;
    if (policy_shape::WIDE) return (int)cudaSuccess;   // reads fp32 weights
    const policy_shape::Weights w = policy_shape::weights_of(weights);
    bf16* p = static_cast<bf16*>(planes);
    for (int l = 1; l < NL; ++l) {
        const cudaError_t err = split_pad(
            w.W[l], p + gw_off(l), pad(l - 1) * pad(l), wid(l - 1), wid(l),
            pad(l - 1), pad(l), static_cast<cudaStream_t>(stream));
        if (err != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
}

// X (B, do), hs: a host array of the device pointers h_0 .. h_{L-1}
// (B, w_l), Wp: the planes from trpo_fvp_split_launch, weights as there
// (the kernel reads the head W_L (w_{L-1}, da)), scale (da) =
// exp(-2 logstd) / B, v and out (P) in flat sorted-key order, all on the
// device; vplanes: 3 (do pad(w_0) + sum_{l>=1} pad(w_{l-1}) pad(w_l))
// bf16 and partial: n_blocks * (P - da) floats of scratch. Launches the
// split of v's W0 .. W_{L-1} blocks, the kernel and the reduce pass.
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
        // the wide form reads v as it is
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

// Samples a tile of the instantiation for (do, da): the grid's unit of
// work (n_blocks = min(ceil(B / tile), 132)); -1 for a (do, da) it does
// not take.
extern "C" int trpo_fvp_tile(int DO, int DA) {
    int ts = -1;
    dispatch(DO, DA, [&](auto pk) -> cudaError_t {
        ts = decltype(pk)::TS;
        return cudaSuccess;
    });
    return ts;
}

// What the card makes of the instantiation for (do, da): out[0] resident
// blocks per SM, out[1] registers per thread, out[2] local (spill) bytes
// per thread, out[3] dynamic and out[4] static shared bytes per block,
// out[5] threads per block, out[6] samples a tile.
extern "C" int trpo_fvp_occupancy(int DO, int DA, int* out) {
    return (int)dispatch(DO, DA, [&](auto pk) -> cudaError_t {
        return occupancy(pk, out);
    });
}
