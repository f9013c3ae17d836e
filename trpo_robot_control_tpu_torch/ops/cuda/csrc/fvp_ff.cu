// Gauss-Newton Fisher-vector product on the feature-first Fisher
// subsample as the rollout stores it, with the hidden activations
// recomputed per call, on the tensor cores.
//
// Replaces `make_pallas_gn_fvp_ff` (fvp_ff_kernel.py:127) and the
// pallas_call it reaches (`_fvp_ff_kernel`, :188) in
// trpo_robot_control_tpu/ops/pallas/fvp_ff_kernel.py. The subsample is
// obs_ff[::k, :, ::e], a (T', do, N') view of the (T, do, N) batch, read
// in place through its time, feature and env strides (no copy, bf16 or
// fp32 as stored; e = 1 at c3, 4 at c4, 8 at c5). The policy has 1-3
// hidden layers of 1-64 units (policy_shape.cuh; (64, 64) at c3-c5). Per
// call and per sample, the fp32 function of the plain version, with
// h_-1 = x, dh_-1 = 0 and W_L the head (at L = 2):
//   recompute        h_l = tanh(h_{l-1} W_l + b_l): h0 = tanh(x W0 + b0),
//                    h1 = tanh(h0 W1 + b1)
//   forward tangent  dh_l = (1-h_l^2)(dh_{l-1} W_l + h_{l-1} dW_l + db_l):
//                    dh0 = (1-h0^2)(x dW0 + db0)
//                    dh1 = (1-h1^2)(dh0 W1 + h0 dW1 + db1)
//                    dmu = dh1 W2 + h1 dW2 + db2
//   Fisher scaling   u   = dmu * inv_var / B'
//   reverse          gW_L = h_{L-1}^T u, g_{L-1} = (u W_L^T)(1-h_{L-1}^2),
//                    then gW_l = h_{l-1}^T g_l,
//                    g_{l-1} = (g_l W_l^T)(1-h_{l-1}^2): gW2 = h1^T u,
//                    g1 = (u W2^T)(1-h1^2), gW1 = h0^T g1,
//                    g0 = (g1 W1^T)(1-h0^2), gW0 = x^T g0 (+ bias sums)
// The logstd block 2 v and the damping are added in the reduce pass
// (fvp_tile.cuh's, shared with the batch-major fvp.cu), as the TPU wrapper
// adds them outside its kernel.
//
// The TPU kernel rounds its weights and activations to the storage dtype;
// this one keeps the fp32 function (the JAX package's CPU route), which CG
// needs to the last bits: two calls on the same v return bit-identical
// Fv. Its hidden layers' products (eight at (64, 64)) run on the tensor
// cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), every width padded
// to the tile's 16 with zeros (a padded unit's h, dh and g are exact
// zeros), and stay exact to fp32: every fp32
// operand is split into three bf16 planes, w = hi + mid + lo exactly
// (pg_kernel.split3 states the split, fvp_tile.cuh holds it for both FVP
// kernels), and a product of two fp32 operands
// is the sum of the six plane products hi hi, hi mid, mid hi, hi lo,
// lo hi, mid mid; the three dropped terms are below 2^-24 relative, one
// fp32 rounding. A bf16-stored x is its own hi plane, so x W0, x dW0 and
// x^T g0 take three products. hi hi sums into one accumulator and the
// other five into a second, added in fp32 at the end, so the tensor
// cores' truncating sums see the large terms only once per k-step. The
// weight gradients take fresh per-tile sums, added in fp32 to running
// totals. The weights and v are split once per block in the prologue, the
// activations h_l, dh_l and g_l as they are produced.
//
// Layout: hidden units are the mma's M, samples its N, features its K.
// A tile is one time step and TS subsampled envs; each warp owns 16
// hidden units by TS / 2 samples of the forward products. TS is 64 (at
// c3-c5) where the block's shared memory holds every layer's weight and
// v planes and activations at that tile, else 32 (at (64, 64, 64), whose
// planes alone take 138 KB); x is double-buffered where that fits too.
// x goes to shared memory feature-first; the next tile's x is loaded into
// registers at the start of a tile and stored into the second buffer at
// its end (one element per load: at e = 4 and 8 a bf16 element stands
// alone in its 16 bytes). The layers before the last keep h_l as planes
// for the reverse pass and dh_l in one of two plane buffers used in turn;
// the last one's h and dh stay fp32. The da-wide head (dmu, u, gW2,
// u W2^T, the bias sums) has fp32 operands on both sides and runs on the
// CUDA cores in fp32. tanhf is the precise one, as the plain version's
// torch.tanh. Seven __syncthreads per tile at two layers, one more per
// further layer.
//
// What bounds it on an H100: at c5 (B' = 204,800 samples, do 27, H 64,
// da 7) the function is 27.5k MACs a sample, 11.2 GFLOP (0.0114 ms at the
// 989 TFLOP/s bf16 peak); the plane products make it 141k bf16 MACs a
// sample (0.059 ms at that peak); the strided reads cost 88.5 MB of
// 32-byte sectors (0.026 ms at 3.35 TB/s). The planes' ldmatrix traffic,
// the split epilogues and the seven phases that one block per SM runs
// one after another (188 KB of shared memory: the weights' and v's planes
// alone take 81 KB) set its time, more than the mma themselves; PERF.md
// has the measurements.
//
// No float atomics: blocks keep their share of the gradient in registers
// across their tiles and write per-block partials over a fixed grid; the
// reduce pass sums them in a fixed order.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fvp_tile.cuh"
#include "mma_bf16.cuh"
#include "policy_shape.cuh"

namespace {

using bf16 = __nv_bfloat16;
using policy_shape::Flat;
using policy_shape::Hidden;
using policy_shape::NL;
// the packed forms only, as the TPU kernel takes them (build.MAX_WIDTH)
static_assert(Hidden::widest() <= policy_shape::PACKED_MAX,
              "hidden widths up to 64 (ROADMAP B3 for more)");
using policy_shape::Weights;
using policy_shape::padded;

constexpr int NT = 256;        // threads per block: 8 warps
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int XR = DO_MAX;     // x rows: layer 0's K, gW0's M
constexpr int PL = 3;          // planes of an fp32 operand: hi, mid, lo
constexpr int HMP = (Hidden::widest() + 15) / 16 * 16;  // widest, padded
constexpr int HL = Hidden::width(NL - 1);              // the head's inputs
constexpr int HLP = padded(NL - 1);
constexpr int WRS = HMP + 8;   // bf16 row stride of the weights' planes:
                               // an odd number of 16 bytes, so the 8 rows
                               // of an ldmatrix hit distinct bank groups

// layer l's padded K: its weights' rows
__host__ __device__ constexpr int kp(int l) {
    return l == 0 ? XR : padded(l - 1);
}

// hidden layer l's weight planes and v's, each 3 x (kp(l), WRS) [in][out]:
// bf16 elements a plane, byte offsets of the two
__host__ __device__ constexpr int wp(int l) { return kp(l) * WRS; }
__host__ __device__ constexpr int w_off(int l) {
    int o = 0;
    for (int m = 0; m < l; ++m) o += 2 * PL * wp(m) * 2;
    return o;
}
__host__ __device__ constexpr int dw_off(int l) {
    return w_off(l) + PL * wp(l) * 2;
}

// shared memory, byte offsets, for a tile of TS samples, XB buffers of x
// and XP planes of x (1 for bf16 storage)
template <int TS, int XB, int XP>
struct Layout {
    static constexpr int RS = TS + 8;  // bf16 row stride of [.][s] tiles
    static constexpr int FS = TS + 4;  // fp32 row stride of h, dh (last)
    static constexpr int ACTP = HMP * RS;            // bf16 elements a plane
    static constexpr int XBUF = XP * XR * RS;
    static constexpr int X = w_off(NL);              // XB x XP x (XR, RS)
    static constexpr int H = X + XB * XBUF * 2;      // h_l planes, l < L-1
    // A: dh_l (l even), then dmu's partial sums, then g_{L-1} and the
    // g_{l-1} of every other reverse layer
    static constexpr int MUP = 4 * DA_MAX * TS * 4;
    static constexpr int ABYTES = PL * ACTP * 2 > MUP ? PL * ACTP * 2 : MUP;
    static constexpr int A = H + (NL - 1) * PL * ACTP * 2;
    static constexpr int B = A + ABYTES;             // dh_l (l odd, L = 3)
    // HF: the last layer's h, dh fp32 (HMP, FS), then g_{L-2}, and the
    // g_{l-1} of every other reverse layer, as planes
    static constexpr int HF = B + (NL > 2 ? PL * ACTP * 2 : 0);
    static constexpr int U = HF + 2 * HMP * FS * 4;  // u [m][s] fp32
    static constexpr int W2 = U + DA_MAX * TS * 4;   // W_L [k][m] fp32
    static constexpr int DW2 = W2 + 64 * DA_MAX * 4;
    static constexpr int C = DW2 + 64 * DA_MAX * 4;  // db2, scale
    static constexpr int BYTES = C + 2 * DA_MAX * 4;
    // the block's end-of-run scratch over the activations: the head's
    // gradient [4][64][DA_MAX], the last layer's bias sums [4][64], the
    // other layers' [L - 1][2][64], gb2's [DA_MAX][TS]
    static constexpr int SCRATCH =
        (4 * 64 * DA_MAX + 4 * 64 + 2 * 64 * (NL - 1) + DA_MAX * TS) * 4;
    static constexpr bool FITS = BYTES <= 232448;
    static_assert(PL * ACTP * 2 <= 2 * HMP * FS * 4, "g fits over h, dh");
    static_assert(SCRATCH <= U - H, "the scratch fits over the activations");
    static_assert(X % 16 == 0 && H % 16 == 0 && A % 16 == 0 && B % 16 == 0 &&
                  HF % 16 == 0 && U % 16 == 0 && W2 % 16 == 0,
                  "16-byte aligned rows");
};

// The layout a subsample stored with XP planes takes: 64 samples a tile
// with two x buffers where it fits, else 32 with two, else 32 with one
template <int XP>
struct Pick {
    static constexpr int TS = Layout<64, 2, XP>::FITS ? 64 : 32;
    static constexpr int XB = Layout<TS, 2, XP>::FITS ? 2 : 1;
    using L = Layout<TS, XB, XP>;
    static_assert(L::FITS, "one block's shared memory");
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const bf16* p) {
    return __bfloat162float(*p);
}

using fvp_tile::split3;
using fvp_tile::split_pair;
using fvp_tile::zero;

// the planes of the pair (v0, v1) at p + q plane, q = 0, 1, 2
__device__ __forceinline__ void store_planes2(bf16* p, int plane, float v0,
                                              float v1) {
    uint32_t r[PL];
    split_pair(v0, v1, r[0], r[1], r[2]);
#pragma unroll
    for (int q = 0; q < PL; ++q)
        *reinterpret_cast<uint32_t*>(p + q * plane) = r[q];
}

// the fp32 pair that the planes at p + q plane sum to
__device__ __forceinline__ float2 load_planes2(const bf16* p, int plane) {
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int q = 0; q < PL; ++q) {
        const float2 f = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p + q * plane));
        s.x += f.x;
        s.y += f.y;
    }
    return s;
}

// hi += A_0 B_0; ml += A_p B_q over the other plane pairs with p + q <= 2
// (p < AP, q < BP). a: the A fragments of the planes; b: each plane's two
// B registers of one n8 tile.
template <int AP, int BP>
__device__ __forceinline__ void plane_mma(float (&hi)[4], float (&ml)[4],
                                          const uint32_t (&a)[PL][4],
                                          const uint32_t (&b)[PL][2]) {
    mma_bf16(hi, a[0], b[0][0], b[0][1], false);
    if (BP > 1) mma_bf16(ml, a[0], b[1][0], b[1][1], false);
    if (AP > 1) mma_bf16(ml, a[1], b[0][0], b[0][1], false);
    if (BP > 2) mma_bf16(ml, a[0], b[2][0], b[2][1], false);
    if (AP > 2) mma_bf16(ml, a[2], b[0][0], b[0][1], false);
    if (AP > 1 && BP > 1) mma_bf16(ml, a[1], b[1][0], b[1][1], false);
}

// B registers of n8 tile h from an x4 load covering 16 samples: loads
// transposed from an [k][s] tile give (r[2h], r[2h + 1]), loads as stored
// from an [n][k] tile give (r[h], r[h + 2])
template <int P>
__device__ __forceinline__ void pick(uint32_t (&b)[PL][2],
                                     const uint32_t (&r)[PL][4], int i0,
                                     int i1) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
        b[p][0] = r[p][i0];
        b[p][1] = r[p][i1];
    }
}

// The block's per-tile state: the layout's buffers and the warp's roles.
template <int XP>
struct Tile {
    using L = typename Pick<XP>::L;
    static constexpr int TS = Pick<XP>::TS;
    static constexpr int RS = L::RS, FS = L::FS;
    static constexpr int SW = TS / 2;      // samples of a warp's products
    static constexpr int NTN = SW / 8;     // its n8 tiles
    char* smem;
    int mt, nh, lane;
    __device__ bf16* w(int l) const {
        return reinterpret_cast<bf16*>(smem + w_off(l));
    }
    __device__ bf16* dw(int l) const {
        return reinterpret_cast<bf16*>(smem + dw_off(l));
    }
    __device__ bf16* h(int l) const {       // h_l's planes, l < L - 1
        return reinterpret_cast<bf16*>(smem + L::H) + l * PL * L::ACTP;
    }
    __device__ bf16* dh(int l) const {      // dh_l's planes, l < L - 1
        return reinterpret_cast<bf16*>(smem + (l % 2 ? L::B : L::A));
    }
    __device__ float* hf() const {          // h_{L-1}, fp32
        return reinterpret_cast<float*>(smem + L::HF);
    }
    __device__ float* dhf() const {         // dh_{L-1}, fp32
        return hf() + HMP * FS;
    }
    // where the reverse pass keeps g_l: g_{L-1} in A, then HF and A in
    // turn
    __device__ bf16* g(int l) const {
        return reinterpret_cast<bf16*>(
            smem + ((NL - 1 - l) % 2 ? L::HF : L::A));
    }
};

// Hidden layer l's weights and v's block of it as three bf16 planes
// [in][out], rows past the input width and columns past the output width
// zero
template <int XP, int l>
__device__ __forceinline__ void split_layer(const Tile<XP>& tl,
                                            const Weights& p,
                                            const float* v, const Flat& f,
                                            int DO, int tid) {
    using L = typename Tile<XP>::L;
    constexpr int K = kp(l), M = padded(l), W = Hidden::width(l);
    const int IN = policy_shape::in_width(l, DO);
    bf16* sw = tl.w(l);
    bf16* sdw = tl.dw(l);
    for (int i = tid; i < K * M; i += NT) {
        const int k = i / M, o = i % M;
        const bool in = k < IN && o < W;
        bf16 a[PL], b[PL];
        split3(in ? p.W[l][k * W + o] : 0.f, a);
        split3(in ? v[f.W[l] + k * W + o] : 0.f, b);
#pragma unroll
        for (int q = 0; q < PL; ++q) {
            sw[q * wp(l) + k * WRS + o] = a[q];
            sdw[q * wp(l) + k * WRS + o] = b[q];
        }
    }
}

// Hidden layer l forward: h_l = tanh(h_{l-1} W_l + b_l) and the tangent
// dh_l, warp (units 16 mt.., samples SW nh..); as planes for l < L - 1,
// fp32 for the last layer. Layer 0 reads x's XP planes, the others the
// planes of h_{l-1} and dh_{l-1}.
template <int XP, int l>
__device__ __forceinline__ void forward_layer(const Tile<XP>& tl,
                                              const bf16* sX,
                                              const float (&bias)[2],
                                              const float (&dbias)[2]) {
    using T = Tile<XP>;
    using L = typename T::L;
    constexpr int RS = T::RS, NTN = T::NTN, SW = T::SW;
    if (padded(l) != 64 && 16 * tl.mt >= padded(l)) return;
    const int lane = tl.lane, mt = tl.mt, nh = tl.nh;
    const int g = lane >> 2, c = lane & 3;
    const int lr = lane & 15, lc = (lane >> 4) << 3;
    const int ar = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) << 3;
    float ah[NTN][4], am[NTN][4], th[NTN][4], tm[NTN][4];
    zero(ah); zero(am); zero(th); zero(tm);
    const bf16* sw = tl.w(l);
    const bf16* sdw = tl.dw(l);
#pragma unroll
    for (int kk = 0; kk < kp(l) / 16; ++kk) {
        uint32_t aw[PL][4], ad[PL][4];
#pragma unroll
        for (int p = 0; p < PL; ++p) {
            ldmatrix_x4_trans(aw[p], sw + p * wp(l) + (16 * kk + ar) * WRS +
                                         16 * mt + ac);
            ldmatrix_x4_trans(ad[p], sdw + p * wp(l) + (16 * kk + ar) * WRS +
                                         16 * mt + ac);
        }
        if constexpr (l == 0) {
            uint32_t bx[SW / 16][PL][4];
#pragma unroll
            for (int j = 0; j < SW / 16; ++j)
#pragma unroll
                for (int p = 0; p < XP; ++p)
                    ldmatrix_x4_trans(bx[j][p], sX + p * XR * RS +
                                                    (16 * kk + lr) * RS +
                                                    SW * nh + 16 * j + lc);
#pragma unroll
            for (int nt = 0; nt < NTN; ++nt) {
                uint32_t b[PL][2];
                pick<XP>(b, bx[nt >> 1], 2 * (nt & 1), 2 * (nt & 1) + 1);
                plane_mma<PL, XP>(ah[nt], am[nt], aw, b);
                plane_mma<PL, XP>(th[nt], tm[nt], ad, b);
            }
        } else {
            const bf16* hp = tl.h(l > 0 ? l - 1 : 0);
            const bf16* dp = tl.dh(l > 0 ? l - 1 : 0);
#pragma unroll
            for (int j = 0; j < SW / 16; ++j) {
                uint32_t bh[PL][4], bd[PL][4];
#pragma unroll
                for (int p = 0; p < PL; ++p) {
                    const int off = p * L::ACTP + (16 * kk + lr) * RS +
                                    SW * nh + 16 * j + lc;
                    ldmatrix_x4_trans(bh[p], hp + off);
                    ldmatrix_x4_trans(bd[p], dp + off);
                }
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int nt = 2 * j + e;
                    uint32_t fh[PL][2], fd[PL][2];
                    pick<PL>(fh, bh, 2 * e, 2 * e + 1);
                    pick<PL>(fd, bd, 2 * e, 2 * e + 1);
                    plane_mma<PL, PL>(ah[nt], am[nt], aw, fh);
                    plane_mma<PL, PL>(th[nt], tm[nt], aw, fd);
                    plane_mma<PL, PL>(th[nt], tm[nt], ad, fh);
                }
            }
        }
    }
#pragma unroll
    for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            float h[2], dh[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int q = 2 * hf + e;
                h[e] = tanhf((ah[nt][q] + am[nt][q]) + bias[hf]);
                dh[e] = (1.f - h[e] * h[e]) *
                        ((th[nt][q] + tm[nt][q]) + dbias[hf]);
            }
            const int row = 16 * mt + g + 8 * hf, col = SW * nh + 8 * nt + 2 * c;
            if constexpr (l == NL - 1) {
                *reinterpret_cast<float2*>(tl.hf() + row * T::FS + col) =
                    make_float2(h[0], h[1]);
                *reinterpret_cast<float2*>(tl.dhf() + row * T::FS + col) =
                    make_float2(dh[0], dh[1]);
            } else {
                store_planes2(tl.h(l) + row * RS + col, L::ACTP, h[0], h[1]);
                store_planes2(tl.dh(l) + row * RS + col, L::ACTP, dh[0], dh[1]);
            }
        }
}

// Reverse layer l > 0: g_{l-1} = (g_l W_l^T)(1 - h_{l-1}^2) into its
// planes, gb += g_{l-1}; tot += h_{l-1}^T g_l (this tile's sums fresh,
// then into the totals)
template <int XP, int l>
__device__ __forceinline__ void backward_layer(const Tile<XP>& tl,
                                               float (&tot)[4][4],
                                               float (&gb)[2]) {
    using T = Tile<XP>;
    using L = typename T::L;
    constexpr int RS = T::RS, NTN = T::NTN, SW = T::SW, TS = T::TS;
    constexpr int MP = padded(l - 1), KP = padded(l);
    if (MP != 64 && 16 * tl.mt >= MP) return;
    const int lane = tl.lane, mt = tl.mt, nh = tl.nh;
    const int g = lane >> 2, c = lane & 3;
    const int lr = lane & 15, lc = (lane >> 4) << 3;
    const bf16* sw = tl.w(l);
    const bf16* gl = tl.g(l);
    bf16* gn = tl.g(l - 1);
    const bf16* hp = tl.h(l - 1);
    {
        float gh[NTN][4], gm[NTN][4];
        zero(gh); zero(gm);
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk) {
            uint32_t a[PL][4];
#pragma unroll
            for (int p = 0; p < PL; ++p)
                ldmatrix_x4(a[p], sw + p * wp(l) + (16 * mt + lr) * WRS +
                                      16 * kk + lc);
#pragma unroll
            for (int j = 0; j < SW / 16; ++j) {
                uint32_t bg[PL][4];
#pragma unroll
                for (int p = 0; p < PL; ++p)
                    ldmatrix_x4_trans(bg[p], gl + p * L::ACTP +
                                                 (16 * kk + lr) * RS +
                                                 SW * nh + 16 * j + lc);
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    uint32_t b[PL][2];
                    pick<PL>(b, bg, 2 * e, 2 * e + 1);
                    plane_mma<PL, PL>(gh[2 * j + e], gm[2 * j + e], a, b);
                }
            }
        }
#pragma unroll
        for (int nt = 0; nt < NTN; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int off =
                    (16 * mt + g + 8 * hf) * RS + SW * nh + 8 * nt + 2 * c;
                const float2 h = load_planes2(hp + off, L::ACTP);
                const float v0 = (gh[nt][2 * hf] + gm[nt][2 * hf]) * (1.f - h.x * h.x);
                const float v1 =
                    (gh[nt][2 * hf + 1] + gm[nt][2 * hf + 1]) * (1.f - h.y * h.y);
                gb[hf] += v0;
                gb[hf] += v1;
                store_planes2(gn + off, L::ACTP, v0, v1);
            }
    }
    {   // gW_l += h_{l-1}^T g_l: warp (rows 16 mt.., cols 32 nh..)
        float fh[4][4], fm[4][4];
        zero(fh); zero(fm);
#pragma unroll
        for (int ks = 0; ks < TS / 16; ++ks) {
            uint32_t a[PL][4];
#pragma unroll
            for (int p = 0; p < PL; ++p)
                ldmatrix_x4(a[p], hp + p * L::ACTP + (16 * mt + lr) * RS + 16 * ks + lc);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                if (KP == 64 || 32 * nh + 16 * j < KP) {
                    uint32_t bg[PL][4];
#pragma unroll
                    for (int p = 0; p < PL; ++p)
                        ldmatrix_x4(bg[p], gl + p * L::ACTP +
                                               (32 * nh + 16 * j + lr) * RS +
                                               16 * ks + lc);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        uint32_t b[PL][2];
                        pick<PL>(b, bg, e, e + 2);
                        plane_mma<PL, PL>(fh[2 * j + e], fm[2 * j + e], a, b);
                    }
                }
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) tot[i][q] += fh[i][q] + fm[i][q];
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

// DEPTH = NL: a template argument, so that the layers past NL are never
// built
template <typename In, int XP, int DEPTH>
__global__ void __launch_bounds__(NT, 1) fvp_ff_tc_kernel(
    const In* __restrict__ X, long long t_stride, long long d_stride,
    long long n_stride, Weights p, const float* __restrict__ scale,
    const float* __restrict__ v, float* __restrict__ partial, int T, int DO,
    int DA, int N) {
    using TT = Tile<XP>;
    using L = typename TT::L;
    constexpr int TS = TT::TS, RS = TT::RS, FS = TT::FS;
    constexpr int XB = Pick<XP>::XB;
    constexpr int XLOADS = XR * TS / NT;   // x elements a thread stages
    constexpr int SQ = TS / 4;             // samples of a CUDA-core quarter
    extern __shared__ __align__(16) char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // mma roles: hidden rows 16 mt.., samples SW nh.. (gW_l: cols 32 nh..)
    const TT tl = {smem, warp & 3, warp >> 2, lane};
    const int mt = tl.mt, nh = tl.nh;
    const int g = lane >> 2, c = lane & 3;
    // CUDA-core roles: (sample hs, outputs mq, mq + 4), (unit hs, samples
    // SQ mq..)
    const int hs = tid & 63, mq = tid >> 6;
    bf16* sXb = reinterpret_cast<bf16*>(smem + L::X);
    float* sMuP = reinterpret_cast<float*>(smem + L::A);   // [kq][m][s]
    const float* sHL = tl.hf();
    const float* sDHL = tl.dhf();
    bf16* sGL = tl.g(DEPTH - 1);
    const bf16* sG0 = tl.g(0);
    float* sU = reinterpret_cast<float*>(smem + L::U);
    float* sW2 = reinterpret_cast<float*>(smem + L::W2);
    float* sdW2 = reinterpret_cast<float*>(smem + L::DW2);
    float* sdb2 = reinterpret_cast<float*>(smem + L::C);
    float* sscale = sdb2 + DA_MAX;

    const Flat f = policy_shape::flat(DO, DA);
    const int Pg = f.ls;               // the gradient's entries, logstd out

    // prologue: three bf16 planes of every hidden layer's W and dW
    split_layer<XP, 0>(tl, p, v, f, DO, tid);
    if constexpr (DEPTH > 1) split_layer<XP, 1>(tl, p, v, f, DO, tid);
    if constexpr (DEPTH > 2) split_layer<XP, 2>(tl, p, v, f, DO, tid);
    for (int i = tid; i < 64 * DA_MAX; i += NT) {     // W_L, padded
        const int k = i / DA_MAX, m = i % DA_MAX;
        const bool in = m < DA && k < HL;
        sW2[i] = in ? p.W[DEPTH][k * DA + m] : 0.f;
        sdW2[i] = in ? v[f.W[DEPTH] + k * DA + m] : 0.f;
    }
    if (tid < DA_MAX) {
        sdb2[tid] = tid < DA ? v[f.b[DEPTH] + tid] : 0.f;
        sscale[tid] = tid < DA ? scale[tid] : 0.f;
    }
    float w2r[DA_MAX];                 // W_L[hs][.], for u W_L^T
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m)
        w2r[m] = m < DA && hs < HL ? p.W[DEPTH][hs * DA + m] : 0.f;
    float bias[DEPTH][2], dbias[DEPTH][2];
#pragma unroll
    for (int l = 0; l < DEPTH; ++l)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int r = 16 * mt + g + 8 * hf;
            const bool in = r < Hidden::width(l);
            bias[l][hf] = in ? p.b[l][r] : 0.f;
            dbias[l][hf] = in ? v[f.b[l] + r] : 0.f;
        }

    // gW_l, l = 1..L-1 (rows 16 mt.., cols 32 nh..), gW0 (rows 16 (warp &
    // 1).., cols 16 (warp >> 1)..)
    float tot[DEPTH > 1 ? DEPTH - 1 : 1][4][4], tot0[2][4];
#pragma unroll
    for (int l = 0; l < (DEPTH > 1 ? DEPTH - 1 : 1); ++l) zero(tot[l]);
    zero(tot0);
    float aW2[DA_MAX];                 // gW_L[hs][.] over samples SQ mq..
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) aW2[m] = 0.f;
    // bias sums: layers 0..L-2 in the mma layout (rows 16 mt + g (+ 8)),
    // layer L-1 by unit hs
    float gbm[DEPTH > 1 ? DEPTH - 1 : 1][2], gbl = 0.f, gb2[2] = {0.f, 0.f};
#pragma unroll
    for (int l = 0; l < (DEPTH > 1 ? DEPTH - 1 : 1); ++l)
        gbm[l][0] = gbm[l][1] = 0.f;

    const int tiles_per_t = (N + TS - 1) / TS;
    const int n_tiles = T * tiles_per_t;
    const int G = gridDim.x;
    // x of a tile: element i = tid + NT r is (row i / TS, sample i % TS);
    // rows past DO and envs past N are zero
    float xr[XLOADS];
    auto load_x = [&](int tile) {
        const int t = tile / tiles_per_t, n0 = (tile % tiles_per_t) * TS;
        const In* base = X + (long long)t * t_stride;
#pragma unroll
        for (int r = 0; r < XLOADS; ++r) {
            const int i = tid + NT * r, d = i / TS, n = n0 + i % TS;
            xr[r] = (d < DO && n < N)
                        ? load_f32(base + d * d_stride + n * n_stride)
                        : 0.f;
        }
    };
    auto store_x = [&](int buf) {
        bf16* sx = sXb + buf * L::XBUF;
#pragma unroll
        for (int r = 0; r < XLOADS; ++r) {
            const int i = tid + NT * r, off = (i / TS) * RS + i % TS;
            if constexpr (XP == 1) {
                sx[off] = __float2bfloat16_rn(xr[r]);   // exact: bf16 input
            } else {
                bf16 q[PL];
                split3(xr[r], q);
#pragma unroll
                for (int k = 0; k < PL; ++k) sx[k * XR * RS + off] = q[k];
            }
        }
    };
    if (blockIdx.x < n_tiles) {
        load_x(blockIdx.x);
        store_x(0);
    }

    int buf = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += G, buf ^= XB - 1) {
        const int n0 = (tile % tiles_per_t) * TS;
        const int ns = min(TS, N - n0);
        const bool more = tile + G < n_tiles;
        __syncthreads();        // x staged; every warp done with the last tile
        if (more) load_x(tile + G);
        const bf16* sX = sXb + buf * L::XBUF;

        // h_l and dh_l, layer by layer
        forward_layer<XP, 0>(tl, sX, bias[0], dbias[0]);
        __syncthreads();
        if constexpr (DEPTH > 1) {
            forward_layer<XP, 1>(tl, sX, bias[1], dbias[1]);
            __syncthreads();
        }
        if constexpr (DEPTH > 2) {
            forward_layer<XP, 2>(tl, sX, bias[2], dbias[2]);
            __syncthreads();
        }
        {   // dmu's partial sums over a quarter of the units: thread (sample
            // pair lane, outputs 4 (warp & 1)..+3, units 16 (warp >> 1)..)
            const int m0 = 4 * (warp & 1), kq = warp >> 1;
            float acc[2][4];
            zero(acc);
            if (2 * lane < TS) {
                if (HLP == 64 || 16 * kq < HLP) {
#pragma unroll
                    for (int k = 16 * kq; k < 16 * kq + 16; ++k) {
                        const float2 h = *reinterpret_cast<const float2*>(sHL + k * FS + 2 * lane);
                        const float2 dh = *reinterpret_cast<const float2*>(sDHL + k * FS + 2 * lane);
                        const float4 w = *reinterpret_cast<const float4*>(sW2 + k * DA_MAX + m0);
                        const float4 dw = *reinterpret_cast<const float4*>(sdW2 + k * DA_MAX + m0);
                        const float wv[4] = {w.x, w.y, w.z, w.w};
                        const float dv[4] = {dw.x, dw.y, dw.z, dw.w};
#pragma unroll
                        for (int j = 0; j < 4; ++j) {
                            acc[0][j] = fmaf(h.x, dv[j], fmaf(dh.x, wv[j], acc[0][j]));
                            acc[1][j] = fmaf(h.y, dv[j], fmaf(dh.y, wv[j], acc[1][j]));
                        }
                    }
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    *reinterpret_cast<float2*>(sMuP + (kq * DA_MAX + m0 + j) * TS + 2 * lane) =
                        make_float2(acc[0][j], acc[1][j]);
            }
        }
        __syncthreads();
        // u = dmu * scale (0 on padded samples), gb2 = sum u: thread
        // (sample hs, outputs mq and mq + 4)
        if (hs < TS) {
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int m = mq + 4 * j;
                const float* pm = sMuP + m * TS + hs;
                const float dmu = ((pm[0] + pm[DA_MAX * TS]) +
                                   (pm[2 * DA_MAX * TS] + pm[3 * DA_MAX * TS])) + sdb2[m];
                const float u = hs < ns ? dmu * sscale[m] : 0.f;
                gb2[j] += u;
                sU[m * TS + hs] = u;
            }
        }
        __syncthreads();
        // thread (unit hs, samples SQ mq..): gW_L += h_{L-1}^T u;
        // g_{L-1} = (u W_L^T)(1 - h_{L-1}^2) into its planes, gbl += g_{L-1}
        if (HLP == 64 || hs < HLP) {
#pragma unroll
            for (int ch = 0; ch < SQ / 8; ++ch) {
                const int s0 = SQ * mq + 8 * ch;
                const float4 ha = *reinterpret_cast<const float4*>(sHL + hs * FS + s0);
                const float4 hb = *reinterpret_cast<const float4*>(sHL + hs * FS + s0 + 4);
                const float h[8] = {ha.x, ha.y, ha.z, ha.w, hb.x, hb.y, hb.z, hb.w};
                float gv[8];
#pragma unroll
                for (int m = 0; m < DA_MAX; ++m) {
                    const float4 ua = *reinterpret_cast<const float4*>(sU + m * TS + s0);
                    const float4 ub = *reinterpret_cast<const float4*>(sU + m * TS + s0 + 4);
                    const float u[8] = {ua.x, ua.y, ua.z, ua.w, ub.x, ub.y, ub.z, ub.w};
#pragma unroll
                    for (int q = 0; q < 8; ++q) {
                        aW2[m] = fmaf(h[q], u[q], aW2[m]);
                        gv[q] = m == 0 ? u[q] * w2r[0] : fmaf(u[q], w2r[m], gv[q]);
                    }
                }
#pragma unroll
                for (int q = 0; q < 8; q += 2) {
                    const float g0v = gv[q] * (1.f - h[q] * h[q]);
                    const float g1v = gv[q + 1] * (1.f - h[q + 1] * h[q + 1]);
                    gbl += g0v;
                    gbl += g1v;
                    store_planes2(sGL + hs * RS + s0 + q, L::ACTP, g0v, g1v);
                }
            }
        }
        __syncthreads();
        // g_{l-1} and gW_l, layer by layer down
        if constexpr (DEPTH > 2) {
            backward_layer<XP, 2>(tl, tot[1], gbm[1]);
            __syncthreads();
        }
        if constexpr (DEPTH > 1) {
            backward_layer<XP, 1>(tl, tot[0], gbm[0]);
            __syncthreads();
        }
        {   // gW0 += x^T g0: warp (d rows 16 (warp & 1).., h cols 16 (warp >> 1)..)
            const int d0 = 16 * (warp & 1), h0 = 16 * (warp >> 1);
            if (padded(0) == 64 || h0 < padded(0)) {
                float fh[2][4], fm[2][4];
                zero(fh); zero(fm);
                const int lr = lane & 15, lc = (lane >> 4) << 3;
#pragma unroll
                for (int ks = 0; ks < TS / 16; ++ks) {
                    uint32_t a[PL][4], bg[PL][4];
#pragma unroll
                    for (int q = 0; q < XP; ++q)
                        ldmatrix_x4(a[q], sX + q * XR * RS + (d0 + lr) * RS + 16 * ks + lc);
#pragma unroll
                    for (int q = 0; q < PL; ++q)
                        ldmatrix_x4(bg[q], sG0 + q * L::ACTP + (h0 + lr) * RS + 16 * ks + lc);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        uint32_t b[PL][2];
                        pick<PL>(b, bg, e, e + 2);
                        plane_mma<XP, PL>(fh[e], fm[e], a, b);
                    }
                }
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int q = 0; q < 4; ++q) tot0[i][q] += fh[i][q] + fm[i][q];
            }
        }
        if (more) {
            if constexpr (XB == 1) __syncthreads();   // every warp done with x
            store_x(buf ^ (XB - 1));
        }
    }
    __syncthreads();

    // the block's partial: gW_l (l < L) straight from the fragments, the
    // rest through shared scratch (over the activations), summed in a
    // fixed order
    float* out = partial + (size_t)blockIdx.x * Pg;
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
    float* rW2 = reinterpret_cast<float*>(smem + L::H);    // [mq][k][m]
    float* rBL = rW2 + 4 * 64 * DA_MAX;                     // [mq][k]
    float* rB = rBL + 4 * 64;                               // [l][nh][h]
    float* rB2 = rB + 2 * 64 * (DEPTH - 1);                 // [m][s]
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) rW2[(mq * 64 + hs) * DA_MAX + m] = aW2[m];
    rBL[mq * 64 + hs] = gbl;
#pragma unroll
    for (int l = 0; l < DEPTH - 1; ++l)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            float s = gbm[l][hf];
            s += __shfl_xor_sync(0xffffffffu, s, 1);
            s += __shfl_xor_sync(0xffffffffu, s, 2);
            if (c == 0) rB[(2 * l + nh) * 64 + 16 * mt + g + 8 * hf] = s;
        }
    if (hs < TS) {
#pragma unroll
        for (int j = 0; j < 2; ++j) rB2[(mq + 4 * j) * TS + hs] = gb2[j];
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
        float s = 0.f;
        for (int j = 0; j < TS; ++j) s += rB2[tid * TS + j];
        out[f.b[DEPTH] + tid] = s;
    }
}

template <typename In, int XP>
cudaError_t occupancy(int* out) {
    constexpr int smem = Pick<XP>::L::BYTES;
    auto kernel = fvp_ff_tc_kernel<In, XP, NL>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, NT,
                                                        smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    out[0] = blocks;
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = smem;
    out[4] = (int)fa.sharedSizeBytes;
    out[5] = NT;
    out[6] = Pick<XP>::TS;
    return cudaSuccess;
}

template <typename In, int XP>
cudaError_t launch(const void* X, long long t_stride, long long d_stride,
                   long long n_stride, const Weights& w, const float* scale,
                   const float* v, float* partial, float* out, int T, int DO,
                   int DA, int N, float damping, int n_blocks,
                   cudaStream_t st) {
    constexpr int smem = Pick<XP>::L::BYTES;
    auto kernel = fvp_ff_tc_kernel<In, XP, NL>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<n_blocks, NT, smem, st>>>(static_cast<const In*>(X), t_stride,
                                       d_stride, n_stride, w, scale, v,
                                       partial, T, DO, DA, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const Flat f = policy_shape::flat(DO, DA);
    return fvp_tile::reduce(partial, v, out, n_blocks, f.ls, f.P, damping,
                            st);
}

}  // namespace

// X: the (T', do, N') subsample, element (t, d, n) at X[t * t_stride +
// d * d_stride + n * n_stride], bf16 when bf16 != 0, else fp32. hidden
// (n_hidden ints, host): the policy's hidden widths, which must be this
// library's (policy_shape.cuh), else cudaErrorInvalidValue; weights (host
// array of device pointers): W0, b0, ..., W_L, b_L, L = n_hidden (W_l
// (in, out) row-major), then logstd (unread); scale (da) = exp(-2 logstd)
// / B', v and out (P) in flat sorted-key order, all fp32 on the device;
// partial: n_blocks * (P - da) floats of scratch.
extern "C" int trpo_fvp_ff_launch(const void* X, long long t_stride,
                                  long long d_stride, long long n_stride,
                                  const int* hidden, int n_hidden,
                                  const float* const* weights,
                                  const float* scale, const float* v,
                                  float* partial, float* out, int T, int DO,
                                  int DA, int N, float damping, int n_blocks,
                                  int bf16, void* stream) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX ||
        !policy_shape::same_shape(hidden, n_hidden))
        return (int)cudaErrorInvalidValue;
    const Weights w = policy_shape::weights_of(weights);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16)
        return (int)launch<__nv_bfloat16, 1>(X, t_stride, d_stride, n_stride,
                                             w, scale, v, partial, out, T, DO,
                                             DA, N, damping, n_blocks, st);
    return (int)launch<float, PL>(X, t_stride, d_stride, n_stride, w, scale,
                                  v, partial, out, T, DO, DA, N, damping,
                                  n_blocks, st);
}

// What the card makes of the bf16 (bf16 != 0) or fp32 instantiation:
// out[0] resident blocks per SM, out[1] registers per thread, out[2] local
// (spill) bytes per thread, out[3] dynamic and out[4] static shared bytes
// per block, out[5] threads per block, out[6] samples a tile.
extern "C" int trpo_fvp_ff_occupancy(int bf16, int* out) {
    return (int)(bf16 ? occupancy<__nv_bfloat16, 1>(out)
                      : occupancy<float, PL>(out));
}
