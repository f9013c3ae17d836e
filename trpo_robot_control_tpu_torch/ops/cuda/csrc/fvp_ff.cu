// Gauss-Newton Fisher-vector product on the feature-first Fisher
// subsample as the rollout stores it, with the hidden activations
// recomputed per call, on the tensor cores.
//
// Replaces `make_pallas_gn_fvp_ff` (fvp_ff_kernel.py:127) and the
// pallas_call it reaches (`_fvp_ff_kernel`, :188) in
// trpo_robot_control_tpu/ops/pallas/fvp_ff_kernel.py. The subsample is
// obs_ff[::k, :, ::e], a (T', do, N') view of the (T, do, N) batch, read
// in place through its time, feature and env strides (no copy, bf16 or
// fp32 as stored; e = 1 at c3, 4 at c4, 8 at c5). Per call and per sample,
// the fp32 function of the plain version:
//   recompute        h0 = tanh(x W0 + b0), h1 = tanh(h0 W1 + b1)
//   forward tangent  dh0 = (1-h0^2)(x dW0 + db0)
//                    dh1 = (1-h1^2)(dh0 W1 + h0 dW1 + db1)
//                    dmu = dh1 W2 + h1 dW2 + db2
//   Fisher scaling   u   = dmu * inv_var / B'
//   reverse          gW2 = h1^T u, g1 = (u W2^T)(1-h1^2), gW1 = h0^T g1,
//                    g0 = (g1 W1^T)(1-h0^2), gW0 = x^T g0 (+ bias sums)
// The logstd block 2 v and the damping are added in the reduce pass
// (fvp_tile.cuh's, shared with the batch-major fvp.cu), as the TPU wrapper
// adds them outside its kernel.
//
// The TPU kernel rounds its weights and activations to the storage dtype;
// this one keeps the fp32 function (the JAX package's CPU route), which CG
// needs to the last bits: two calls on the same v return bit-identical
// Fv. Its eight 64-wide products run on the tensor cores (mma.sync
// m16n8k16, bf16 in, fp32 accumulate) and stay exact to fp32: every fp32
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
// activations h0, dh0, g1 and g0 as they are produced.
//
// Layout: hidden units are the mma's M, samples its N, features its K.
// A tile is one time step and TS = 64 subsampled envs; each warp owns 16
// hidden units by 32 samples of the forward products. x goes to shared
// memory feature-first; the next tile's x is loaded into registers at the
// start of a tile and stored into the second buffer at its end (one
// element per load: at e = 4 and 8 a bf16 element stands alone in its
// 16 bytes). The da-wide head (dmu, u, gW2, u W2^T, the bias sums) has
// fp32 operands on both sides and runs on the CUDA cores in fp32. tanhf
// is the precise one, as the plain version's torch.tanh. Seven
// __syncthreads per tile.
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

namespace {

using bf16 = __nv_bfloat16;

constexpr int H = 64;          // hidden width (both layers)
constexpr int NT = 256;        // threads per block: 8 warps
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int TS = 64;         // samples (envs of one step) per tile
constexpr int RS = TS + 8;     // bf16 row stride: 144 B, so the 8 rows of
                               // an ldmatrix hit distinct bank groups
constexpr int FS = TS + 4;     // fp32 row stride of h1, dh1
constexpr int XR = DO_MAX;     // x rows: layer 0's K, gW0's M
constexpr int PL = 3;          // planes of an fp32 operand: hi, mid, lo
constexpr int XLOADS = XR * TS / NT;   // x elements a thread stages

// shared memory, byte offsets; XP = planes of x (1 for bf16 storage)
template <int XP>
struct Smem {
    static constexpr int W0P = XR * RS;              // bf16 elements a plane
    static constexpr int W1P = H * RS;
    static constexpr int ACTP = H * RS;
    static constexpr int XBUF = XP * XR * RS;
    static constexpr int W0 = 0;                     // 3 x (XR, RS) [d][h]
    static constexpr int DW0 = W0 + PL * W0P * 2;
    static constexpr int W1 = DW0 + PL * W0P * 2;    // 3 x (H, RS) [k][o]
    static constexpr int DW1 = W1 + PL * W1P * 2;
    static constexpr int X = DW1 + PL * W1P * 2;     // 2 x XP x (XR, RS)
    static constexpr int H0 = X + 2 * XBUF * 2;      // 3 x (H, RS) [h][s]
    static constexpr int DH0 = H0 + PL * ACTP * 2;   // dh0, then dmu's
                                                     // partial sums, then g1
    static constexpr int HF = DH0 + PL * ACTP * 2;   // h1, dh1 fp32 (H, FS),
                                                     // then g0's planes
    static constexpr int U = HF + 2 * H * FS * 4;    // u [m][s] fp32
    static constexpr int W2 = U + DA_MAX * TS * 4;   // W2 [k][m] fp32
    static constexpr int DW2 = W2 + H * DA_MAX * 4;
    static constexpr int C = DW2 + H * DA_MAX * 4;   // db2, scale
    static constexpr int BYTES = C + 2 * DA_MAX * 4;
    static_assert(PL * ACTP * 2 <= 2 * H * FS * 4, "g0 fits over h1, dh1");
    static_assert(4 * DA_MAX * TS * 4 <= PL * ACTP * 2, "dmu sums fit");
    static_assert(X % 16 == 0 && H0 % 16 == 0 && HF % 16 == 0 &&
                  U % 16 == 0 && W2 % 16 == 0, "16-byte aligned rows");
    static_assert(BYTES <= 232448, "one block's shared memory");
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

template <typename In, int XP>
__global__ void __launch_bounds__(NT, 1) fvp_ff_tc_kernel(
    const In* __restrict__ X, long long t_stride, long long d_stride,
    long long n_stride, const float* __restrict__ W0,
    const float* __restrict__ b0, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ W2,
    const float* __restrict__ scale, const float* __restrict__ v,
    float* __restrict__ partial, int T, int DO, int DA, int N) {
    using L = Smem<XP>;
    extern __shared__ __align__(16) char smem[];
    bf16* sW0 = reinterpret_cast<bf16*>(smem + L::W0);
    bf16* sdW0 = reinterpret_cast<bf16*>(smem + L::DW0);
    bf16* sW1 = reinterpret_cast<bf16*>(smem + L::W1);
    bf16* sdW1 = reinterpret_cast<bf16*>(smem + L::DW1);
    bf16* sXb = reinterpret_cast<bf16*>(smem + L::X);
    bf16* sH0 = reinterpret_cast<bf16*>(smem + L::H0);
    bf16* sDH0 = reinterpret_cast<bf16*>(smem + L::DH0);
    bf16* sG1 = sDH0;                  // dh0 is dead once dh1 is formed
    float* sMuP = reinterpret_cast<float*>(smem + L::DH0);  // [kq][m][s]
    float* sH1 = reinterpret_cast<float*>(smem + L::HF);    // [o][s]
    float* sDH1 = sH1 + H * FS;
    bf16* sG0 = reinterpret_cast<bf16*>(smem + L::HF);      // h1 is dead
    float* sU = reinterpret_cast<float*>(smem + L::U);
    float* sW2 = reinterpret_cast<float*>(smem + L::W2);
    float* sdW2 = reinterpret_cast<float*>(smem + L::DW2);
    float* sdb2 = reinterpret_cast<float*>(smem + L::C);
    float* sscale = sdb2 + DA_MAX;

    // flat parameter order (sorted keys): W0, W1, W2, b0, b1, b2, logstd
    const int oW1 = DO * H, oW2 = oW1 + H * H, ob0 = oW2 + H * DA;
    const int ob1 = ob0 + H, ob2 = ob1 + H, Pg = ob2 + DA;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    // mma roles: hidden rows 16 mt.., samples 32 nh.. (gW1: o cols 32 nh..)
    const int mt = warp & 3, nh = warp >> 2;
    // CUDA-core roles: (sample hs, outputs mq, mq + 4), (unit hs, samples
    // 16 mq..)
    const int hs = tid & 63, mq = tid >> 6;
    // ldmatrix lane addresses: rows lr, cols lc as stored; ar, ac for the
    // transposed A of W^T
    const int lr = lane & 15, lc = (lane >> 4) << 3;
    const int ar = (lane & 7) + ((lane >> 4) << 3), ac = ((lane >> 3) & 1) << 3;

    // prologue: three bf16 planes of W0, dW0 (rows past DO zero), W1, dW1
    for (int i = tid; i < XR * H; i += NT) {
        const int d = i / H, o = i % H;
        bf16 p[PL], q[PL];
        split3(d < DO ? W0[d * H + o] : 0.f, p);
        split3(d < DO ? v[d * H + o] : 0.f, q);
#pragma unroll
        for (int k = 0; k < PL; ++k) {
            sW0[k * L::W0P + d * RS + o] = p[k];
            sdW0[k * L::W0P + d * RS + o] = q[k];
        }
    }
    for (int i = tid; i < H * H; i += NT) {
        const int k = i / H, o = i % H;
        bf16 p[PL], q[PL];
        split3(W1[i], p);
        split3(v[oW1 + i], q);
#pragma unroll
        for (int j = 0; j < PL; ++j) {
            sW1[j * L::W1P + k * RS + o] = p[j];
            sdW1[j * L::W1P + k * RS + o] = q[j];
        }
    }
    for (int i = tid; i < H * DA_MAX; i += NT) {     // outputs padded
        const int k = i / DA_MAX, m = i % DA_MAX;
        sW2[i] = m < DA ? W2[k * DA + m] : 0.f;
        sdW2[i] = m < DA ? v[oW2 + k * DA + m] : 0.f;
    }
    if (tid < DA_MAX) {
        sdb2[tid] = tid < DA ? v[ob2 + tid] : 0.f;
        sscale[tid] = tid < DA ? scale[tid] : 0.f;
    }
    float w2r[DA_MAX];                 // W2[hs][.], for u W2^T
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) w2r[m] = m < DA ? W2[hs * DA + m] : 0.f;
    float bias0[2], dbias0[2], bias1[2], dbias1[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        const int r = 16 * mt + g + 8 * hf;
        bias0[hf] = b0[r];
        dbias0[hf] = v[ob0 + r];
        bias1[hf] = b1[r];
        dbias1[hf] = v[ob1 + r];
    }

    float tot1[4][4], tot0[2][4];      // gW1 (rows 16 mt.., cols 32 nh..),
    zero(tot1);                        // gW0 (rows 16 (warp & 1).., cols
    zero(tot0);                        // 16 (warp >> 1)..)
    float aW2[DA_MAX];                 // gW2[hs][.] over samples 16 mq..
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) aW2[m] = 0.f;
    float gb0[2] = {0.f, 0.f}, gb1 = 0.f, gb2[2] = {0.f, 0.f};

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
                bf16 p[PL];
                split3(xr[r], p);
#pragma unroll
                for (int q = 0; q < PL; ++q) sx[q * XR * RS + off] = p[q];
            }
        }
    };
    if (blockIdx.x < n_tiles) {
        load_x(blockIdx.x);
        store_x(0);
    }

    int buf = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += G, buf ^= 1) {
        const int n0 = (tile % tiles_per_t) * TS;
        const int ns = min(TS, N - n0);
        const bool more = tile + G < n_tiles;
        __syncthreads();        // x staged; every warp done with the last tile
        if (more) load_x(tile + G);
        const bf16* sX = sXb + buf * L::XBUF;

        {   // h0 = tanh(x W0 + b0), dh0 = (1 - h0^2)(x dW0 + db0)
            float ah[4][4], am[4][4], th[4][4], tm[4][4];
            zero(ah); zero(am); zero(th); zero(tm);
#pragma unroll
            for (int kk = 0; kk < XR / 16; ++kk) {
                uint32_t aw[PL][4], ad[PL][4], bx[2][PL][4];
#pragma unroll
                for (int p = 0; p < PL; ++p) {
                    ldmatrix_x4_trans(aw[p], sW0 + p * L::W0P + (16 * kk + ar) * RS +
                                                 16 * mt + ac);
                    ldmatrix_x4_trans(ad[p], sdW0 + p * L::W0P + (16 * kk + ar) * RS +
                                                  16 * mt + ac);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j)
#pragma unroll
                    for (int p = 0; p < XP; ++p)
                        ldmatrix_x4_trans(bx[j][p], sX + p * XR * RS +
                                                        (16 * kk + lr) * RS +
                                                        32 * nh + 16 * j + lc);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                    uint32_t b[PL][2];
                    pick<XP>(b, bx[nt >> 1], 2 * (nt & 1), 2 * (nt & 1) + 1);
                    plane_mma<PL, XP>(ah[nt], am[nt], aw, b);
                    plane_mma<PL, XP>(th[nt], tm[nt], ad, b);
                }
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    float h[2], dh[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int q = 2 * hf + e;
                        h[e] = tanhf((ah[nt][q] + am[nt][q]) + bias0[hf]);
                        dh[e] = (1.f - h[e] * h[e]) *
                                ((th[nt][q] + tm[nt][q]) + dbias0[hf]);
                    }
                    const int off = (16 * mt + g + 8 * hf) * RS + 32 * nh + 8 * nt + 2 * c;
                    store_planes2(sH0 + off, L::ACTP, h[0], h[1]);
                    store_planes2(sDH0 + off, L::ACTP, dh[0], dh[1]);
                }
        }
        __syncthreads();
        {   // h1 = tanh(h0 W1 + b1), dh1 = (1 - h1^2)(dh0 W1 + h0 dW1 + db1)
            float ah[4][4], am[4][4], th[4][4], tm[4][4];
            zero(ah); zero(am); zero(th); zero(tm);
#pragma unroll
            for (int kk = 0; kk < H / 16; ++kk) {
                uint32_t aw[PL][4], ad[PL][4];
#pragma unroll
                for (int p = 0; p < PL; ++p) {
                    ldmatrix_x4_trans(aw[p], sW1 + p * L::W1P + (16 * kk + ar) * RS +
                                                 16 * mt + ac);
                    ldmatrix_x4_trans(ad[p], sdW1 + p * L::W1P + (16 * kk + ar) * RS +
                                                  16 * mt + ac);
                }
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    uint32_t bh[PL][4], bd[PL][4];
#pragma unroll
                    for (int p = 0; p < PL; ++p) {
                        const int off = p * L::ACTP + (16 * kk + lr) * RS + 32 * nh + 16 * j + lc;
                        ldmatrix_x4_trans(bh[p], sH0 + off);
                        ldmatrix_x4_trans(bd[p], sDH0 + off);
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
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    float h[2], dh[2];
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int q = 2 * hf + e;
                        h[e] = tanhf((ah[nt][q] + am[nt][q]) + bias1[hf]);
                        dh[e] = (1.f - h[e] * h[e]) *
                                ((th[nt][q] + tm[nt][q]) + dbias1[hf]);
                    }
                    const int off = (16 * mt + g + 8 * hf) * FS + 32 * nh + 8 * nt + 2 * c;
                    *reinterpret_cast<float2*>(sH1 + off) = make_float2(h[0], h[1]);
                    *reinterpret_cast<float2*>(sDH1 + off) = make_float2(dh[0], dh[1]);
                }
        }
        __syncthreads();
        {   // dmu's partial sums over a quarter of the units: thread (sample
            // pair lane, outputs 4 (warp & 1)..+3, units 16 (warp >> 1)..)
            const int m0 = 4 * (warp & 1), kq = warp >> 1;
            float acc[2][4];
            zero(acc);
#pragma unroll
            for (int k = 16 * kq; k < 16 * kq + 16; ++k) {
                const float2 h = *reinterpret_cast<const float2*>(sH1 + k * FS + 2 * lane);
                const float2 dh = *reinterpret_cast<const float2*>(sDH1 + k * FS + 2 * lane);
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
#pragma unroll
            for (int j = 0; j < 4; ++j)
                *reinterpret_cast<float2*>(sMuP + (kq * DA_MAX + m0 + j) * TS + 2 * lane) =
                    make_float2(acc[0][j], acc[1][j]);
        }
        __syncthreads();
        // u = dmu * scale (0 on padded samples), gb2 = sum u: thread
        // (sample hs, outputs mq and mq + 4)
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
        __syncthreads();
        // thread (unit hs, samples 16 mq..): gW2 += h1^T u;
        // g1 = (u W2^T)(1 - h1^2) into g1's planes, gb1 += g1
#pragma unroll
        for (int ch = 0; ch < 2; ++ch) {
            const int s0 = 16 * mq + 8 * ch;
            const float4 ha = *reinterpret_cast<const float4*>(sH1 + hs * FS + s0);
            const float4 hb = *reinterpret_cast<const float4*>(sH1 + hs * FS + s0 + 4);
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
                gb1 += g0v;
                gb1 += g1v;
                store_planes2(sG1 + hs * RS + s0 + q, L::ACTP, g0v, g1v);
            }
        }
        __syncthreads();
        {   // g0 = (g1 W1^T)(1 - h0^2) into g0's planes, gb0 += g0
            float gh[4][4], gm[4][4];
            zero(gh); zero(gm);
#pragma unroll
            for (int kk = 0; kk < H / 16; ++kk) {
                uint32_t a[PL][4];
#pragma unroll
                for (int p = 0; p < PL; ++p)
                    ldmatrix_x4(a[p], sW1 + p * L::W1P + (16 * mt + lr) * RS + 16 * kk + lc);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    uint32_t bg[PL][4];
#pragma unroll
                    for (int p = 0; p < PL; ++p)
                        ldmatrix_x4_trans(bg[p], sG1 + p * L::ACTP + (16 * kk + lr) * RS +
                                                     32 * nh + 16 * j + lc);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        uint32_t b[PL][2];
                        pick<PL>(b, bg, 2 * e, 2 * e + 1);
                        plane_mma<PL, PL>(gh[2 * j + e], gm[2 * j + e], a, b);
                    }
                }
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    const int off = (16 * mt + g + 8 * hf) * RS + 32 * nh + 8 * nt + 2 * c;
                    const float2 h = load_planes2(sH0 + off, L::ACTP);
                    const float v0 = (gh[nt][2 * hf] + gm[nt][2 * hf]) * (1.f - h.x * h.x);
                    const float v1 =
                        (gh[nt][2 * hf + 1] + gm[nt][2 * hf + 1]) * (1.f - h.y * h.y);
                    gb0[hf] += v0;
                    gb0[hf] += v1;
                    store_planes2(sG0 + off, L::ACTP, v0, v1);
                }
        }
        {   // gW1 += h0^T g1 (this tile's sums fresh, then into the totals)
            float fh[4][4], fm[4][4];
            zero(fh); zero(fm);
#pragma unroll
            for (int ks = 0; ks < TS / 16; ++ks) {
                uint32_t a[PL][4];
#pragma unroll
                for (int p = 0; p < PL; ++p)
                    ldmatrix_x4(a[p], sH0 + p * L::ACTP + (16 * mt + lr) * RS + 16 * ks + lc);
#pragma unroll
                for (int j = 0; j < 2; ++j) {
                    uint32_t bg[PL][4];
#pragma unroll
                    for (int p = 0; p < PL; ++p)
                        ldmatrix_x4(bg[p], sG1 + p * L::ACTP + (32 * nh + 16 * j + lr) * RS +
                                               16 * ks + lc);
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        uint32_t b[PL][2];
                        pick<PL>(b, bg, e, e + 2);
                        plane_mma<PL, PL>(fh[2 * j + e], fm[2 * j + e], a, b);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) tot1[i][q] += fh[i][q] + fm[i][q];
        }
        __syncthreads();
        {   // gW0 += x^T g0: warp (d rows 16 (warp & 1).., h cols 16 (warp >> 1)..)
            float fh[2][4], fm[2][4];
            zero(fh); zero(fm);
            const int d0 = 16 * (warp & 1), h0 = 16 * (warp >> 1);
#pragma unroll
            for (int ks = 0; ks < TS / 16; ++ks) {
                uint32_t a[PL][4], bg[PL][4];
#pragma unroll
                for (int p = 0; p < XP; ++p)
                    ldmatrix_x4(a[p], sX + p * XR * RS + (d0 + lr) * RS + 16 * ks + lc);
#pragma unroll
                for (int p = 0; p < PL; ++p)
                    ldmatrix_x4(bg[p], sG0 + p * L::ACTP + (h0 + lr) * RS + 16 * ks + lc);
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
        if (more) store_x(buf ^ 1);
    }
    __syncthreads();

    // the block's partial: gW1 and gW0 straight from the fragments, the
    // rest through shared scratch (over h0's planes), summed in a fixed
    // order
    float* out = partial + (size_t)blockIdx.x * Pg;
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
    float* rW2 = reinterpret_cast<float*>(smem + L::H0);   // [mq][k][m]
    float* rB1 = rW2 + 4 * H * DA_MAX;                      // [mq][k]
    float* rB0 = rB1 + 4 * H;                               // [nh][h]
    float* rB2 = rB0 + 2 * H;                               // [m][s]
#pragma unroll
    for (int m = 0; m < DA_MAX; ++m) rW2[(mq * H + hs) * DA_MAX + m] = aW2[m];
    rB1[mq * H + hs] = gb1;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
        float s = gb0[hf];
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        if (c == 0) rB0[nh * H + 16 * mt + g + 8 * hf] = s;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) rB2[(mq + 4 * j) * TS + hs] = gb2[j];
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
        float s = 0.f;
        for (int j = 0; j < TS; ++j) s += rB2[tid * TS + j];
        out[ob2 + tid] = s;
    }
}

template <typename In, int XP>
cudaError_t occupancy(int* out) {
    constexpr int smem = Smem<XP>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        fvp_ff_tc_kernel<In, XP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fvp_ff_tc_kernel<In, XP>, NT, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fvp_ff_tc_kernel<In, XP>);
    if (err != cudaSuccess) return err;
    out[0] = blocks;
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = smem;
    out[4] = (int)fa.sharedSizeBytes;
    out[5] = NT;
    return cudaSuccess;
}

template <typename In, int XP>
cudaError_t launch(const void* X, long long t_stride, long long d_stride,
                   long long n_stride, const float* W0, const float* b0,
                   const float* W1, const float* b1, const float* W2,
                   const float* scale, const float* v, float* partial,
                   float* out, int T, int DO, int DA, int N, float damping,
                   int n_blocks, cudaStream_t st) {
    constexpr int smem = Smem<XP>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        fvp_ff_tc_kernel<In, XP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    fvp_ff_tc_kernel<In, XP><<<n_blocks, NT, smem, st>>>(
        static_cast<const In*>(X), t_stride, d_stride, n_stride, W0, b0, W1,
        b1, W2, scale, v, partial, T, DO, DA, N);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return fvp_tile::reduce(partial, v, out, n_blocks, DO, DA, damping, st);
}

}  // namespace

// X: the (T', do, N') subsample, element (t, d, n) at X[t * t_stride +
// d * d_stride + n * n_stride], bf16 when bf16 != 0, else fp32. W0 (do, 64), b0, W1
// (64, 64), b1, W2 (64, da), scale (da) = exp(-2 logstd) / B', v and out
// (P) in flat sorted-key order, all fp32 on the device; partial:
// n_blocks * (P - da) floats of scratch.
extern "C" int trpo_fvp_ff_launch(const void* X, long long t_stride,
                                  long long d_stride, long long n_stride,
                                  const float* W0, const float* b0,
                                  const float* W1, const float* b1,
                                  const float* W2, const float* scale,
                                  const float* v, float* partial, float* out,
                                  int T, int DO, int DA, int N, float damping,
                                  int n_blocks, int bf16, void* stream) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (bf16)
        return (int)launch<__nv_bfloat16, 1>(X, t_stride, d_stride, n_stride,
                                             W0, b0, W1, b1, W2, scale, v,
                                             partial, out, T, DO, DA, N,
                                             damping, n_blocks, st);
    return (int)launch<float, PL>(X, t_stride, d_stride, n_stride, W0, b0, W1,
                                  b1, W2, scale, v, partial, out, T, DO, DA,
                                  N, damping, n_blocks, st);
}

// What the card makes of the bf16 (bf16 != 0) or fp32 instantiation:
// out[0] resident blocks per SM, out[1] registers per thread, out[2] local
// (spill) bytes per thread, out[3] dynamic and out[4] static shared bytes
// per block, out[5] threads per block.
extern "C" int trpo_fvp_ff_occupancy(int bf16, int* out) {
    return (int)(bf16 ? occupancy<__nv_bfloat16, 1>(out)
                      : occupancy<float, PL>(out));
}
