// Gauss-Newton Fisher-vector product for the 2-hidden-layer tanh policy
// on batch-major samples, on the tensor cores.
//
// Replaces `make_pallas_gn_fvp` / `_fvp_kernel` (and its pair-packed twin
// `_fvp_kernel_packed`) in trpo_robot_control_tpu/ops/pallas/fvp_kernel.py.
// One pass over the (B, do) samples per CG call; the hidden activations
// h0, h1 (B, 64) are computed once per update outside and read here, not
// recomputed. Per sample, the fp32 function of the plain version:
//   forward tangent  dh0 = (1-h0^2)(x dW0 + db0)
//                    dh1 = (1-h1^2)(dh0 W1 + h0 dW1 + db1)
//                    dmu = dh1 W2 + h1 dW2 + db2
//   Fisher scaling   u   = dmu * inv_var / B
//   reverse          gW2 = h1^T u, g1 = (u W2^T)(1-h1^2), gW1 = h0^T g1,
//                    g0 = (g1 W1^T)(1-h0^2), gW0 = x^T g0 (+ bias sums)
// The logstd block 2 v and the damping are added in the reduce pass
// (fvp_tile.cuh's, shared with fvp_ff.cu, as is the split into planes).
//
// The six 64-wide products (x dW0, dh0 W1, h0 dW1, g1 W1^T, h0^T g1,
// x^T g0) run on the tensor cores as split-bf16 plane products
// (plane_mma below), exact to fp32 as K6's are; the da-wide head
// (dmu, u, gW2, u W2^T, the bias sums) runs on the CUDA cores in fp32.
// W1's planes are split once per update (trpo_fvp_split_launch), dW0's
// and dW1's once per call in a small pass ahead of the kernel; blocks copy
// them from L2 in their prologue.
//
// Layout: samples are the mma's M, hidden units its N, features its K. A
// warp owns 16 samples, so the forward products chain in registers: an
// m16n8 accumulator pair is the A fragment of the next product (dh0 ->
// dh0 W1, g1 -> g1 W1^T), split into planes in place. Only the weight
// gradients, sums over samples, cross warps: a tile is 128 samples (one
// per warp of 8), and after the forward each warp puts its g1 (then its
// g0) planes in shared memory; warp (mt, nh) then sums gW1's rows 16 mt..
// and columns 32 nh.. over the tile's samples, reading h0 from the staged
// fp32 and splitting it as it reads, and warp w sums gW0's columns
// 16 (w & 3).. the same way from x over half the tile's samples (the two
// halves added at the end). Four __syncthreads per tile. x and h0 are
// staged by cp.async into two buffers, the next tile's loads under this
// tile's products; h1, used only where each thread's fragment lies, is
// read straight from global memory a chunk ahead of its use. Each
// plane_mma call issues its products plane pair by plane pair across four
// n-tiles, so that consecutive mma.sync are independent: with two warps
// per SM sub-partition (255 registers a thread) nothing else hides the
// tensor cores' latency.
//
// What bounds it on an H100: at c2 (B' = 25,600, do 12, da 3) the
// function is 18.7k MACs a sample, 0.96 GFLOP (0.001 ms at the 989
// TFLOP/s bf16 peak), its inputs 14.3 MB (0.0043 ms at 3.35 TB/s), so the
// bytes bound it. The six plane products make it 5.7 GFLOP of mma.sync,
// and at two warps per sub-partition their latency, the ldmatrix of the
// weights' planes (~78 KB a warp and tile) and the splits set its time;
// PERF.md has the measurements. One block of 8 warps per SM (~206 KB of
// shared memory), a grid of at most 132 blocks: c2's 200 tiles take two
// rounds on 68 SMs, c1's 25 tiles one round on 25 SMs.
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
constexpr int PL = 3;          // planes of an fp32 operand: hi, mid, lo
constexpr int NW = 8;          // warps per block
constexpr int NT = 32 * NW;    // threads per block
constexpr int SW = 16;         // samples per warp: the mma's M
constexpr int TS = NW * SW;    // samples per tile
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int RS = H + 8;      // bf16 row stride of the plane tiles: 144 B,
                               // so the 8 rows of an ldmatrix hit distinct
                               // bank groups
constexpr int HS = H + 4;      // fp32 row stride of the staged h0
constexpr unsigned FULL = 0xffffffffu;

using fvp_tile::split3;
using fvp_tile::split_pair;
using fvp_tile::zero;

// shared memory, byte offsets; XT k-steps of x (do <= 16 XT), DT head
// outputs (da <= DT)
template <int XT, int DT>
struct Smem {
    static constexpr int XR = 16 * XT;               // dW0's rows, zero past do
    static constexpr int W1P = H * RS;               // bf16 elements a plane
    static constexpr int W0P = XR * RS;
    static constexpr int EXP = SW * RS;              // a warp's exchange plane
    static constexpr int STG = SW * XR + SW * HS;    // a warp's staged floats
    static constexpr int W1 = 0;                     // 3 x (H, RS) [k][o]
    static constexpr int DW1 = W1 + PL * W1P * 2;
    static constexpr int DW0 = DW1 + PL * W1P * 2;   // 3 x (XR, RS) [d][h]
    static constexpr int EX = DW0 + PL * W0P * 2;    // [warp][3][s][RS]: g1, g0
    static constexpr int ST = EX + NW * PL * EXP * 2;   // [buf][warp]: x [s][do]
                                                        // then h0 [s][HS]
    static constexpr int W2 = ST + 2 * NW * STG * 4;    // W2 [o][DT] fp32
    static constexpr int DW2 = W2 + H * DT * 4;
    static constexpr int B01 = DW2 + H * DT * 4;     // db0, db1
    static constexpr int C = B01 + 2 * H * 4;        // db2, scale
    static constexpr int BYTES = C + 2 * DT * 4;
    static_assert(DW0 % 16 == 0 && EX % 16 == 0 && ST % 16 == 0 &&
                  (STG * 4) % 16 == 0 && (SW * XR * 4) % 16 == 0 &&
                  W2 % 16 == 0, "16-byte aligned tiles");
    static_assert(NW * H * DT + 2 * NW * H + NW * DT + 2 * XR * H <= 2 * NW * STG,
                  "the final sums fit over the staging buffers");
    static_assert(BYTES <= 232448, "one block's shared memory");
};

template <int R, int C, int D>
__device__ __forceinline__ void zero3(float (&a)[R][C][D]) {
#pragma unroll
    for (int i = 0; i < R; ++i) zero(a[i]);
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

template <int XT, int DT>
__global__ void __launch_bounds__(NT, 1) fvp_tc_kernel(
    const float* __restrict__ X, const float* __restrict__ H0,
    const float* __restrict__ H1, const bf16* __restrict__ W1p,
    const bf16* __restrict__ Vp, const float* __restrict__ W2,
    const float* __restrict__ scale, const float* __restrict__ v,
    float* __restrict__ partial, int B, int DO, int DA) {
    using L = Smem<XT, DT>;
    constexpr int XR = L::XR;
    extern __shared__ __align__(16) char smem[];
    bf16* sW1 = reinterpret_cast<bf16*>(smem + L::W1);
    bf16* sdW1 = reinterpret_cast<bf16*>(smem + L::DW1);
    bf16* sdW0 = reinterpret_cast<bf16*>(smem + L::DW0);
    bf16* sEx = reinterpret_cast<bf16*>(smem + L::EX);
    float* sSt = reinterpret_cast<float*>(smem + L::ST);
    float* sW2 = reinterpret_cast<float*>(smem + L::W2);
    float* sdW2 = reinterpret_cast<float*>(smem + L::DW2);
    float* sdb0 = reinterpret_cast<float*>(smem + L::B01);
    float* sdb1 = sdb0 + H;
    float* sdb2 = reinterpret_cast<float*>(smem + L::C);
    float* sscale = sdb2 + DT;

    // flat parameter order (sorted keys): W0, W1, W2, b0, b1, b2, logstd
    const int oW1 = DO * H, oW2 = oW1 + H * H, ob0 = oW2 + H * DA;
    const int ob1 = ob0 + H, ob2 = ob1 + H, Pg = ob2 + DA;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, c = lane & 3;
    // ldmatrix lane addresses: rows lr, cols lc
    const int lr = lane & 15, lc = (lane >> 4) << 3;
    // gW1 role: rows k 16 mt.., columns o 32 nh..
    const int mt = warp & 3, nh = warp >> 2;

    // prologue: the planes of W1 (per update), dW1 and dW0 (per call; rows
    // of dW0 past DO zero) from L2; the head's fp32 operands
    const int VP = (DO + H) * H;       // a plane of v's W0 and W1 blocks
    for (int i = tid; i < PL * H * 8; i += NT) {
        const int p = i / (H * 8), r = (i >> 3) % H, q = i & 7;
        cp_async16(sW1 + p * L::W1P + r * RS + 8 * q,
                   W1p + (p * H + r) * H + 8 * q, 16);
        cp_async16(sdW1 + p * L::W1P + r * RS + 8 * q,
                   Vp + p * VP + (DO + r) * H + 8 * q, 16);
    }
    for (int i = tid; i < PL * XR * 8; i += NT) {
        const int p = i / (XR * 8), r = (i >> 3) % XR, q = i & 7;
        const bool ok = r < DO;
        cp_async16(sdW0 + p * L::W0P + r * RS + 8 * q,
                   Vp + p * VP + (ok ? r : 0) * H + 8 * q, ok ? 16 : 0);
    }
    for (int i = tid; i < H * DT; i += NT) {          // outputs padded
        const int k = i / DT, m = i % DT;
        sW2[i] = m < DA ? W2[k * DA + m] : 0.f;
        sdW2[i] = m < DA ? v[oW2 + k * DA + m] : 0.f;
    }
    if (tid < H) {
        sdb0[tid] = v[ob0 + tid];
        sdb1[tid] = v[ob1 + tid];
    }
    if (tid < DT) {
        sdb2[tid] = tid < DA ? v[ob2 + tid] : 0.f;
        sscale[tid] = tid < DA ? scale[tid] : 0.f;
    }

    const int n_tiles = (B + TS - 1) / TS;
    const int G = gridDim.x;
    // this warp's x (16 rows of DO floats, contiguous in X) and h0 of a
    // tile into staging buffer b; rows past B are zero
    auto stage = [&](int tile, int b) {
        float* sx = sSt + (b * NW + warp) * L::STG;
        float* sh = sx + SW * XR;
        const int s0 = tile * TS + warp * SW;
        const int ns = max(0, min(SW, B - s0));
        const int xbytes = ns * DO * 4;
        const char* xsrc = reinterpret_cast<const char*>(X + (size_t)s0 * DO);
        for (int q = lane; q < 4 * DO; q += 32) {
            const int nb = min(16, max(0, xbytes - 16 * q));
            cp_async16(sx + 4 * q, nb > 0 ? xsrc + 16 * q : (const char*)X, nb);
        }
        const float* hsrc = H0 + (size_t)s0 * H;
#pragma unroll
        for (int i = 0; i < SW * 16 / 32; ++i) {
            const int q = lane + 32 * i, r = q >> 4, k = q & 15;
            cp_async16(sh + r * HS + 4 * k, r < ns ? hsrc + r * H + 4 * k : H0,
                       r < ns ? 16 : 0);
        }
    };

    float tot1[4][4];                  // gW1 rows 16 mt.., cols 32 nh..
    float tot0[XT][2][4];              // gW0 rows 16 mi.., cols 16 (warp & 3)..,
    zero(tot1);                        // this warp's half of the samples
    zero3(tot0);
    float aW2[2][DT];                  // gW2 rows 8 g + 2 c + e, this warp's
    zero(aW2);                         // samples
    float gb0[2] = {0.f, 0.f}, gb1[2] = {0.f, 0.f};   // the same rows
    float gb2[(DT + 3) / 4];           // outputs c + 4 j, this lane's rows
#pragma unroll
    for (int j = 0; j < (DT + 3) / 4; ++j) gb2[j] = 0.f;

    if (blockIdx.x < n_tiles) stage(blockIdx.x, 0);
    cp_async_commit();

    int buf = 0;
    for (int tile = blockIdx.x; tile < n_tiles; tile += G, buf ^= 1) {
        cp_async_wait<0>();
        __syncthreads();   // staged tile visible; the last tile's reads done
        if (tile + G < n_tiles) stage(tile + G, buf ^ 1);
        cp_async_commit();
        const float* sx = sSt + (buf * NW + warp) * L::STG;
        const float* sh = sx + SW * XR;
        const int s0 = tile * TS + warp * SW;
        const int ns = max(0, min(SW, B - s0));
        bf16* ex = sEx + warp * PL * L::EXP;
        float g0v[8][4];               // g0 in the accumulator layout

        {   // the forward and the head over this warp's 16 samples; padding
            // rows (a warp past B has 16) get u = 0, so g1 = g0 = 0 there
            // ---- dh0 = (1 - h0^2)(x dW0 + db0), into its planes as the A
            // fragments of the next product (k-step kk: n-tiles 2 kk, 2 kk + 1)
            uint32_t adh0[4][PL][4];
            {
                float hi[2][4][4], ml[2][4][4];    // n-tiles 4 hh + i
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
                    for (int hh = 0; hh < 2; ++hh) {   // n-tiles 4 hh..
                        uint32_t r[2][PL][4];
#pragma unroll
                        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
                            for (int pl = 0; pl < PL; ++pl)
                                ldmatrix_x4_trans(r[pp][pl], sdW0 + pl * L::W0P +
                                                                 (16 * kk + lr) * RS +
                                                                 32 * hh + 16 * pp + lc);
                        plane_mma<4, true>(hi[hh], ml[hh], ax, r);
                    }
                }
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    const int h = 8 * nt + 2 * c;
                    const float2 db = *reinterpret_cast<const float2*>(sdb0 + h);
                    const float(&th)[4] = hi[nt >> 2][nt & 3];
                    const float(&tm)[4] = ml[nt >> 2][nt & 3];
                    float d[4];
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const float2 hv = *reinterpret_cast<const float2*>(
                            sh + (g + 8 * hf) * HS + h);
                        d[2 * hf] = (1.f - hv.x * hv.x) *
                                    ((th[2 * hf] + tm[2 * hf]) + db.x);
                        d[2 * hf + 1] = (1.f - hv.y * hv.y) *
                                        ((th[2 * hf + 1] + tm[2 * hf + 1]) + db.y);
                    }
                    const int kk = nt >> 1, j = 2 * (nt & 1);
                    split_pair(d[0], d[1], adh0[kk][0][j], adh0[kk][1][j],
                               adh0[kk][2][j]);
                    split_pair(d[2], d[3], adh0[kk][0][j + 1],
                               adh0[kk][1][j + 1], adh0[kk][2][j + 1]);
                }
            }

            // ---- dh1 = (1 - h1^2)(dh0 W1 + h0 dW1 + db1), 32 columns at a
            // time; dmu's partial sums over this lane's columns
            float h1v[8][4];           // h1 in the accumulator layout
            float dmu[2][DT];
            zero(dmu);
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        const int r = g + 8 * hf, o = 8 * (4 * ch + i) + 2 * c;
                        float2 x = make_float2(0.f, 0.f);
                        if (r < ns)
                            x = __ldg(reinterpret_cast<const float2*>(
                                H1 + (size_t)(s0 + r) * H + o));
                        h1v[4 * ch + i][2 * hf] = x.x;
                        h1v[4 * ch + i][2 * hf + 1] = x.y;
                    }
                float hi[4][4], ml[4][4];
                zero(hi);
                zero(ml);
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    uint32_t ah[PL][4];    // h0's planes, split as staged
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const float2 hv = *reinterpret_cast<const float2*>(
                            sh + (g + 8 * (q & 1)) * HS + 16 * kk + 2 * c +
                            8 * (q >> 1));
                        split_pair(hv.x, hv.y, ah[0][q], ah[1][q], ah[2][q]);
                    }
                    // dh0 W1, then h0 dW1, over the chunk's four n-tiles
#pragma unroll
                    for (int term = 0; term < 2; ++term) {
                        const bf16* w = term == 0 ? sW1 : sdW1;
                        uint32_t r[2][PL][4];
#pragma unroll
                        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
                            for (int pl = 0; pl < PL; ++pl)
                                ldmatrix_x4_trans(r[pp][pl], w + pl * L::W1P +
                                                                 (16 * kk + lr) * RS +
                                                                 32 * ch + 16 * pp + lc);
                        plane_mma<4, true>(hi, ml, term == 0 ? adh0[kk] : ah, r);
                    }
                }
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const int nt = 4 * ch + i;
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int o = 8 * nt + 2 * c + e;
                        const float db = sdb1[o];
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
                            const float h = h1v[nt][q];
                            const float dh = (1.f - h * h) * ((hi[i][q] + ml[i][q]) + db);
#pragma unroll
                            for (int m = 0; m < DT; ++m)
                                dmu[hf][m] = fmaf(h, dw[m], fmaf(dh, w[m], dmu[hf][m]));
                        }
                    }
                }
            }

            // ---- u = (dmu + db2) * scale (0 on padded samples): the quad's
            // four column shares summed; every lane of the quad gets the same
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
            // gW2 += h1^T u, over the warp's rows, lane g keeping rows
            // 8 g + 2 c + e
#pragma unroll
            for (int m = 0; m < DT; ++m) {
                if (m >= DA) break;
                float t[16];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e)
                        t[2 * nt + e] = fmaf(h1v[nt][2 + e], u[1][m],
                                             h1v[nt][e] * u[0][m]);
                const float2 r = reduce_scatter16(t, g);
                aW2[0][m] += r.x;
                aW2[1][m] += r.y;
            }
            // g1 = (u W2^T)(1 - h1^2): its planes as the A fragments of
            // g1 W1^T and into the exchange; gb1
            uint32_t ag1[4][PL][4];
            {
                float cs[16];
#pragma unroll
                for (int nt = 0; nt < 8; ++nt) {
                    float gv[4];
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
                            const float h = h1v[nt][2 * hf + e];
                            gv[2 * hf + e] = s * (1.f - h * h);
                        }
                        cs[2 * nt + e] = gv[e] + gv[2 + e];
                    }
                    const int kk = nt >> 1, j = 2 * (nt & 1);
#pragma unroll
                    for (int hf = 0; hf < 2; ++hf) {
                        uint32_t (&a)[PL][4] = ag1[kk];
                        split_pair(gv[2 * hf], gv[2 * hf + 1], a[0][j + hf],
                                   a[1][j + hf], a[2][j + hf]);
#pragma unroll
                        for (int pl = 0; pl < PL; ++pl)
                            *reinterpret_cast<uint32_t*>(
                                ex + pl * L::EXP + (g + 8 * hf) * RS + 8 * nt + 2 * c) =
                                a[pl][j + hf];
                    }
                }
                const float2 r = reduce_scatter16(cs, g);
                gb1[0] += r.x;
                gb1[1] += r.y;
            }

            // ---- g0 = (g1 W1^T)(1 - h0^2), 32 columns at a time; gb0
            {
                float cs[16];
#pragma unroll
                for (int ch = 0; ch < 2; ++ch) {
                    float hi[4][4], ml[4][4];
                    zero(hi);
                    zero(ml);
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        uint32_t r[2][PL][4];
#pragma unroll
                        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
                            for (int pl = 0; pl < PL; ++pl)
                                ldmatrix_x4(r[pp][pl], sW1 + pl * L::W1P +
                                                           (32 * ch + 16 * pp + lr) * RS +
                                                           16 * kk + lc);
                        plane_mma<4, false>(hi, ml, ag1[kk], r);
                    }
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const int nt = 4 * ch + i, k = 8 * nt + 2 * c;
#pragma unroll
                        for (int hf = 0; hf < 2; ++hf) {
                            const float2 hv = *reinterpret_cast<const float2*>(
                                sh + (g + 8 * hf) * HS + k);
                            g0v[nt][2 * hf] = (hi[i][2 * hf] + ml[i][2 * hf]) *
                                              (1.f - hv.x * hv.x);
                            g0v[nt][2 * hf + 1] =
                                (hi[i][2 * hf + 1] + ml[i][2 * hf + 1]) *
                                (1.f - hv.y * hv.y);
                        }
#pragma unroll
                        for (int e = 0; e < 2; ++e)
                            cs[2 * nt + e] = g0v[nt][e] + g0v[nt][2 + e];
                    }
                }
                const float2 r = reduce_scatter16(cs, g);
                gb0[0] += r.x;
                gb0[1] += r.y;
            }
        }
        __syncthreads();   // every warp's g1 planes in the exchange

        {   // gW1 += h0^T g1 over the tile (fresh sums, then into the totals)
            float fh[4][4], fm[4][4];
            zero(fh);
            zero(fm);
#pragma unroll
            for (int j = 0; j < NW; ++j) {        // k-step: warp j's samples
                const float* shj = sSt + (buf * NW + j) * L::STG + SW * XR;
                const bf16* exj = sEx + j * PL * L::EXP;
                uint32_t a[PL][4];
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int k = 16 * mt + g + 8 * (q & 1);
                    const int s = 2 * c + 8 * (q >> 1);
                    split_pair(shj[s * HS + k], shj[(s + 1) * HS + k], a[0][q],
                               a[1][q], a[2][q]);
                }
                uint32_t r[2][PL][4];
#pragma unroll
                for (int qq = 0; qq < 2; ++qq)
#pragma unroll
                    for (int pl = 0; pl < PL; ++pl)
                        ldmatrix_x4_trans(r[qq][pl], exj + pl * L::EXP + lr * RS +
                                                         32 * nh + 16 * qq + lc);
                plane_mma<4, true>(fh, fm, a, r);
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int q = 0; q < 4; ++q) tot1[i][q] += fh[i][q] + fm[i][q];
        }
        __syncthreads();   // every warp done with the g1 planes
        {   // this warp's g0 planes into the exchange
#pragma unroll
            for (int nt = 0; nt < 8; ++nt)
#pragma unroll
                for (int hf = 0; hf < 2; ++hf) {
                    uint32_t p[PL];
                    split_pair(g0v[nt][2 * hf], g0v[nt][2 * hf + 1], p[0], p[1],
                               p[2]);
#pragma unroll
                    for (int pl = 0; pl < PL; ++pl)
                        *reinterpret_cast<uint32_t*>(
                            ex + pl * L::EXP + (g + 8 * hf) * RS + 8 * nt + 2 * c) = p[pl];
                }
        }
        __syncthreads();   // every warp's g0 planes in the exchange

        {   // gW0 += x^T g0 over half the tile: warp w, columns 16 (w & 3)..,
            // the samples of warps j = w >> 2, + 2, ...
            float fh[XT][2][4], fm[XT][2][4];
            zero3(fh);
            zero3(fm);
#pragma unroll
            for (int j = warp >> 2; j < NW; j += 2) {
                const float* sxj = sSt + (buf * NW + j) * L::STG;
                const bf16* exj = sEx + j * PL * L::EXP;
                uint32_t r[1][PL][4];
#pragma unroll
                for (int pl = 0; pl < PL; ++pl)
                    ldmatrix_x4_trans(r[0][pl], exj + pl * L::EXP + lr * RS +
                                                    16 * (warp & 3) + lc);
#pragma unroll
                for (int mi = 0; mi < XT; ++mi) {
                    uint32_t a[PL][4];
#pragma unroll
                    for (int q = 0; q < 4; ++q) {
                        const int d = 16 * mi + g + 8 * (q & 1);
                        const int s = 2 * c + 8 * (q >> 1);
                        const bool ok = d < DO;
                        split_pair(ok ? sxj[s * DO + d] : 0.f,
                                   ok ? sxj[(s + 1) * DO + d] : 0.f, a[0][q],
                                   a[1][q], a[2][q]);
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
    }
    cp_async_wait<0>();
    __syncthreads();

    // the block's partial: gW1 straight from the fragments; gW0's two
    // halves, gW2 and the bias sums through shared scratch (over the
    // staging buffers), summed over the warps in order
    float* out = partial + (size_t)blockIdx.x * Pg;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
            const int k = 16 * mt + g + 8 * hf, o = 32 * nh + 8 * nt + 2 * c;
            out[oW1 + k * H + o] = tot1[nt][2 * hf];
            out[oW1 + k * H + o + 1] = tot1[nt][2 * hf + 1];
        }
    float* rW2 = sSt;                  // [warp][o][DT]
    float* rB0 = rW2 + NW * H * DT;    // [warp][o]
    float* rB1 = rB0 + NW * H;
    float* rB2 = rB1 + NW * H;         // [warp][m]
    float* rW0 = rB2 + NW * DT;        // [half][d][h]
#pragma unroll
    for (int mi = 0; mi < XT; ++mi)
#pragma unroll
        for (int t = 0; t < 2; ++t)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
                const int d = 16 * mi + g + 8 * hf;
                const int h = 16 * (warp & 3) + 8 * t + 2 * c;
                float* o = rW0 + ((warp >> 2) * XR + d) * H + h;
                o[0] = tot0[mi][t][2 * hf];
                o[1] = tot0[mi][t][2 * hf + 1];
            }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
        const int o = 8 * g + 2 * c + e;
#pragma unroll
        for (int m = 0; m < DT; ++m) rW2[(warp * H + o) * DT + m] = aW2[e][m];
        rB0[warp * H + o] = gb0[e];
        rB1[warp * H + o] = gb1[e];
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
    for (int e = tid; e < DO * H; e += NT) out[e] = rW0[e] + rW0[XR * H + e];
    for (int e = tid; e < H * DA; e += NT) {
        const int k = e / DA, m = e % DA;
        float s = rW2[k * DT + m];
        for (int w = 1; w < NW; ++w) s += rW2[(w * H + k) * DT + m];
        out[oW2 + e] = s;
    }
    if (tid < H) {
        float s0 = rB0[tid], s1 = rB1[tid];
        for (int w = 1; w < NW; ++w) {
            s0 += rB0[w * H + tid];
            s1 += rB1[w * H + tid];
        }
        out[ob0 + tid] = s0;
        out[ob1 + tid] = s1;
    }
    if (tid < DA) {
        float s = rB2[tid];
        for (int w = 1; w < NW; ++w) s += rB2[w * DT + tid];
        out[ob2 + tid] = s;
    }
}

template <int XT, int DT>
cudaError_t occupancy(int* out) {
    constexpr int smem = Smem<XT, DT>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        fvp_tc_kernel<XT, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    int blocks = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, fvp_tc_kernel<XT, DT>, NT, smem);
    if (err != cudaSuccess) return err;
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fvp_tc_kernel<XT, DT>);
    if (err != cudaSuccess) return err;
    out[0] = blocks;
    out[1] = fa.numRegs;
    out[2] = (int)fa.localSizeBytes;
    out[3] = smem;
    out[4] = (int)fa.sharedSizeBytes;
    out[5] = NT;
    return cudaSuccess;
}

template <int XT, int DT>
cudaError_t launch(const float* X, const float* h0, const float* h1,
                   const bf16* W1p, const bf16* Vp, const float* W2,
                   const float* scale, const float* v, float* partial, int B,
                   int DO, int DA, int n_blocks, cudaStream_t st) {
    constexpr int smem = Smem<XT, DT>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        fvp_tc_kernel<XT, DT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    fvp_tc_kernel<XT, DT><<<n_blocks, NT, smem, st>>>(
        X, h0, h1, W1p, Vp, W2, scale, v, partial, B, DO, DA);
    return cudaGetLastError();
}

}  // namespace

// W1's three bf16 planes (3, 64, 64) from W1 (64, 64) fp32, once per
// update; every CG call's launch reads them.
extern "C" int trpo_fvp_split_launch(const float* W1, void* planes,
                                     void* stream) {
    return (int)split(W1, static_cast<bf16*>(planes), H * H,
                      static_cast<cudaStream_t>(stream));
}

// X (B, do), h0/h1 (B, 64), W1p: W1's planes from trpo_fvp_split_launch,
// W2 (64, da), scale (da) = exp(-2 logstd) / B, v and out (P) in flat
// sorted-key order, all on the device; vplanes: 3 (do + 64) 64 bf16 and
// partial: n_blocks * (P - da) floats of scratch. Launches the split of
// v's W0 and W1 blocks, the kernel and the reduce pass.
extern "C" int trpo_fvp_launch(const float* X, const float* h0,
                               const float* h1, const void* W1p,
                               const float* W2, const float* scale,
                               const float* v, void* vplanes, float* partial,
                               float* out, int B, int DO, int DA,
                               float damping, int n_blocks, void* stream) {
    if (B < 1 || n_blocks < 1 || DO < 1 || DO > DO_MAX || DA < 1 ||
        DA > DA_MAX)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    bf16* Vp = static_cast<bf16*>(vplanes);
    cudaError_t err = split(v, Vp, (DO + H) * H, st);
    if (err != cudaSuccess) return (int)err;
    const bf16* w1p = static_cast<const bf16*>(W1p);
    if (DO <= 16)
        err = DA <= 4 ? launch<1, 4>(X, h0, h1, w1p, Vp, W2, scale, v, partial,
                                     B, DO, DA, n_blocks, st)
                      : launch<1, 8>(X, h0, h1, w1p, Vp, W2, scale, v, partial,
                                     B, DO, DA, n_blocks, st);
    else
        err = DA <= 4 ? launch<2, 4>(X, h0, h1, w1p, Vp, W2, scale, v, partial,
                                     B, DO, DA, n_blocks, st)
                      : launch<2, 8>(X, h0, h1, w1p, Vp, W2, scale, v, partial,
                                     B, DO, DA, n_blocks, st);
    if (err != cudaSuccess) return (int)err;
    const int Pg = DO * H + H * H + H * DA + 2 * H + DA;
    return (int)fvp_tile::reduce(partial, v, out, n_blocks, Pg, Pg + DA,
                                 damping, st);
}

// What the card makes of the instantiation for (do, da): out[0] resident
// blocks per SM, out[1] registers per thread, out[2] local (spill) bytes
// per thread, out[3] dynamic and out[4] static shared bytes per block,
// out[5] threads per block.
extern "C" int trpo_fvp_occupancy(int DO, int DA, int* out) {
    if (DO < 1 || DO > DO_MAX || DA < 1 || DA > DA_MAX)
        return (int)cudaErrorInvalidValue;
    if (DO <= 16)
        return (int)(DA <= 4 ? occupancy<1, 4>(out) : occupancy<1, 8>(out));
    return (int)(DA <= 4 ? occupancy<2, 4>(out) : occupancy<2, 8>(out));
}
