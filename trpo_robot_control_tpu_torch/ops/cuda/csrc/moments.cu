// Baseline normal-equation moments: one read of obs_ff, one extended Gram.
//
// Replaces `pallas_baseline_moments` / `_moments_kernel` in
// trpo_robot_control_tpu/ops/pallas/moments_kernel.py (fp32 and bf16
// storage). Per sample (t, n) the kernel forms
//     v_ext = [obs; obs^2; y; tau_t]        (R = 2 do + 5 values)
// and accumulates the symmetric R x R Gram sum v_ext v_ext^T in fp32. Its
// blocks give every moment of the ridge fit; the caller assembles (A, b)
// and the exact A_tt = N tau^T tau outside, as the TPU wrapper does. In
// bf16 mode obs is read as stored (bf16), obs^2 and y are rounded to bf16
// (as the JAX package's normal_eq_ff rounds them) and tau stays fp32.
//
// fp32 mode (c1, c2) is bound by bytes on an H100: it reads 5.3 MB at c2
// (~1.6 us at 3.35 TB/s) against 44.5 M fp32 FMA of upper triangle (~1.3
// us at 67 TFLOP/s). One launch does it all. A tile is F32_S = 128
// consecutive samples of the flattened (t, n) axis (a ragged N wastes
// nothing), staged in shared memory sample-major (an odd number of float4
// groups a sample, so a float4 column walk hits distinct banks). obs, y
// and tau arrive by 4-byte cp.async in a ring of F32_NS tiles, so three
// tiles' loads are in flight while one's products run; the
// thread that copied a sample's obs rows then forms their squares. The
// products are register-blocked: a thread owns a 4 x 4 block (I, J),
// I <= J, of the Gram's upper block triangle and a 1/KS share of every
// tile's samples, and per sample reads two float4 (rows 4I.., 4J..) for
// 16 FMA; each tile's products go into fresh accumulators, added to
// running totals (a small tile sum loses less to rounding than one
// product added at a time to a large total). The grid fills the card once
// with an equal share of tiles a block, at most F32_GRID blocks, a fixed
// number, so the bits do not depend on the card. The cross-block sum
// follows in the same launch, in a fixed order: each block adds its KS
// shares in share order and writes its partial; the last block of each
// group of F32_GROUP (a ticket) sums the group's partials in block order,
// and the last group to finish sums the group sums in group order into the
// Gram, each sum's loads all issued before its adds. The tickets are a
// __device__ array (f32_tickets), zero when the library loads on a device;
// each last block resets its ticket, so the next launch, or a CUDA graph's
// replay, finds them 0. Two fp32-mode launches on one device therefore
// must not run at the same time (the train step issues one at a time, on
// one stream).
//
// bf16 mode (c3-c5) is bound by bytes too, once its products run on the
// tensor cores: every data operand is a bf16 value (obs as stored, obs^2
// and y rounded), a bf16 x bf16 product is exact in fp32, so
// mma.sync m16n8k16 (bf16 in, fp32 accumulate) forms the same products.
// At c5 it reads 760 MB (0.23 ms at 3.35 TB/s) for 46 GFLOP of upper
// triangle (0.05 ms at 989 TFLOP/s); the old design summed them as fp32
// FMA from shared memory and lost to one torch.matmul. A tile is one step
// t and ST = 256 envs, staged in shared memory as rows
// [obs; bf16(obs^2); bf16(y); ones; zeros] (64 rows, 80 at do = 32),
// sample-contiguous with a 16-byte row pad so ldmatrix hits distinct
// banks. The obs rows and y arrive by cp.async in a ring of NS stages, so
// the loads of the next two tiles are in flight while this one's products
// run; the threads then form the obs^2 (bf16x2 multiplies: the exact
// product rounded once, as __float2bfloat16_rn rounds the fp32 one), y and
// ones rows. One ldmatrix.x4 of a 16-row block gives both an A fragment
// and the B fragments of its two 8-row halves (the Gram is V V^T: B is V
// read as "col"). Only the 16 x 8 fragments that touch the upper
// triangle of the first NB column blocks (8 NB >= 2 do + 2: 16 fragments
// at c3-c5) are issued, split between two warp groups (even and odd
// fragments); the four warps of a group take a quarter of the tile's
// samples each. Each tile's products go into accumulators set by the
// tile's first mma and are then added in fp32 to per-thread running
// totals: the two-level sum of fp32 mode. tau is not in the tile: the
// ones column gives each tile's row sums s_a, and an fp32 epilogue adds
// tau_k(t) s_a into the v x tau block and tau_k tau_l c (c the tile's
// valid envs) into the tau x tau block, so tau is never rounded to bf16.
//
// bf16 mode writes per-block partials and a second launch sums them in a
// fixed order. Neither mode uses float atomics, so the result is
// bit-identical from call to call.
//
// C interface (ctypes); returns cudaGetLastError() after the launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "mma_bf16.cuh"

namespace {

constexpr int NT = 256;                 // threads per block
constexpr int DO_MAX = 32;
constexpr int R_MAX = 2 * DO_MAX + 5;
constexpr int RED_OUT = 32;             // outputs per reduce block
constexpr int RED_GROUPS = NT / RED_OUT;
constexpr int SMEM_MAX = 232448;        // a block's shared memory on sm_90

// upper-triangle entry e -> (a, b), a <= b, row-major
__device__ __forceinline__ void entry(int e, int R, int& a, int& b) {
    a = 0;
    while (e >= R - a) {
        e -= R - a;
        ++a;
    }
    b = a + e;
}

// ---------------------------------------------------------------- fp32 mode

constexpr int F32_S = 128;                   // samples per tile
constexpr int F32_NS = 4;                    // cp.async ring stages
constexpr int F32_GRID = 132;                // most blocks (fixed)
constexpr int F32_GROUP = 8;                 // blocks a first-level sum
constexpr int F32_TOP = (F32_GRID + F32_GROUP - 1) / F32_GROUP;  // groups
constexpr int RB_MAX = (R_MAX + 3) / 4;      // 4-row groups of v_ext
constexpr int F32_SMEM = F32_NS * F32_S * 4 * (RB_MAX | 1) * 4;  // bytes

// the cross-block sum's tickets: one a group, then the groups' own; zero at
// load, and left zero by every launch
__device__ unsigned int f32_tickets[F32_TOP + 1];

// fp32 mode's dynamic shared memory, indexed directly (a generic pointer
// into it would cost generic loads): F32_NS stages of F32_S samples x RP
// floats, sample-major; after the tiles, the KS shares' totals of every
// 4 x 4 block
extern __shared__ float4 f32_smem4[];
__device__ __forceinline__ float& f32_smem(int i) {
    return reinterpret_cast<float*>(f32_smem4)[i];
}

// 4 bytes global -> shared float i; ok false writes a zero, reads nothing
__device__ __forceinline__ void f32_cp_async(int i, const float* src,
                                             bool ok) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_addr(&f32_smem(i))),
                 "l"(src), "r"(ok ? 4 : 0)
                 : "memory");
}
template <int N>
__device__ __forceinline__ void f32_cp_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Tile `tile`'s sample s into stage `stage` (row base `row`): obs rows
// d = half, half + 2, ..., y (d = DO) and, for half 1, tau; one commit
// group, empty past the last tile.
__device__ __forceinline__ void f32_issue(
    const float* __restrict__ obs, const float* __restrict__ y,
    const float* __restrict__ tau, int tile, int n_tiles, unsigned total,
    int N, int DO, int s, int half, int row) {
    if (tile < n_tiles) {
        const unsigned q = (unsigned)tile * F32_S + s;
        const bool ok = q < total;
        const unsigned t = ok ? q / (unsigned)N : 0u;
        const unsigned n = ok ? q - t * (unsigned)N : 0u;
        for (int d = half; d <= DO; d += 2) {
            if (d < DO)
                f32_cp_async(row + d, obs + ((size_t)t * DO + d) * N + n, ok);
            else
                f32_cp_async(row + 2 * DO, y + (ok ? q : 0u), ok);
        }
        if (half == 1)
#pragma unroll
            for (int k = 0; k < 4; ++k)
                f32_cp_async(row + 2 * DO + 1 + k, tau + t * 4 + k, ok);
    }
    cp_async_commit();
}

__global__ void __launch_bounds__(NT, 1) moments_fp32_kernel(
    const float* __restrict__ obs, const float* __restrict__ y,
    const float* __restrict__ tau, float* __restrict__ partial,
    float* __restrict__ gram, int T, int DO, int N) {
    unsigned int* tickets = f32_tickets;
    __shared__ bool last;
    const int R = 2 * DO + 5;
    const int E = R * (R + 1) / 2;
    const int RB = (R + 3) / 4;             // 4-row groups of v_ext
    const int RG = RB | 1;                  // odd: a float4 column walk
    const int RP = 4 * RG;                  // hits distinct banks
    const int NBT = RB * (RB + 1) / 2;
    const int KS = NT / NBT;
    const int tid = threadIdx.x;
    const unsigned total = (unsigned)T * (unsigned)N;   // < 2^31
    const int n_tiles = (int)((total + F32_S - 1) / F32_S);

    // this thread's 4 x 4 block (I, J) of the upper block triangle, and its
    // share of each tile's samples
    const int bt = tid % NBT, ks = tid / NBT;
    const bool comp = ks < KS;
    int I = 0, J = bt;
    while (J >= RB - I) {
        J -= RB - I;
        ++I;
    }
    J += I;
    float run[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) run[e] = 0.f;

    // staging: sample s, its rows d = half, half + 2, ... (f32_issue); the
    // same thread then forms the squares of its obs rows
    const int s = tid % F32_S, half = tid / F32_S;
    for (int e = tid; e < F32_NS * F32_S; e += NT)   // the padding rows
        for (int r = R; r < RP; ++r) f32_smem(e * RP + r) = 0.f;
#pragma unroll
    for (int k = 0; k < F32_NS - 1; ++k)
        f32_issue(obs, y, tau, blockIdx.x + k * gridDim.x, n_tiles, total, N,
                  DO, s, half, (k * F32_S + s) * RP);
    for (int li = 0;; ++li) {
        const int tile = blockIdx.x + li * gridDim.x;
        if (tile >= n_tiles) break;
        const int stage = li % F32_NS;
        __syncthreads();                    // the refilled stage is consumed
        f32_issue(obs, y, tau, tile + (F32_NS - 1) * gridDim.x, n_tiles,
                  total, N, DO, s, half,
                  (((li + F32_NS - 1) % F32_NS) * F32_S + s) * RP);
        f32_cp_wait<F32_NS - 1>();          // this thread's copies of tile
        const int row = (stage * F32_S + s) * RP;
        for (int d = half; d < DO; d += 2) {
            const float x = f32_smem(row + d);
            f32_smem(row + DO + d) = __fmul_rn(x, x);
        }
        __syncthreads();
        if (comp) {
            // a tile's products into fresh accumulators, then the running
            // totals (a small tile sum loses less to rounding than one
            // product added at a time to a large total)
            const int base = stage * F32_S * RG;
            float acc[16];
#pragma unroll
            for (int e = 0; e < 16; ++e) acc[e] = 0.f;
            for (int j = ks; j < F32_S; j += KS) {
                const float4 a = f32_smem4[base + j * RG + I];
                const float4 b = f32_smem4[base + j * RG + J];
                const float av[4] = {a.x, a.y, a.z, a.w};
                const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int u = 0; u < 4; ++u)
#pragma unroll
                    for (int v = 0; v < 4; ++v)
                        acc[u * 4 + v] = fmaf(av[u], bv[v], acc[u * 4 + v]);
            }
#pragma unroll
            for (int e = 0; e < 16; ++e) run[e] += acc[e];
        }
    }
    f32_cp_wait<0>();

    // the block's partial: each entry's KS shares in share order
    __syncthreads();
    if (comp) {
#pragma unroll
        for (int e = 0; e < 16; ++e) f32_smem((ks * NBT + bt) * 16 + e) = run[e];
    }
    __syncthreads();
    for (int e = tid; e < E; e += NT) {
        int a, b;
        entry(e, R, a, b);
        const int Ia = a / 4, Jb = b / 4;
        const int blk = Ia * RB - Ia * (Ia - 1) / 2 + (Jb - Ia);
        const int at = (a % 4) * 4 + b % 4;
        float v = 0.f;
        for (int k = 0; k < KS; ++k) v += f32_smem((k * NBT + blk) * 16 + at);
        partial[(size_t)blockIdx.x * E + e] = v;
    }

    // the cross-block sum: the last block of each group, then the last
    // group; every partial of a sum is loaded before any is added
    const int G = gridDim.x;
    const int NG = (G + F32_GROUP - 1) / F32_GROUP;
    const int grp = blockIdx.x / F32_GROUP;
    const int first = grp * F32_GROUP, size = min(F32_GROUP, G - first);
    float* gpart = partial + (size_t)G * E;
    // a barrier, then one thread's fence before the ticket and after it
    // (as a grid-wide barrier orders its blocks' writes)
    __syncthreads();
    if (tid == 0) {
        __threadfence();
        last = atomicAdd(&tickets[grp], 1u) == (unsigned)size - 1;
        if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;
    for (int e = tid; e < E; e += NT) {
        float x[F32_GROUP];
#pragma unroll
        for (int k = 0; k < F32_GROUP; ++k)
            x[k] = k < size ? __ldcg(partial + (size_t)(first + k) * E + e) : 0.f;
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < F32_GROUP; ++k)
            if (k < size) v += x[k];
        gpart[(size_t)grp * E + e] = v;
    }
    __syncthreads();
    if (tid == 0) {
        tickets[grp] = 0;
        __threadfence();
        last = atomicAdd(&tickets[F32_TOP], 1u) == (unsigned)NG - 1;
        if (last) __threadfence();
    }
    __syncthreads();
    if (!last) return;
    for (int e = tid; e < E; e += NT) {
        float x[F32_TOP];
#pragma unroll
        for (int k = 0; k < F32_TOP; ++k)
            x[k] = k < NG ? __ldcg(gpart + (size_t)k * E + e) : 0.f;
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < F32_TOP; ++k)
            if (k < NG) v += x[k];
        int a, b;
        entry(e, R, a, b);
        gram[a * R + b] = v;
        gram[b * R + a] = v;
    }
    if (tid == 0) tickets[F32_TOP] = 0;
}

// ---------------------------------------------------------------- bf16 mode

constexpr int ST = 256;                 // envs per tile
constexpr int NS = 3;                   // cp.async ring stages
constexpr int GROUP_WARPS = 4;          // warps per fragment group

// fn(std::integral_constant<int, 0>{}), ..., up to P - 1: register
// arrays indexed by the constant stay in registers
template <typename Fn, int... I>
__device__ __forceinline__ void static_for_seq(
    Fn&& fn, std::integer_sequence<int, I...>) {
    (fn(std::integral_constant<int, I>{}), ...);
}
template <int P, typename Fn>
__device__ __forceinline__ void static_for(Fn&& fn) {
    static_for_seq(fn, std::make_integer_sequence<int, P>{});
}

// The 16 x 8 fragments (i, j) of the Gram's first 8 NB columns that touch
// its upper triangle (2 i <= j < NB), numbered row by row; group g takes
// the fragments f with f % 2 == g. The staged tile has the 16 (NB + 1) / 2
// rows those fragments read.
template <int NB>
struct Frags {
    static constexpr int MB = (NB + 1) / 2;            // 16-row blocks
    static constexpr int M = 16 * MB;                  // staged rows
    // fragments in the row blocks before block i: sum_{i' < i} (NB - 2 i')
    __host__ __device__ static constexpr int first(int i) {
        return i * (NB - i + 1);
    }
    static constexpr int COUNT = first(MB);
    static constexpr int PER_GROUP = (COUNT + 1) / 2;
    __host__ __device__ static constexpr int row(int f) {
        int i = 0;
        while (f >= first(i + 1)) ++i;
        return i;
    }
    __host__ __device__ static constexpr int col(int f) {
        return 2 * row(f) + f - first(row(f));
    }
};

template <int M>
struct TcTile {
    static constexpr int RS = ST + 8;                   // row stride (bf16)
    static constexpr int V_BYTES = M * RS * 2;
    static constexpr int STAGE_BYTES = V_BYTES + ST * 4;   // + y (fp32)
    static constexpr int KS = ST / (16 * GROUP_WARPS);  // k-steps per warp
    static constexpr int SMEM = NS * STAGE_BYTES;
};

// Stage the obs rows and y of tile (t, n0): cp.async when every row start
// is 16-byte aligned (N % 8 == 0; envs past N zero-filled), else plain
// loads with the ragged edge masked.
template <int M>
__device__ __forceinline__ void load_tile(
    char* stage, const __nv_bfloat16* __restrict__ obs,
    const float* __restrict__ y, int t, int n0, int DO, int N, bool vec) {
    using L = TcTile<M>;
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(stage);
    float* sY = reinterpret_cast<float*>(stage + L::V_BYTES);
    const int tid = threadIdx.x;
    const __nv_bfloat16* ot = obs + (size_t)t * DO * N;
    const float* yt = y + (size_t)t * N;
    if (vec) {
        constexpr int CH = ST / 8;           // 16-byte chunks of an obs row
        const int n_obs = DO * CH;
        for (int c = tid; c < n_obs + ST / 4; c += NT) {
            if (c < n_obs) {
                const int d = c / CH, n = n0 + 8 * (c % CH);
                const bool ok = n < N;
                cp_async16(sV + d * L::RS + (n - n0),
                           ok ? ot + (size_t)d * N + n : ot, ok ? 16 : 0);
            } else {
                const int n = n0 + 4 * (c - n_obs);
                const bool ok = n < N;
                cp_async16(sY + (n - n0), ok ? yt + n : yt, ok ? 16 : 0);
            }
        }
    } else {
        for (int i = tid; i < DO * ST; i += NT) {
            const int d = i / ST, j = i % ST, n = n0 + j;
            sV[d * L::RS + j] = (n < N) ? ot[(size_t)d * N + n]
                                        : __float2bfloat16_rn(0.f);
        }
        for (int j = tid; j < ST; j += NT)
            sY[j] = (n0 + j < N) ? yt[n0 + j] : 0.f;
    }
}

// Rows DO..2DO+1 of a staged tile: bf16(obs^2), bf16(y) and the ones row
// (1 for envs < N, else 0).
template <int M>
__device__ __forceinline__ void build_rows(char* stage, int n0, int DO,
                                           int N) {
    using L = TcTile<M>;
    __nv_bfloat16* sV = reinterpret_cast<__nv_bfloat16*>(stage);
    const float* sY = reinterpret_cast<const float*>(stage + L::V_BYTES);
    const int tid = threadIdx.x;
    constexpr int CH = ST / 8;
    for (int c = tid; c < DO * CH; c += NT) {
        const int d = c / CH, j = 8 * (c % CH);
        uint4 raw = *reinterpret_cast<const uint4*>(sV + d * L::RS + j);
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
        // bf16 x bf16 is exact before its one rounding, as the fp32
        // product rounded by __float2bfloat16_rn (for |obs| >= 2^-63)
#pragma unroll
        for (int q = 0; q < 4; ++q) h[q] = __hmul2(h[q], h[q]);
        *reinterpret_cast<uint4*>(sV + (DO + d) * L::RS + j) = raw;
    }
    for (int j = tid; j < ST; j += NT) {
        sV[2 * DO * L::RS + j] = __float2bfloat16_rn(sY[j]);
        sV[(2 * DO + 1) * L::RS + j] =
            __float2bfloat16_rn(n0 + j < N ? 1.f : 0.f);
    }
}

// One warp's products on its quarter of a staged tile, for the fragments
// of group G: fresh sums (zeroed here), then added to the running totals;
// the fresh sums of the ones column go to sS[warp in group][row].
template <int NB, int G>
__device__ __forceinline__ void tile_products(
    const __nv_bfloat16* sV, float (&tot)[Frags<NB>::PER_GROUP][4],
    float* sS, int wig, int lane, int jc, int tco, int eo) {
    using F = Frags<NB>;
    constexpr int M = F::M;
    using L = TcTile<M>;
    constexpr int P = F::PER_GROUP;
    float fr[P][4];            // the fresh sums, set by the first k-step
    // lane's ldmatrix row and column within a 16 x 16 block
    const int lr = lane % 16, lc = (lane / 16) * 8;
#pragma unroll
    for (int ks = 0; ks < L::KS; ++ks) {
        const int k0 = (wig * L::KS + ks) * 16;
        uint32_t a[F::MB][4];
#pragma unroll
        for (int i = 0; i < F::MB; ++i)
            ldmatrix_x4(a[i], sV + (16 * i + lr) * L::RS + k0 + lc);
        static_for<P>([&](auto pc) {
            constexpr int p = decltype(pc)::value, f = 2 * p + G;
            if constexpr (f < F::COUNT) {
                constexpr int i = F::row(f), j = F::col(f);
                // B of 8-row block j: the (j % 2) half of 16-row block j / 2
                mma_bf16(fr[p], a[i], a[j / 2][j % 2], a[j / 2][2 + j % 2],
                         ks == 0);
            }
        });
    }
    const int g = lane / 4, tc = lane % 4;
    static_for<P>([&](auto pc) {
        constexpr int p = decltype(pc)::value, f = 2 * p + G;
        if constexpr (f < F::COUNT) {
            constexpr int i = F::row(f), j = F::col(f);
#pragma unroll
            for (int q = 0; q < 4; ++q) tot[p][q] += fr[p][q];
            if (j == jc && tc == tco) {
                float* s = sS + wig * M + 16 * i + g;
                s[0] = eo ? fr[p][1] : fr[p][0];
                s[8] = eo ? fr[p][3] : fr[p][2];
            }
        }
    });
}

// Per-block partial of the extended Gram in bf16 mode; NB 8-column blocks
// (8 NB >= 2 DO + 2): E upper-triangle entries a block, row by row, which
// moments_reduce_kernel sums.
template <int NB>
__global__ void __launch_bounds__(NT, Frags<NB>::M == 64 ? 2 : 1)
    moments_partial_tc_kernel(const __nv_bfloat16* __restrict__ obs,
                              const float* __restrict__ y,
                              const float* __restrict__ tau,
                              float* __restrict__ partial, int T, int DO,
                              int N) {
    using F = Frags<NB>;
    constexpr int M = F::M;
    using L = TcTile<M>;
    constexpr int P = F::PER_GROUP;
    constexpr int NTAU = (4 * M + NT - 1) / NT;   // (row, k) pairs a thread
    extern __shared__ __align__(16) char smem[];   // NS stages
    __shared__ float sS[GROUP_WARPS * M];          // ones column, per warp
    __shared__ float sT[4 * M];                    // v x tau block
    __shared__ float sTT[16];                      // tau x tau block
    const int R = 2 * DO + 5, E = R * (R + 1) / 2, F2 = 2 * DO + 1;
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int grp = warp / GROUP_WARPS, wig = warp % GROUP_WARPS;
    const int c1 = 2 * DO + 1;                     // the ones row
    const int jc = c1 / 8, tco = (c1 % 8) / 2, eo = c1 % 2;
    const bool vec = (N % 8) == 0;
    const int tiles_per_t = (N + ST - 1) / ST;
    const int n_tiles = T * tiles_per_t;
    const int G = gridDim.x;
    const int nt = (n_tiles - (int)blockIdx.x + G - 1) / G;   // >= 1

    // zero rows 2DO+2.. of every stage; nothing writes them again
    for (int s = 0; s < NS; ++s) {
        __nv_bfloat16* sV =
            reinterpret_cast<__nv_bfloat16*>(smem + s * L::STAGE_BYTES);
        for (int i = (2 * DO + 2) * L::RS + tid; i < M * L::RS; i += NT)
            sV[i] = __float2bfloat16_rn(0.f);
    }
    float tot[P][4];
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) tot[p][q] = 0.f;
    float tacc[NTAU], tt = 0.f;
#pragma unroll
    for (int r = 0; r < NTAU; ++r) tacc[r] = 0.f;

    // the block's tiles are blockIdx.x, + G, + 2 G, ...: two cursors
    // (t, tile within t) step through them without a division, one for
    // the loads and one for the tile being summed
    const int dt = G / tiles_per_t, dr = G % tiles_per_t;
    auto advance = [&](int& t, int& r) {
        t += dt;
        r += dr;
        if (r >= tiles_per_t) {
            r -= tiles_per_t;
            ++t;
        }
    };
    int lt = blockIdx.x / tiles_per_t, lr = blockIdx.x % tiles_per_t;
    int ct = lt, cr = lr;
    // the tau values a thread's epilogue needs for tile (t, r) (its k is
    // tid % 4 for every pair, as NT % 4 == 0), read one tile ahead so the
    // load's latency is off the epilogue's path
    float tau_k = 0.f, tau_kl_c = 0.f;
    auto tau_prefetch = [&](int t, int r) {
        tau_k = __ldg(tau + t * 4 + tid % 4);
        if (tid < 16)
            tau_kl_c = __ldg(tau + t * 4 + tid / 4) * tau_k *
                       (float)min(ST, N - r * ST);
    };
    // tau_k(t) s_a into the v x tau block, tau_k tau_l c into tau x tau
    auto tau_epilogue = [&]() {
#pragma unroll
        for (int r = 0; r < NTAU; ++r) {
            const int a = (tid + r * NT) / 4;
            if (a < F2) {
                float s = sS[a];
#pragma unroll
                for (int w = 1; w < GROUP_WARPS; ++w) s += sS[w * M + a];
                tacc[r] = fmaf(tau_k, s, tacc[r]);
            }
        }
        if (tid < 16) tt += tau_kl_c;
    };

#pragma unroll
    for (int s = 0; s < NS - 1; ++s) {
        if (s < nt) {
            load_tile<M>(smem + s * L::STAGE_BYTES, obs, y, lt, lr * ST,
                             DO, N, vec);
            advance(lt, lr);
        }
        cp_async_commit();
    }
    for (int i = 0; i < nt; ++i) {
        cp_async_wait<NS - 2>();
        __syncthreads();       // tile i staged; every warp is done with i - 1
        if (i > 0) tau_epilogue();
        tau_prefetch(ct, cr);
        if (i + NS - 1 < nt) {
            load_tile<M>(smem + ((i + NS - 1) % NS) * L::STAGE_BYTES, obs,
                             y, lt, lr * ST, DO, N, vec);
            advance(lt, lr);
        }
        cp_async_commit();
        char* stage = smem + (i % NS) * L::STAGE_BYTES;
        build_rows<M>(stage, cr * ST, DO, N);
        advance(ct, cr);
        __syncthreads();
        const __nv_bfloat16* sV = reinterpret_cast<const __nv_bfloat16*>(stage);
        if (grp == 0)
            tile_products<NB, 0>(sV, tot, sS, wig, lane, jc, tco, eo);
        else
            tile_products<NB, 1>(sV, tot, sS, wig, lane, jc, tco, eo);
    }
    cp_async_wait<0>();
    __syncthreads();
    tau_epilogue();

    // the block's Gram: the four warps of each group add their totals into
    // sG in warp order
    float* sG = reinterpret_cast<float*>(smem);     // M x M, over the stages
    const int g = lane / 4, tc = lane % 4;
    for (int w = 0; w < GROUP_WARPS; ++w) {
        if (wig == w) {
#pragma unroll
            for (int p = 0; p < P; ++p) {
                const int f = 2 * p + grp;
                if (f >= F::COUNT) continue;
                const int i = F::row(f), j = F::col(f);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const int row = 16 * i + g + 8 * (q / 2);
                    const int col = 8 * j + 2 * tc + q % 2;
                    float& dst = sG[row * M + col];
                    dst = (w == 0) ? tot[p][q] : dst + tot[p][q];
                }
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int r = 0; r < NTAU; ++r) {
        const int pair = tid + r * NT;
        if (pair < 4 * M) sT[pair] = tacc[r];
    }
    if (tid < 16) sTT[tid] = tt;
    __syncthreads();
    for (int e = tid; e < E; e += NT) {
        int a, b;
        entry(e, R, a, b);
        float v;
        if (b < F2)
            v = sG[a * M + b];
        else if (a < F2)
            v = sT[a * 4 + (b - F2)];
        else
            v = sTT[(a - F2) * 4 + (b - F2)];
        partial[(size_t)blockIdx.x * E + e] = v;
    }
}

// gram[a, b] = gram[b, a] = sum over blocks of partial[blk, e], in block
// order: group g of each reduce block sums blocks g, g + 8, ...; the eight
// group sums are then added in group order.
__global__ void __launch_bounds__(NT) moments_reduce_kernel(
    const float* __restrict__ partial, float* __restrict__ gram, int G,
    int DO) {
    __shared__ float part[RED_GROUPS][RED_OUT];
    const int R = 2 * DO + 5;
    const int E = R * (R + 1) / 2;
    const int lane = threadIdx.x % RED_OUT, g = threadIdx.x / RED_OUT;
    const int e = blockIdx.x * RED_OUT + lane;
    float s = 0.f;
    if (e < E)
        for (int b = g; b < G; b += RED_GROUPS) s += partial[(size_t)b * E + e];
    part[g][lane] = s;
    __syncthreads();
    if (g == 0 && e < E) {
        float tot = part[0][lane];
        for (int k = 1; k < RED_GROUPS; ++k) tot += part[k][lane];
        int a, b;
        entry(e, R, a, b);
        gram[a * R + b] = tot;
        gram[b * R + a] = tot;
    }
}

// fp32 mode's shared memory opt-in, once per device: the host call takes
// microseconds, longer than a launch at c1 or c2
cudaError_t f32_allow_smem() {
    static bool done[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
    err = cudaFuncSetAttribute(moments_fp32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               F32_SMEM);
    if (err == cudaSuccess && dev < 64) done[dev] = true;
    return err;
}

template <int NB>
cudaError_t launch_tc(const __nv_bfloat16* obs, const float* y,
                      const float* tau, float* partial, int T, int DO, int N,
                      int n_blocks, cudaStream_t st) {
    constexpr int M = Frags<NB>::M;
    constexpr int smem = TcTile<M>::SMEM;
    // the static shared memory: sS, sT, sTT
    constexpr int fixed = sizeof(float) * (GROUP_WARPS * M + 4 * M + 16);
    static_assert(smem + fixed <= SMEM_MAX, "tile exceeds shared memory");
    auto kern = moments_partial_tc_kernel<NB>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kern<<<n_blocks, NT, smem, st>>>(obs, y, tau, partial, T, DO, N);
    return cudaGetLastError();
}

}  // namespace

// obs (T, do, N) fp32, or bf16 when obs_bf16 != 0; y (T, N) and
// tau (T, 4) fp32, all on the device; gram: (2do+5)^2 floats out.
// partial: scratch, n_blocks * E floats in bf16 mode, (n_blocks +
// ceil(n_blocks / 8)) * E in fp32 mode (n_blocks <= 132 there; one
// fp32-mode launch at a time on a device, f32_tickets).
extern "C" int trpo_moments_launch(const void* obs, const float* y,
                                   const float* tau, float* partial,
                                   float* gram, int T, int DO, int N,
                                   int n_blocks, int obs_bf16, void* stream) {
    if (DO > DO_MAX || DO < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int R = 2 * DO + 5;
    const int E = R * (R + 1) / 2;
    cudaError_t err;
    if (obs_bf16) {
        // column blocks that hold the 2 DO + 2 tile rows: 7 up to do 27
        // (c3-c5), 8 up to do 31, 9 at do 32
        const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(obs);
        const int nb = (2 * DO + 2 + 7) / 8;
        err = nb <= 7   ? launch_tc<7>(o, y, tau, partial, T, DO, N, n_blocks,
                                       st)
              : nb == 8 ? launch_tc<8>(o, y, tau, partial, T, DO, N, n_blocks,
                                       st)
                        : launch_tc<9>(o, y, tau, partial, T, DO, N, n_blocks,
                                       st);
    } else {
        if (n_blocks < 1 || n_blocks > F32_GRID
            || (long long)T * N >= (1LL << 31) - F32_S)
            return (int)cudaErrorInvalidValue;
        const int RB = (R + 3) / 4, NBT = RB * (RB + 1) / 2;
        const size_t ring = (size_t)F32_NS * F32_S * 4 * (RB | 1) * 4;
        const size_t red = (size_t)(NT / NBT) * NBT * 16 * sizeof(float);
        const size_t smem = ring > red ? ring : red;
        err = f32_allow_smem();
        if (err != cudaSuccess) return (int)err;
        moments_fp32_kernel<<<n_blocks, NT, smem, st>>>(
            static_cast<const float*>(obs), y, tau, partial, gram, T, DO, N);
        return (int)cudaGetLastError();
    }
    if (err != cudaSuccess) return (int)err;
    moments_reduce_kernel<<<(E + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, gram, n_blocks, DO);
    return (int)cudaGetLastError();
}
