// The per-tile body of the Gauss-Newton FVP for the 2-hidden-layer tanh
// policy, shared by the batch-major kernel (fvp.cu) and the feature-first
// one (fvp_ff.cu), which differ only in how a tile's inputs and hidden
// activations reach shared memory. Per sample of a tile:
//   forward tangent  dh0 = (1-h0^2)(x dW0 + db0)
//                    dh1 = (1-h1^2)(dh0 W1 + h0 dW1 + db1)
//                    dmu = dh1 W2 + h1 dW2 + db2
//   Fisher scaling   u   = dmu * scale, scale = inv_var / B
//   reverse          gW2 = h1^T u, g1 = (u W2^T)(1-h1^2), gW1 = h0^T g1,
//                    g0 = (g1 W1^T)(1-h0^2), gW0 = x^T g0 (+ bias sums)
// Every product runs out of shared memory (rows padded by one word so
// column reads do not collide in a bank); each thread keeps its share of
// the weight gradient in registers across all of its block's tiles and
// writes it to a per-block partial, which reduce_kernel sums in a fixed
// order with the logstd block 2 v and the damping. No float atomics, so
// two calls on the same inputs return bit-identical Fv.
#pragma once

#include <cuda_runtime.h>

// Not in an unnamed namespace: with the includers' own unnamed namespaces
// that makes nvcc's kernel stubs ambiguous. Every library that includes
// this header builds the same code.
namespace fvp_tile {

constexpr int H = 64;          // hidden width (both layers)
constexpr int HP = H + 1;      // padded row stride in shared memory
constexpr int NT = 256;        // threads per block
constexpr int DO_MAX = 32;
constexpr int DA_MAX = 8;
constexpr int RW1 = H * H / NT;                        // 16 gW1 entries
constexpr int RW0 = (DO_MAX * H + NT - 1) / NT;        // <= 8 gW0 entries
constexpr int RW2 = (H * DA_MAX + NT - 1) / NT;        // <= 2 gW2 entries
constexpr int ROWS = NT / H;   // gW0/gW1 rows interleave by this stride
constexpr int RED_OUT = 32;
constexpr int RED_GROUPS = NT / RED_OUT;

// The shared-memory operands of a tile. X (S, XS), h0/h1/t0/t1 (S, HP) and
// u (S, DA) are per tile; the rest is loaded once per block.
struct Smem {
    const float *X, *h0, *h1;
    float *t0, *t1, *u;          // dh0 then g0; dh1 then g1; u
    const float *W1, *dW1;       // (H, HP)
    const float *W2, *dW2;       // (H, DA)
    const float *dW0;            // (DO, H)
    const float *db0, *db1, *db2, *scale;
    int XS, DO, DA;
};

struct Acc {
    float W1[RW1], W0[RW0], W2[RW2], b0, b1, b2;
};

__device__ __forceinline__ void zero(Acc& a) {
#pragma unroll
    for (int r = 0; r < RW1; ++r) a.W1[r] = 0.f;
#pragma unroll
    for (int r = 0; r < RW0; ++r) a.W0[r] = 0.f;
#pragma unroll
    for (int r = 0; r < RW2; ++r) a.W2[r] = 0.f;
    a.b0 = a.b1 = a.b2 = 0.f;
}

// One tile of S samples, ns of them real (the rest padding, u = 0). The
// caller has filled X, h0 and h1 and synchronised the block.
template <int S>
__device__ __forceinline__ void tile(const Smem& m, int ns, Acc& acc) {
    const int tid = threadIdx.x, XS = m.XS, DO = m.DO, DA = m.DA;
    const int jc = tid % H;            // gW0/gW1 column of this thread
    const int k0 = tid / H;            // its first row; rows k0 + ROWS r
    // forward tangent, layer 0
    for (int i = tid; i < S * H; i += NT) {
        const int s = i / H, c = i % H;
        float a = 0.f;
        for (int d = 0; d < DO; ++d) a = fmaf(m.X[s * XS + d], m.dW0[d * H + c], a);
        a += m.db0[c];
        const float h = m.h0[s * HP + c];
        m.t0[s * HP + c] = (1.f - h * h) * a;
    }
    __syncthreads();
    // forward tangent, layer 1
    for (int i = tid; i < S * H; i += NT) {
        const int s = i / H, c = i % H;
        float a = 0.f;
#pragma unroll 8
        for (int k = 0; k < H; ++k) {
            a = fmaf(m.t0[s * HP + k], m.W1[k * HP + c], a);
            a = fmaf(m.h0[s * HP + k], m.dW1[k * HP + c], a);
        }
        a += m.db1[c];
        const float h = m.h1[s * HP + c];
        m.t1[s * HP + c] = (1.f - h * h) * a;
    }
    __syncthreads();
    // output tangent and Fisher scaling; padded samples get u = 0
    for (int i = tid; i < S * DA; i += NT) {
        const int s = i / DA, o = i % DA;
        float a = 0.f;
        for (int k = 0; k < H; ++k) {
            a = fmaf(m.t1[s * HP + k], m.W2[k * DA + o], a);
            a = fmaf(m.h1[s * HP + k], m.dW2[k * DA + o], a);
        }
        a += m.db2[o];
        m.u[i] = (s < ns) ? a * m.scale[o] : 0.f;
    }
    __syncthreads();
    // reverse: gW2 = h1^T u, gb2 = sum u; g1 = (u W2^T)(1 - h1^2)
#pragma unroll
    for (int r = 0; r < RW2; ++r) {
        const int e = tid + r * NT;
        if (e < H * DA) {
            const int k = e / DA, o = e % DA;
            float a = acc.W2[r];
            for (int s = 0; s < S; ++s) a = fmaf(m.h1[s * HP + k], m.u[s * DA + o], a);
            acc.W2[r] = a;
        }
    }
    if (tid < DA)
        for (int s = 0; s < S; ++s) acc.b2 += m.u[s * DA + tid];
    for (int i = tid; i < S * H; i += NT) {
        const int s = i / H, k = i % H;
        float g = 0.f;
        for (int o = 0; o < DA; ++o) g = fmaf(m.u[s * DA + o], m.W2[k * DA + o], g);
        const float h = m.h1[s * HP + k];
        m.t1[s * HP + k] = g * (1.f - h * h);
    }
    __syncthreads();
    // gW1 = h0^T g1, gb1 = sum g1; g0 = (g1 W1^T)(1 - h0^2)
    for (int s = 0; s < S; ++s) {
        const float g = m.t1[s * HP + jc];
#pragma unroll
        for (int r = 0; r < RW1; ++r)
            acc.W1[r] = fmaf(m.h0[s * HP + k0 + ROWS * r], g, acc.W1[r]);
    }
    if (tid < H)
        for (int s = 0; s < S; ++s) acc.b1 += m.t1[s * HP + tid];
    for (int i = tid; i < S * H; i += NT) {
        const int s = i / H, k = i % H;
        float g = 0.f;
#pragma unroll 8
        for (int c = 0; c < H; ++c) g = fmaf(m.t1[s * HP + c], m.W1[k * HP + c], g);
        const float h = m.h0[s * HP + k];
        m.t0[s * HP + k] = g * (1.f - h * h);
    }
    __syncthreads();
    // gW0 = x^T g0, gb0 = sum g0
    for (int s = 0; s < S; ++s) {
        const float g = m.t0[s * HP + jc];
#pragma unroll
        for (int r = 0; r < RW0; ++r) {
            const int d = k0 + ROWS * r;
            if (d < DO) acc.W0[r] = fmaf(m.X[s * XS + d], g, acc.W0[r]);
        }
    }
    if (tid < H)
        for (int s = 0; s < S; ++s) acc.b0 += m.t0[s * HP + tid];
}

// This block's gradient partial, in flat sorted-key order (W0, W1, W2,
// b0, b1, b2): Pg = DO H + H H + H DA + 2 H + DA floats.
__device__ __forceinline__ void write_partial(const Acc& acc, float* out,
                                              int DO, int DA) {
    const int tid = threadIdx.x, jc = tid % H, k0 = tid / H;
    const int oW1 = DO * H, oW2 = oW1 + H * H, ob0 = oW2 + H * DA;
    const int ob1 = ob0 + H, ob2 = ob1 + H;
#pragma unroll
    for (int r = 0; r < RW1; ++r) out[oW1 + (k0 + ROWS * r) * H + jc] = acc.W1[r];
#pragma unroll
    for (int r = 0; r < RW0; ++r) {
        const int d = k0 + ROWS * r;
        if (d < DO) out[d * H + jc] = acc.W0[r];
    }
#pragma unroll
    for (int r = 0; r < RW2; ++r) {
        const int e = tid + r * NT;
        if (e < H * DA) out[oW2 + e] = acc.W2[r];
    }
    if (tid < H) {
        out[ob0 + tid] = acc.b0;
        out[ob1 + tid] = acc.b1;
    }
    if (tid < DA) out[ob2 + tid] = acc.b2;
}

// out[i] = sum over blocks of partial[blk, i] + damping v[i] for the
// weight/bias entries, 2 v[i] + damping v[i] for logstd. Fixed order:
// group g sums blocks g, g + 8, ...; the group sums add in group order.
__global__ void __launch_bounds__(NT) reduce_kernel(
    const float* __restrict__ partial, const float* __restrict__ v,
    float* __restrict__ out, int G, int Pg, int P, float damping) {
    __shared__ float part[RED_GROUPS][RED_OUT];
    const int lane = threadIdx.x % RED_OUT, g = threadIdx.x / RED_OUT;
    const int i = blockIdx.x * RED_OUT + lane;
    float s = 0.f;
    if (i < Pg)
        for (int b = g; b < G; b += RED_GROUPS) s += partial[(size_t)b * Pg + i];
    part[g][lane] = s;
    __syncthreads();
    if (g == 0 && i < P) {
        const float vi = v[i];
        if (i < Pg) {
            float tot = part[0][lane];
            for (int k = 1; k < RED_GROUPS; ++k) tot += part[k][lane];
            out[i] = tot + damping * vi;
        } else {
            out[i] = 2.f * vi + damping * vi;
        }
    }
}

// Launches reduce_kernel over the P = Pg + DA entries of v.
inline cudaError_t reduce(const float* partial, const float* v, float* out,
                          int n_blocks, int DO, int DA, float damping,
                          cudaStream_t st) {
    const int Pg = DO * H + H * H + H * DA + 2 * H + DA;
    const int P = Pg + DA;
    reduce_kernel<<<(P + RED_OUT - 1) / RED_OUT, NT, 0, st>>>(
        partial, v, out, n_blocks, Pg, P, damping);
    return cudaGetLastError();
}

}  // namespace fvp_tile
