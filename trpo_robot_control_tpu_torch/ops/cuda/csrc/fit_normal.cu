// The linear baseline's ridge solve: one block, one launch a fit.
//
// Replaces no Pallas kernel: the JAX package's fit_normal
// (trpo_robot_control_tpu/models/baseline.py:137) solves the normal
// equations with XLA's jnp.linalg.eigh (:155). On the card
// torch.linalg.eigh reads its info flag on the host, a synchronisation
// that a CUDA graph of the train step cannot capture; this kernel does the
// same solve without one:
//     d = sqrt(diag A + eps),  A_s = A / (d d^T)
//     A_s = Q diag(lambda) Q^T                (cyclic Jacobi)
//     w = Q diag(1/lambda, 0 below rel_floor * lambda_max) Q^T (b/d) / d
//     a non-finite w -> 0.
//
// The system is tiny (F = 2 obs_dim + 4 <= 68) and the work serial: about
// 10 sweeps of F - 1 dependent rounds, each a few hundred flops a thread.
// One block holds A_s and Q in shared memory (2 x 68 x 69 fp32, 37.5 KB;
// the row stride is odd so a column walk hits distinct banks) and nothing
// else touches device memory after the first read of A. It is bound by
// the one SM's instruction throughput and the rounds' __syncthreads, not by
// bytes or flops: the whole card's bound is well under a microsecond, one
// SM's a few to twenty. So the rotation pass reads its work items from
// tables in shared memory (each thread's blocks and Q entries, set once
// a launch, and the round's pairs, set by the angle threads) instead of
// deriving them by integer division in every round.
//
// Each round rotates the F/2 disjoint index pairs of the round-robin
// (circle method) schedule at once: threads 0..F/2-1 form the angles
// (Rutishauser: theta = (a_qq - a_pp) / (2 a_pq), t = sgn(theta) /
// (|theta| + sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c), then
// the block applies J^T A_s J two by two: a thread owns the 2 x 2 block
// of pairs (P, Q), P < Q, rotates its rows by pair P's angle and its
// columns by Q's, and writes the block and its mirror, so A_s stays
// exactly symmetric; a diagonal block takes a_pp - t a_pq, a_qq + t a_pq
// and zeros. Q's columns p, q are rotated in the same pass. A sweep is
// F - 1 rounds; before each, the off-diagonal squares are summed (thread
// i row i in column order, thread 0 the rows in order) and the sweeps stop
// once that sum is at most tol^2 ||A_s||_F^2, or after max_sweeps.
//
// Every multiply, add, divide and square root is a separately rounded
// __f*_rn operation (nvcc contracts none of them into an FMA) in a fixed
// order, so tests/test_torch_helpers.py's fit_normal_jacobi_statement,
// which runs the same operations as fp32 tensor ops, states the kernel's
// arithmetic; the result is bit-identical from call to call.
//
// C interface (ctypes); returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int F_MAX = 68;
constexpr int LD = F_MAX + 1;
constexpr int NT = 512;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

// Pair P (p < q) of round r over m (even) indices: pair 0 is (r, m - 1),
// pair k >= 1 is (r + k, r - k) mod m - 1. Every index meets every other
// once in m - 1 rounds.
__device__ __forceinline__ void pair_of(int m, int r, int P, int& p, int& q) {
    if (P == 0) {
        p = r;
        q = m - 1;
        return;
    }
    const int a = (r + P) % (m - 1);
    const int b = (r - P + m - 1) % (m - 1);
    p = min(a, b);
    q = max(a, b);
}

// Item e of the h (h + 1) / 2 pair blocks (P, Q), P <= Q, row by row.
__device__ __forceinline__ void block_of(int e, int h, int& P, int& Q) {
    P = 0;
    while (e >= h - P) {
        e -= h - P;
        ++P;
    }
    Q = P + e;
}

// The sum of S's squares (off: without the diagonal), in a fixed order;
// every thread returns it. Starts and ends on a barrier.
__device__ float square_sum(float (*S)[LD], float* rows, float* total, int m,
                            bool off) {
    const int i = threadIdx.x;
    __syncthreads();
    if (i < m) {
        float acc = 0.f;
        for (int j = 0; j < m; ++j)
            acc = add(acc, (off && j == i) ? 0.f : mul(S[i][j], S[i][j]));
        rows[i] = acc;
    }
    __syncthreads();
    if (i == 0) {
        float acc = 0.f;
        for (int k = 0; k < m; ++k) acc = add(acc, rows[k]);
        *total = acc;
    }
    __syncthreads();
    return *total;
}

__global__ void __launch_bounds__(NT, 1)
fit_normal_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ w, int* __restrict__ sweeps_out,
                  int m, float eps, float rel_floor, float tol2,
                  int max_sweeps) {
    __shared__ float S[F_MAX][LD];
    __shared__ float V[F_MAX][LD];
    __shared__ float d[F_MAX], y[F_MAX], z[F_MAX], rows[F_MAX];
    __shared__ float cs[F_MAX / 2], sn[F_MAX / 2], tn[F_MAX / 2];
    __shared__ unsigned char pp[F_MAX / 2], qq[F_MAX / 2];
    // the rotation pass's work items, fixed for the launch: blocks (P, Q)
    // and Q's (row, pair) entries, each packed as lo | hi << 8
    __shared__ unsigned short blk[F_MAX / 2 * (F_MAX / 2 + 1) / 2];
    __shared__ unsigned short vit[F_MAX * (F_MAX / 2)];
    __shared__ float total, floor_s;
    const int tid = threadIdx.x;
    const int h = m / 2;
    const int nb = h * (h + 1) / 2;

    if (tid < m) {
        d[tid] = __fsqrt_rn(add(A[tid * m + tid], eps));
        y[tid] = b[tid];
    }
    for (int e = tid; e < nb; e += NT) {
        int P, Q;
        block_of(e, h, P, Q);
        blk[e] = (unsigned short)(P | Q << 8);
    }
    for (int k = tid; k < m * h; k += NT)
        vit[k] = (unsigned short)(k / h | (k % h) << 8);
    __syncthreads();
    for (int e = tid; e < m * m; e += NT) {
        const int i = e / m, j = e % m;
        S[i][j] = dvd(A[e], mul(d[i], d[j]));
        V[i][j] = i == j ? 1.f : 0.f;
    }
    const float thr = mul(tol2, square_sum(S, rows, &total, m, false));

    int sweep = 0;
    for (; sweep < max_sweeps; ++sweep) {
        if (square_sum(S, rows, &total, m, true) <= thr) break;
        for (int r = 0; r < m - 1; ++r) {
            if (tid < h) {
                int p, q;
                pair_of(m, r, tid, p, q);
                pp[tid] = (unsigned char)p;
                qq[tid] = (unsigned char)q;
                const float app = S[p][p], aqq = S[q][q], apq = S[p][q];
                float t = 0.f;
                if (apq != 0.f) {
                    const float th = dvd(sub(aqq, app), mul(2.f, apq));
                    const float sg = th >= 0.f ? 1.f : -1.f;
                    t = dvd(sg, add(fabsf(th),
                                    __fsqrt_rn(add(mul(th, th), 1.f))));
                }
                const float c = dvd(1.f, __fsqrt_rn(add(mul(t, t), 1.f)));
                cs[tid] = c;
                sn[tid] = mul(t, c);
                tn[tid] = t;
            }
            __syncthreads();
            for (int e = tid; e < nb + m * h; e += NT) {
                if (e < nb) {
                    const int P = blk[e] & 0xff, Q = blk[e] >> 8;
                    const int p1 = pp[P], q1 = qq[P];
                    if (P == Q) {
                        const float ta = mul(tn[P], S[p1][q1]);
                        S[p1][p1] = sub(S[p1][p1], ta);
                        S[q1][q1] = add(S[q1][q1], ta);
                        S[p1][q1] = 0.f;
                        S[q1][p1] = 0.f;
                        continue;
                    }
                    const int p2 = pp[Q], q2 = qq[Q];
                    const float c1 = cs[P], s1 = sn[P], c2 = cs[Q], s2 = sn[Q];
                    const float m00 = S[p1][p2], m01 = S[p1][q2];
                    const float m10 = S[q1][p2], m11 = S[q1][q2];
                    // rows by pair P's rotation, then columns by Q's
                    const float x00 = sub(mul(c1, m00), mul(s1, m10));
                    const float x01 = sub(mul(c1, m01), mul(s1, m11));
                    const float x10 = add(mul(s1, m00), mul(c1, m10));
                    const float x11 = add(mul(s1, m01), mul(c1, m11));
                    const float y00 = sub(mul(c2, x00), mul(s2, x01));
                    const float y01 = add(mul(s2, x00), mul(c2, x01));
                    const float y10 = sub(mul(c2, x10), mul(s2, x11));
                    const float y11 = add(mul(s2, x10), mul(c2, x11));
                    S[p1][p2] = y00;
                    S[p2][p1] = y00;
                    S[p1][q2] = y01;
                    S[q2][p1] = y01;
                    S[q1][p2] = y10;
                    S[p2][q1] = y10;
                    S[q1][q2] = y11;
                    S[q2][q1] = y11;
                } else {
                    const int v = vit[e - nb], i = v & 0xff, P = v >> 8;
                    const int p = pp[P], q = qq[P];
                    const float c = cs[P], s = sn[P];
                    const float vp = V[i][p], vq = V[i][q];
                    V[i][p] = sub(mul(c, vp), mul(s, vq));
                    V[i][q] = add(mul(s, vp), mul(c, vq));
                }
            }
            __syncthreads();
        }
    }

    // the floor, then w = Q diag(inv) Q^T (b/d) / d
    if (tid == 0) {
        float mx = S[0][0];
        for (int i = 1; i < m; ++i) mx = S[i][i] > mx ? S[i][i] : mx;
        floor_s = mul(rel_floor, mx);
    }
    if (tid < m) y[tid] = dvd(y[tid], d[tid]);
    __syncthreads();
    if (tid < m) {
        const float lam = S[tid][tid];
        const float inv = lam > floor_s ? dvd(1.f, lam) : 0.f;
        float acc = 0.f;
        for (int i = 0; i < m; ++i) acc = add(acc, mul(V[i][tid], y[i]));
        z[tid] = mul(acc, inv);
    }
    __syncthreads();
    if (tid < m) {
        float acc = 0.f;
        for (int k = 0; k < m; ++k) acc = add(acc, mul(V[tid][k], z[k]));
        const float wi = dvd(acc, d[tid]);
        w[tid] = isfinite(wi) ? wi : 0.f;
    }
    if (sweeps_out && tid == 0) sweeps_out[0] = sweep;
}

}  // namespace

// A (F, F) symmetric and b (F,) fp32 on the device, F even and <= 68;
// w (F,) out; the sweeps run (one int32) out when not null.
extern "C" int trpo_fit_normal_launch(const float* A, const float* b,
                                      float* w, int* sweeps, int F, float eps,
                                      float rel_floor, float tol2,
                                      int max_sweeps, void* stream) {
    if (F < 2 || F > F_MAX || (F & 1)) return (int)cudaErrorInvalidValue;
    fit_normal_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        A, b, w, sweeps, F, eps, rel_floor, tol2, max_sweeps);
    return (int)cudaGetLastError();
}
