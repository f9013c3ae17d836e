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
// Each round rotates the F/2 disjoint index pairs of the round-robin
// (circle method) schedule at once. Its positions are fixed: index
// i < m - 1 sits at position (i - r) mod (m - 1) in round r, index m - 1 at
// m - 1, and every round pairs positions (0, m - 1) and (k, m - 1 - k)
// (pair k); between rounds every index but m - 1 moves down one position.
// The pair's p, the smaller index, sets the angle's sign (Rutishauser:
// theta = (a_qq - a_pp) / (2 a_pq), t = sgn(theta) / (|theta| +
// sqrt(theta^2 + 1)), c = 1 / sqrt(t^2 + 1), s = t c). The round is
// J^T A_s J two by two: block (P, Q) of pairs, P < Q, is rows rotated by
// P's angle, then columns by Q's, and mirrored below the diagonal; a
// diagonal block is a_pp - t a_pq, a_qq + t a_pq and zeros. Q's columns
// p, q are rotated by their pair's angle. A sweep is F - 1 rounds; before
// each, the off-diagonal squares are summed (row i in column order, then
// the rows in order) and the sweeps stop once that sum is at most
// tol^2 ||A_s||_F^2, or after max_sweeps.
//
// The system is tiny (F = 2 obs_dim + 4 <= 68) and the work serial: 6-10
// sweeps of F - 1 dependent rounds. Nothing but its rounds' latency bounds
// it (the whole card's bound is a few ns; one SM's well under a
// microsecond). A round's critical path is the next round's angles: each
// needs this round's rotated a_pp, a_qq, a_pq, then three divides and two
// square roots. So the design cuts a round to one barrier over a few
// warps, in three roles:
//   - angle warp: lane k forms pair k's angle for the NEXT round from this
//     round's S and angles (the three entries it needs recomputed with
//     the row warps' arithmetic), beside the row and Q work. Its path is
//     the round's critical path, one dependent instruction after another,
//     so it carries its schedule from round to round (the rows forming its
//     next pair sit at fixed positions now, in fixed pairs, and their
//     indices step by one) instead of recomputing positions.
//   - row warps: `split` threads own each row of S = A_s (index order, in
//     shared memory, odd row stride). A row's new entries in block (P, Q)
//     depend on its own row and its pair partner's only (block (P, Q),
//     P > Q, is the mirror of (Q, P): rows p2, q2 at columns p1, q1), so
//     the two threads of pair P form block (P, P + v mod h), v = 1 .. h/2
//     (at v = h/2, h even, only from the smaller pair number), one row each,
//     and write it with its mirror: every block of the round once, h/2 of
//     them a pair, whatever its number; the split threads of a row share
//     the v. S is double-buffered: a round reads one copy, writes the other.
//   - Q warps: `split` threads own each row of Q; rotating columns p, q
//     of a row touches that row only, so Q is rotated in place.
// Angles reach the other warps through a small table per round parity,
// {c, s, t, p | q << 8}. The block is only those warps, so __syncthreads
// is a barrier over them: 7 warps at m = 22 (split 3), 11 at 28 and 19 at
// 52 (split 5), 23 at 58 (split 6), 24 at 68 (split 5). The launcher takes
// the split from m (split_for). The stop test adds one barrier a sweep.
//
// Every multiply, add, divide and square root is a separately rounded
// __f*_rn operation (nvcc contracts none of them into an FMA) in the
// statement's order, so tests/test_torch_helpers.py's
// fit_normal_jacobi_statement, which runs the same operations as fp32
// tensor ops, states the kernel's arithmetic bit for bit whatever the
// split; the result is the same from call to call.
//
// C interface (ctypes); returns cudaGetLastError() after the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// S's two copies, then Q: m x (m + 1) floats each. The round loop reads
// and writes them at 32-bit shared addresses from one base taken at the
// start (indexing the array there has the compiler re-derive the shared
// window, an S2R of the CTA's cluster rank, on the round's critical path).
extern __shared__ float smem[];

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float lds(uint32_t base, int i) {
    float v;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(base + 4u * i));
    return v;
}
__device__ __forceinline__ void sts(uint32_t base, int i, float v) {
    asm volatile("st.shared.f32 [%0], %1;" ::"r"(base + 4u * i), "f"(v)
                 : "memory");
}

constexpr int F_MAX = 68;
constexpr int H_MAX = F_MAX / 2;
constexpr int MAX_THREADS = 768;
constexpr int QBATCH = 4;       // a Q thread's pairs loaded at once

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__host__ __device__ __forceinline__ int warps_of(int n) { return (n + 31) / 32; }

// The block: row warps, then Q warps (split threads a row each), then
// the angle warps (a lane a pair).
__host__ __device__ __forceinline__ int row_threads(int m, int split) {
    return 32 * warps_of(split * m);
}
__host__ __device__ __forceinline__ int block_threads(int m, int split) {
    return 2 * row_threads(m, split) + 32 * warps_of(m / 2);
}

// Threads a row at m: the fastest of splits 1-8 timed on an H100 at the
// configs' m (3 at 22, 5 at 28 and 52, 6 at 58); past 58 the most that
// keeps the block within MAX_THREADS (6 gives 800 threads at m = 60).
__host__ __forceinline__ int split_for(int m) {
    return m <= 24 ? 3 : m <= 52 ? 5 : m <= 58 ? 6 : 5;
}

// The index at a position, from one round to the next: it grows by one,
// mod m - 1, at every position but m - 1 (in round 0 index i sits at
// position i).
__device__ __forceinline__ int next_index(int idx, int m) {
    return idx == m - 1 ? m - 1 : idx + 1 == m - 1 ? 0 : idx + 1;
}
// The position in round r of what is at position pos in round r + 1.
__device__ __forceinline__ int shift_from(int pos, int m) {
    return pos == m - 1 ? m - 1 : pos == m - 2 ? 0 : pos + 1;
}
// The pair of position pos.
__device__ __forceinline__ int pair_at(int pos, int m) {
    return min(pos, m - 1 - pos);
}

struct Rot {
    float c, s, t;
    int p, q;
};

__device__ __forceinline__ Rot pick(bool first, const Rot& a, const Rot& b) {
    return {first ? a.c : b.c, first ? a.s : b.s, first ? a.t : b.t,
            first ? a.p : b.p, first ? a.q : b.q};
}

__device__ __forceinline__ Rot rot_at(uint32_t tab, int k) {
    float4 e;
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(e.x), "=f"(e.y), "=f"(e.z), "=f"(e.w)
                 : "r"(tab + 16u * k));
    const int pq = __float_as_int(e.w);
    return {e.x, e.y, e.z, pq & 0xff, pq >> 8};
}

// Rutishauser's angle of pair (p, q), p < q.
__device__ __forceinline__ float4 angle(float app, float aqq, float apq,
                                        int p, int q) {
    float t = 0.f;
    if (apq != 0.f) {
        const float th = dvd(sub(aqq, app), mul(2.f, apq));
        const float sg = th >= 0.f ? 1.f : -1.f;
        t = dvd(sg, add(fabsf(th), __fsqrt_rn(add(mul(th, th), 1.f))));
    }
    const float c = dvd(1.f, __fsqrt_rn(add(mul(t, t), 1.f)));
    return make_float4(c, mul(t, c), t, __int_as_float(p | q << 8));
}

// The round's new S[i][i], i in pair R: a_pp - t a_pq or a_qq + t a_pq.
__device__ __forceinline__ float diag_new(uint32_t sb, int ld, int i,
                                          const Rot& R) {
    const float ta = mul(R.t, lds(sb, R.p * ld + R.q));
    const float a = lds(sb, i * ld + i);
    return i == R.p ? sub(a, ta) : add(a, ta);
}

// The round's new S[i][R2.p] (yp) and S[i][R2.q] (yq) for i in pair R1
// (ip: i == R1.p), R2 another pair; lt: R1's pair number < R2's. The
// statement's block (R1, R2) (lt) is rows p1, q1 rotated by R1, then
// columns p2, q2 by R2; otherwise these entries mirror block (R2, R1):
// rows p2, q2 by R2, then columns p1, q1 by R1. Both are one form: the
// first rotation F on rows (F.p, F.q) at columns (C.p, C.q) gives
// X = [cu0 - sw0, cu1 - sw1; su0 + cw0, su1 + cw1], the second takes one
// row of X (lt) or each row of X at once (not lt). The four loads and the
// operations are the same for every lane, so a warp does not diverge;
// x - y is x + (-y) in IEEE arithmetic, so the signs folded into the
// second rotation's coefficients round as the statement's subtractions.
__device__ __forceinline__ void off_new(uint32_t sb, int ld, bool ip,
                                        const Rot& R1, const Rot& R2, bool lt,
                                        float& yp, float& yq) {
    // field by field: a reference chosen at run time between two structs
    // in registers compiles to a select over every field offset
    const Rot F = pick(lt, R1, R2), C = pick(lt, R2, R1);
    const float u0 = lds(sb, F.p * ld + C.p);
    const float u1 = lds(sb, F.p * ld + C.q);
    const float w0 = lds(sb, F.q * ld + C.p);
    const float w1 = lds(sb, F.q * ld + C.q);
    const float x00 = sub(mul(F.c, u0), mul(F.s, w0));
    const float x01 = sub(mul(F.c, u1), mul(F.s, w1));
    const float x10 = add(mul(F.s, u0), mul(F.c, w0));
    const float x11 = add(mul(F.s, u1), mul(F.c, w1));
    // lt: yp = c2 o0 - s2 o1, yq = s2 o0 + c2 o1 on i's row o of X;
    // else yp from X's row 0, yq from row 1: c1 x0 - s1 x1 (ip) or
    // s1 x0 + c1 x1
    const float o0 = ip ? x00 : x10, o1 = ip ? x01 : x11;
    const float a = lt ? R2.c : ip ? R1.c : R1.s;
    const float bn = lt ? -R2.s : ip ? -R1.s : R1.c;
    const float c = lt ? R2.s : a, dn = lt ? R2.c : bn;
    yp = add(mul(a, lt ? o0 : x00), mul(bn, lt ? o1 : x01));
    yq = add(mul(c, lt ? o0 : x10), mul(dn, lt ? o1 : x11));
}

// Row i's sum of squares in column order (off: the diagonal as 0).
__device__ __forceinline__ float row_squares(uint32_t sb, int ld, int i,
                                             int m, bool off) {
    float acc = 0.f;
    for (int j = 0; j < m; ++j) {
        const float x = lds(sb, i * ld + j);
        acc = add(acc, (off && j == i) ? 0.f : mul(x, x));
    }
    return acc;
}

// rows[0] + rows[1] + ... in order; every thread forms it.
__device__ __forceinline__ float rows_total(const float* rows, int m) {
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc = add(acc, rows[k]);
    return acc;
}

__global__ void __launch_bounds__(MAX_THREADS, 1)
fit_normal_kernel(const float* __restrict__ A, const float* __restrict__ b,
                  float* __restrict__ w, int* __restrict__ sweeps_out,
                  int m, int split, float eps, float rel_floor, float tol2,
                  int max_sweeps) {
    const int ld = m + 1;                 // odd: column walks hit distinct
    const int vb = 2 * m * ld;            // banks; Q after S's two copies
    const uint32_t sh = shared_addr(smem);
    __shared__ float4 tab[2][H_MAX];
    __shared__ float d[F_MAX], y[F_MAX], z[F_MAX];
    __shared__ float rows_full[F_MAX], rows_off[F_MAX];
    __shared__ float floor_s;
    const int tid = threadIdx.x;
    const int h = m / 2;
    const int nrow = row_threads(m, split);
    // roles: 0 row warps, 1 Q warps, 2 angle warp(s); idle lanes do nothing
    const int role = tid < nrow ? 0 : tid < 2 * nrow ? 1 : 2;
    const int u = tid - role * nrow;           // 0 .. within the role
    const bool live = role == 2 ? u < h : u < split * m;
    const int i = u % m, g = u / m;            // a row's thread g of split

    if (tid < m) {
        d[tid] = __fsqrt_rn(add(A[tid * m + tid], eps));
        y[tid] = b[tid];
    }
    __syncthreads();
    for (int e = tid; e < m * m; e += blockDim.x) {
        const int r = e / m, c = e % m;
        smem[r * ld + c] = dvd(A[e], mul(d[r], d[c]));
        smem[vb + r * ld + c] = r == c ? 1.f : 0.f;
    }
    __syncthreads();
    // the stop rule's norm and first test; round 0's angles
    if (role == 0 && live && g == 0) {
        rows_full[i] = row_squares(sh, ld, i, m, false);
        rows_off[i] = row_squares(sh, ld, i, m, true);
    }
    if (role == 2 && live) {         // pair u = (u, m - 1 - u) in round 0
        const int p = u, q = m - 1 - u;
        tab[0][u] = angle(smem[p * ld + p], smem[q * ld + q],
                          smem[p * ld + q], p, q);
    }
    __syncthreads();
    const float thr = mul(tol2, rows_total(rows_full, m));

    // the schedule, stepped round by round: a row thread's position; an
    // angle lane's pair u of the next round is the rows at positions sa, sb
    // of this one (pairs pa, pb, fixed), holding indices ia, ib
    int pos = i;
    const int sa = shift_from(u, m), sbp = shift_from(m - 1 - u, m);
    const int pa = pair_at(sa, m), pb = pair_at(sbp, m);
    int ia = sa, ib = sbp;
    const uint32_t tb = shared_addr(&tab[0][0]);
    int cur = 0, sweep = 0;
    while (sweep < max_sweeps && !(rows_total(rows_off, m) <= thr)) {
        ++sweep;
        for (int r = 0; r < m - 1; ++r) {
            const uint32_t sb = sh + 4u * (cur * m * ld);
            const uint32_t sn = sh + 4u * ((cur ^ 1) * m * ld);
            const uint32_t T = tb + 16u * (cur * H_MAX);
            if (role == 0 && live) {
                const int P = pair_at(pos, m);
                const Rot R1 = rot_at(T, P);
                const bool ip = i == R1.p;
                if (g == 0) {
                    sts(sn, i * ld + i, diag_new(sb, ld, i, R1));
                    sts(sn, i * ld + (ip ? R1.q : R1.p), 0.f);
                }
                // blocks (P, P + v mod h), v = 1 .. h/2 (at v = h/2, h even,
                // only from the smaller pair): each block of the round once,
                // written with its mirror
                for (int v = 1 + g; 2 * v <= h; v += split) {
                    const bool lt = P + v < h;
                    if (2 * v == h && !lt) continue;
                    const Rot R2 = rot_at(T, lt ? P + v : P + v - h);
                    float yp, yq;
                    off_new(sb, ld, ip, R1, R2, lt, yp, yq);
                    sts(sn, i * ld + R2.p, yp);
                    sts(sn, i * ld + R2.q, yq);
                    sts(sn, R2.p * ld + i, yp);
                    sts(sn, R2.q * ld + i, yq);
                }
            } else if (role == 1 && live) {
                // QBATCH pairs' columns loaded, then rotated, then stored
                const uint32_t vi = sh + 4u * (vb + i * ld);
                for (int Q0 = g; Q0 < h; Q0 += QBATCH * split) {
                    Rot R[QBATCH];
                    float vp[QBATCH], vq[QBATCH];
#pragma unroll
                    for (int k = 0; k < QBATCH; ++k)
                        if (Q0 + k * split < h) {
                            R[k] = rot_at(T, Q0 + k * split);
                            vp[k] = lds(vi, R[k].p);
                            vq[k] = lds(vi, R[k].q);
                        }
#pragma unroll
                    for (int k = 0; k < QBATCH; ++k)
                        if (Q0 + k * split < h) {
                            sts(vi, R[k].p,
                                sub(mul(R[k].c, vp[k]), mul(R[k].s, vq[k])));
                            sts(vi, R[k].q,
                                add(mul(R[k].s, vp[k]), mul(R[k].c, vq[k])));
                        }
                }
            } else if (role == 2) {
                // pair u of the next round (round 0 of the next sweep after
                // the last), from this round's S and angles
                if (live) {
                    const Rot Ra = rot_at(T, pa), Rb = rot_at(T, pb);
                    const bool ab = ia < ib;            // a's row is p
                    const int p = ab ? ia : ib, q = ab ? ib : ia;
                    const Rot Rp = pick(ab, Ra, Rb), Rq = pick(ab, Rb, Ra);
                    const float app = diag_new(sb, ld, p, Rp);
                    const float aqq = diag_new(sb, ld, q, Rq);
                    float apq = 0.f;
                    if (pa != pb) {
                        float yp, yq;
                        off_new(sb, ld, p == Rp.p, Rp, Rq,
                                (ab ? pa : pb) < (ab ? pb : pa), yp, yq);
                        apq = q == Rq.p ? yp : yq;
                    }
                    const float4 e = angle(app, aqq, apq, p, q);
                    asm volatile(
                        "st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                            tb + 16u * ((cur ^ 1) * H_MAX + u)),
                        "f"(e.x), "f"(e.y), "f"(e.z), "f"(e.w)
                        : "memory");
                }
            }
            __syncthreads();
            cur ^= 1;
            pos = pos == m - 1 ? m - 1 : pos == 0 ? m - 2 : pos - 1;
            ia = next_index(ia, m);
            ib = next_index(ib, m);
        }
        if (role == 0 && live && g == 0)
            rows_off[i] = row_squares(sh + 4u * (cur * m * ld), ld, i, m,
                                      true);
        __syncthreads();
    }

    // the floor, then w = Q diag(inv) Q^T (b/d) / d
    const int sb = cur * m * ld;
    if (tid == 0) {
        float mx = smem[sb];
        for (int k = 1; k < m; ++k) {
            const float x = smem[sb + k * ld + k];
            mx = x > mx ? x : mx;
        }
        floor_s = mul(rel_floor, mx);
    }
    if (tid < m) y[tid] = dvd(y[tid], d[tid]);
    __syncthreads();
    if (tid < m) {
        const float lam = smem[sb + tid * ld + tid];
        const float inv = lam > floor_s ? dvd(1.f, lam) : 0.f;
        float acc = 0.f;
        for (int k = 0; k < m; ++k)
            acc = add(acc, mul(smem[vb + k * ld + tid], y[k]));
        z[tid] = mul(acc, inv);
    }
    __syncthreads();
    if (tid < m) {
        float acc = 0.f;
        for (int k = 0; k < m; ++k)
            acc = add(acc, mul(smem[vb + tid * ld + k], z[k]));
        const float wi = dvd(acc, d[tid]);
        w[tid] = isfinite(wi) ? wi : 0.f;
    }
    if (sweeps_out && tid == 0) sweeps_out[0] = sweep;
}

}  // namespace

// A (F, F) symmetric and b (F,) fp32 on the device, F even and <= 68; w
// (F,) out; the sweeps run (one int32) out when not null.
extern "C" int trpo_fit_normal_launch(const float* A, const float* b,
                                      float* w, int* sweeps, int F, float eps,
                                      float rel_floor, float tol2,
                                      int max_sweeps, void* stream) {
    if (F < 2 || F > F_MAX || (F & 1)) return (int)cudaErrorInvalidValue;
    // the shared memory opt-in once per device, for the largest system:
    // the host call takes longer than a small system's solve
    static bool done[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !done[dev]) {
        err = cudaFuncSetAttribute(fit_normal_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   3 * F_MAX * (F_MAX + 1) * (int)sizeof(float));
        if (err != cudaSuccess) return (int)err;
        if (dev < 64) done[dev] = true;
    }
    const int split = split_for(F);
    const int smem = 3 * F * (F + 1) * (int)sizeof(float);
    fit_normal_kernel<<<1, block_threads(F, split), smem,
                        static_cast<cudaStream_t>(stream)>>>(
        A, b, w, sweeps, F, split, eps, rel_floor, tol2, max_sweeps);
    return (int)cudaGetLastError();
}
