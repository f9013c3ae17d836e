// The policy MLP's hidden widths, fixed per library: -DTRPO_H0=w0
// [-DTRPO_H1=w1 [-DTRPO_H2=w2]] (1-3 hidden layers; ops/cuda/build.py
// builds one library per shape a run asks for), the JAX package's default
// (64, 64) without them. The kernels that run the MLP (rollout.cu,
// fvp.cu, rollout3d.cu, pg.cu, fvp_ff.cu) take the widths as compile-time
// constants, so the (64, 64) library compiles the same code as before the
// shape became a parameter. Each source states its own cap on the widths
// (build.MAX_WIDTH): 128 for the two rollouts and the batch-major FVP,
// which select a wide form past PACKED_MAX (WIDE), 64 for the surrogate
// gradient and the feature-first FVP.
#pragma once

namespace policy_shape {

template <int... W>
struct Shape {
    static constexpr int NL = sizeof...(W);     // hidden layers
    // width of hidden layer l
    __host__ __device__ static constexpr int width(int l) {
        const int w[] = {W...};
        return w[l];
    }
    // the widest layer
    __host__ __device__ static constexpr int widest() {
        const int w[] = {W...};
        int m = 0;
        for (int l = 0; l < NL; ++l) m = w[l] > m ? w[l] : m;
        return m;
    }
};

#if defined(TRPO_H2)
using Hidden = Shape<TRPO_H0, TRPO_H1, TRPO_H2>;
#elif defined(TRPO_H1)
using Hidden = Shape<TRPO_H0, TRPO_H1>;
#elif defined(TRPO_H0)
using Hidden = Shape<TRPO_H0>;
#else
using Hidden = Shape<64, 64>;
#endif
constexpr int NL = Hidden::NL;
static_assert(NL >= 1 && NL <= 3, "1-3 hidden layers (ROADMAP B3 for more)");
// the widest layer of the packed forms, which every library of a policy
// up to this wide compiles; a wider one selects a kernel's wide form
constexpr int PACKED_MAX = 64;
constexpr bool WIDE = Hidden::widest() > PACKED_MAX;

// The policy's weights as a wrapper passes them to a kernel: W[l] (in,
// out) and b[l] row-major, l = 0..NL (NL the linear head), and logstd.
struct Weights {
    const float* W[4];
    const float* b[4];
    const float* logstd;
};

// Whether the caller's hidden widths (n_hidden ints, host) are this
// library's.
inline bool same_shape(const int* hidden, int n_hidden) {
    if (n_hidden != NL) return false;
    for (int l = 0; l < NL; ++l)
        if (hidden[l] != Hidden::width(l)) return false;
    return true;
}

// Weights from a host array of device pointers W0, b0, ..., W_NL, b_NL,
// logstd.
inline Weights weights_of(const float* const* w) {
    Weights p = {};
    for (int l = 0; l <= NL; ++l) {
        p.W[l] = w[2 * l];
        p.b[l] = w[2 * l + 1];
    }
    p.logstd = w[2 * NL + 2];
    return p;
}

// width of hidden layer l, rounded up to the mma.sync m16n8k16 tile
__host__ __device__ constexpr int padded(int l) {
    return (Hidden::width(l) + 15) / 16 * 16;
}

// width of layer l's input (the observation's do at l = 0) and output
// (the head's da at l = NL)
__host__ __device__ constexpr int in_width(int l, int DO) {
    return l == 0 ? DO : Hidden::width(l - 1);
}
__host__ __device__ constexpr int out_width(int l, int DA) {
    return l == NL ? DA : Hidden::width(l);
}

// Offsets into the flat parameter vector, sorted keys: W0, ..., W_NL,
// b0, ..., b_NL, logstd; P entries in all.
struct Flat {
    int W[4], b[4], ls, P;
};
__host__ __device__ inline Flat flat(int DO, int DA) {
    Flat f = {};
    int off = 0;
    for (int l = 0; l <= NL; ++l) {
        f.W[l] = off;
        off += in_width(l, DO) * out_width(l, DA);
    }
    for (int l = 0; l <= NL; ++l) {
        f.b[l] = off;
        off += out_width(l, DA);
    }
    f.ls = off;
    f.P = off + DA;
    return f;
}

}  // namespace policy_shape
