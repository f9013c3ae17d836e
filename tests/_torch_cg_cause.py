"""Where the fp32 CG step's sensitivity to summation order comes from, in
the port and in the JAX package (ROADMAP C4), at
``tests/test_torch_sharding.py``'s c1 (32 envs x 20 steps, the batch of
rollout key 42 + i, the batch-major Fisher of 640 samples); no tests here.

  python tests/_torch_cg_cause.py [N_BATCHES]      (default 4)

(1) Fv at one fixed v (the sharding worker's, RandomState(11)) four ways:
the port's GN-FVP plain version (``ops/fvp.make_gn_fvp``), JAX's
``ops/fvp.py:make_gn_fvp``, the port's ``make_kl_fvp`` and the same GN
product in fp64; each fp32 one against the fp64 one: relative L2, the
worst entry's error over max |Fv| and the block it lies in, on the first
batch. (2) On each batch, ten CG iterations on the update's own g (the
port's one-process update), the
loops and the FVPs swapped: the port's loop (``ops/cg.py``, torch.dot), the
same loop with each dot accumulated in fp64 (its ``vdot``), JAX's
recurrence run in numpy (np.dot, fp32) and JAX's own jitted loop, each on
the port's and on JAX's Fv, and an fp64 loop on the fp64 product; for each,
x against the fp64 x, and how far x moves when (a) g moves by 3e-7
relative and (b) only the order of the samples changes (the envs' halves
swapped, the Fisher built from the same 640 samples).
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import _torch_sharding_spread as S  # noqa: E402
import _torch_sharding_worker as W  # noqa: E402
from trpo_robot_control_tpu.ops import fvp as jfvp  # noqa: E402
from trpo_robot_control_tpu.ops.cg import \
    conjugate_gradient as j_cg  # noqa: E402
from trpo_robot_control_tpu_torch.ops.cg import \
    conjugate_gradient  # noqa: E402
from trpo_robot_control_tpu_torch.ops.cuda.fvp_kernel import \
    gn_fvp_math  # noqa: E402
from trpo_robot_control_tpu_torch.ops.fvp import (make_gn_fvp,  # noqa: E402
                                                  make_kl_fvp)

ITERS = 10


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def blocks(params):
    """[(key, start, end)] of the flat vector, sorted-key order."""
    out, off = [], 0
    for k in sorted(params):
        out.append((k, off, off + params[k].size))
        off += params[k].size
    return out


def fvps(params, obs, damping):
    """{name: fp32 numpy fvp} and the fp64 one, on (B, do) samples."""
    pt = {k: torch.tensor(v) for k, v in params.items()}
    ot = torch.tensor(obs)
    port = make_gn_fvp(pt, ot, damping)
    kl = make_kl_fvp(pt, ot, damping)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jf = jax.jit(jfvp.make_gn_fvp(jp, ravel_pytree(jp)[1], jnp.asarray(obs),
                                  damping))
    p64 = {k: v.double() for k, v in pt.items()}
    o64 = ot.double()
    hs64, h = [], o64
    for l in range(len(params) // 2 - 1):
        h = torch.tanh(h @ p64[f"W{l}"] + p64[f"b{l}"])
        hs64.append(h)
    scale64 = torch.exp(-2.0 * p64["logstd"]) / obs.shape[0]
    return ({"port GN": lambda v: port(torch.tensor(v)).numpy(),
             "JAX GN": lambda v: np.asarray(jf(jnp.asarray(v))),
             "port KL": lambda v: kl(torch.tensor(v)).detach().numpy()},
            lambda v: gn_fvp_math(p64, o64, hs64, scale64,
                                  torch.tensor(v, dtype=torch.float64),
                                  damping).numpy())


def cg_numpy(fvp, g, iters, eps=1e-12):
    """JAX's ops/cg.py recurrence in numpy fp32 (np.dot)."""
    g = g.astype(np.float32)
    x, r, p = np.zeros_like(g), g, g
    rdotr = np.float32(np.dot(g, g))
    for _ in range(iters):
        z = fvp(p).astype(np.float32)
        alpha = rdotr / (np.dot(p, z) + np.float32(eps))
        x = x + alpha * p
        r = r - alpha * z
        new = np.float32(np.dot(r, r))
        p = r + (new / (rdotr + np.float32(eps))) * p
        rdotr = new
    return x


def cg_torch(fvp, g, iters, vdot=None):
    return conjugate_gradient(lambda v: torch.tensor(fvp(v.numpy())),
                              torch.tensor(g), iters, vdot=vdot)[0].numpy()


def dot64(u, v):
    """torch.dot accumulated in fp64, rounded to fp32 once."""
    return torch.dot(u.double(), v.double()).float()


def cg_torch64(fvp, g, iters):
    return cg_torch(fvp, g, iters, vdot=dot64)


def samples(i):
    """(params, w, batch, obs (B, do), obs with the envs' halves swapped)."""
    params, w, batch = S.inputs(i)["bm"]
    do = batch["obs"].shape[-1]
    return (params, w, batch, batch["obs"].reshape(-1, do),
            S.swapped(batch)["obs"].reshape(-1, do))


def fv_errors(damping):
    params, _, _, obs, _ = samples(0)
    P = sum(v.size for v in params.values())
    v = np.random.RandomState(11).standard_normal(P).astype(np.float32)
    f32, f64 = fvps(params, obs, damping)
    ref = f64(v.astype(np.float64))
    print(f"(1) Fv at a fixed v, B = {obs.shape[0]}, P = {P}, damping "
          f"{damping}; against the fp64 GN product (|Fv| "
          f"{np.linalg.norm(ref):.4g})")
    for name, f in f32.items():
        fv = f(v).astype(np.float64)
        err = np.abs(fv - ref)
        i = int(np.argmax(err))
        key = next(k for k, a, b in blocks(params) if a <= i < b)
        per = ", ".join(f"{k} {rel(fv[a:b], ref[a:b]):.2e}"
                        for k, a, b in blocks(params))
        print(f"  {name}: relative L2 {rel(fv, ref):.3e}; worst entry "
              f"{err[i] / np.abs(ref).max():.3e} of max |Fv| (in {key}); "
              f"per block {per}")
    fv_p, fv_j = f32["port GN"](v), f32["JAX GN"](v)
    print(f"  port GN against JAX GN: relative L2 "
          f"{rel(fv_p.astype(np.float64), fv_j.astype(np.float64)):.3e}")


def loops_swapped(i, damping):
    params, w, batch, obs, obs_sw = samples(i)
    P = sum(v.size for v in params.values())
    f32, f64 = fvps(params, obs, damping)
    g = S.port_update("bm", params, w, batch)[1]
    rng = np.random.RandomState(0)
    g2 = (g * (1 + rng.standard_normal(P).astype(np.float32) * 3e-7)
          ).astype(np.float32)
    f32_sw, _ = fvps(params, obs_sw, damping)
    x64 = conjugate_gradient(lambda u: torch.tensor(f64(u.numpy())),
                             torch.tensor(g.astype(np.float64)),
                             ITERS)[0].numpy()
    x64_g2 = conjugate_gradient(lambda u: torch.tensor(f64(u.numpy())),
                                torch.tensor(g2.astype(np.float64)),
                                ITERS)[0].numpy()
    jp = {k: jnp.asarray(a) for k, a in params.items()}
    unravel = ravel_pytree(jp)[1]

    def jax_loop(o):
        f = jfvp.make_gn_fvp(jp, unravel, jnp.asarray(o), damping)
        run = jax.jit(lambda gg: j_cg(f, gg, ITERS)[0])
        return lambda gg: np.asarray(run(jnp.asarray(gg)))
    print(f"(2) batch {i}: {ITERS} CG iterations on the update's g (|g| "
          f"{np.linalg.norm(g):.4g}); x against the fp64 CG (fp64 x moves "
          f"{rel(x64_g2, x64):.2e} for g moved by {rel(g2, g):.1e}); x moved "
          f"by the 3e-7 change of g / by swapping the envs' halves")
    runs = {}
    for loop, cg in (("port loop (torch.dot)", cg_torch),
                     ("port loop (fp64-accumulated dot)", cg_torch64),
                     ("JAX loop in numpy (np.dot)", cg_numpy)):
        for fname in ("port GN", "JAX GN"):
            f, f_sw = f32[fname], f32_sw[fname]
            runs[f"{loop} on {fname}"] = (
                lambda gg, f=f, cg=cg: cg(f, gg, ITERS),
                lambda gg, f=f_sw, cg=cg: cg(f, gg, ITERS))
    runs["JAX loop jitted on JAX GN"] = (jax_loop(obs), jax_loop(obs_sw))
    for name, (solve, solve_sw) in runs.items():
        x = solve(g)
        print(f"  {name}: from fp64 {rel(x, x64):.3e}; moved "
              f"{rel(solve(g2), x):.3e} / {rel(solve_sw(g), x):.3e} "
              f"(max |dx| {np.abs(solve_sw(g) - x).max():.2e})")


def main(n_batches):
    torch.set_num_threads(1)
    damping = W.config("bm").trpo.cg_damping
    fv_errors(damping)
    for i in range(n_batches):
        loops_swapped(i, damping)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
