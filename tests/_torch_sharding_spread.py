"""How far a change in the order of the update's sums moves theta, in the
port and in the JAX package, at ``tests/test_torch_sharding.py``'s c1
(32 envs x 20 steps, test_sharding.py's ``_collect``); no tests here.

  python tests/_torch_sharding_spread.py [N_BATCHES]

(1) For each batch (rollout key 42 + i) and each of the sharding test's
update cases, the one-process update on the batch and on the same envs in
another order (the two halves swapped, which keeps every env stride's
samples): max |d theta|, its excess over test_sharding.py's bound (rtol
2e-3, atol 2e-4; > 0 is over) and |dg| / |g|, port and JAX. (2) On the
first batch's batch-major Fisher: the eigenvalues of the damped F, how far
ten fp32 CG iterations land from ten fp64 ones, and how far x moves when
g changes by 3e-7 relative, through the port's FVP, a dense fp32 F, JAX's
FVP and a dense fp64 F.
"""
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (JAX on eight CPU devices, as the tests)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

import _torch_sharding_worker as W  # noqa: E402
import test_torch_sharding as T  # noqa: E402
from test_torch_helpers import jit_jax_rollout  # noqa: E402
from trpo_robot_control_tpu.ops import fvp as jfvp  # noqa: E402
from trpo_robot_control_tpu.ops.cg import \
    conjugate_gradient as j_cg  # noqa: E402
from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff  # noqa: E402
from trpo_robot_control_tpu_torch.ops.cg import \
    conjugate_gradient  # noqa: E402
from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp  # noqa: E402
from trpo_robot_control_tpu_torch.trpo.update import trpo_update  # noqa: E402


def inputs(i):
    """The sharding test's inputs on the batch of rollout key 42 + i."""
    state = T.j_init_state(T._jcfg("mlp"), 0)
    bm = jit_jax_rollout(T._jcfg("bm"))(state.params,
                                        jax.random.PRNGKey(42 + i))
    bm = {k: np.asarray(v) for k, v in bm.items()}
    params = {k: np.asarray(v) for k, v in state.params.items()}
    ff = {"obs_ff": bm["obs"].transpose(1, 2, 0),
          "actions_ff": bm["actions"].transpose(1, 2, 0),
          "rewards_ff": bm["rewards"].T}
    w0 = {"w": np.zeros(2 * params["W0"].shape[0] + 4, np.float32)}
    w_mlp = {k: np.asarray(v) for k, v in state.w.items()}
    return {"ff": (params, w0, ff), "bm": (params, w0, bm),
            "sub": (params, w0, bm), "mlp": (params, w_mlp, bm)}


def swapped(batch):
    """The same envs with the two halves swapped."""
    return {k: np.roll(v, v.shape[v.ndim - 1 if k.endswith("_ff") else 0]
                       // 2, axis=v.ndim - 1 if k.endswith("_ff") else 0)
            for k, v in batch.items()}


def port_update(case, params, w, batch):
    p = {k: torch.tensor(v) for k, v in params.items()}
    w = torch.tensor(w["w"]) if set(w) == {"w"} else \
        {k: torch.tensor(v) for k, v in w.items()}
    b = {k: torch.tensor(v) for k, v in batch.items()}
    if "obs_ff" in b:
        b = batch_from_ff(b["obs_ff"], b["actions_ff"], b["rewards_ff"])
    new, _, st = trpo_update(W.config(case), p, w, b, return_directions=True)
    return W._flat(new), st["g"].numpy()


def jax_update(case, params, w, batch):
    cfg = T._jcfg(case)
    w = w["w"] if set(w) == {"w"} else w
    new, _, st = jax.jit(lambda p, w, b: T.j_update(
        cfg, p, w, b, return_directions=True))(
        {k: jnp.asarray(v) for k, v in params.items()},
        jax.tree.map(jnp.asarray, w), T._jax_batch(batch))
    return np.asarray(ravel_pytree(new)[0]), np.asarray(st["g"])


def over(theta, ref):
    return float(np.max(np.abs(theta - ref) - (2e-4 + 2e-3 * np.abs(ref))))


def rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def order_spread(n_batches):
    for i in range(n_batches):
        for case, (params, w, batch) in inputs(i).items():
            line = [f"batch {i} {case:4s}"]
            for name, fn in (("port", port_update), ("jax", jax_update)):
                th, g = fn(case, params, w, batch)
                th_s, g_s = fn(case, params, w, swapped(batch))
                line.append(f"{name} max |dtheta| "
                            f"{np.abs(th - th_s).max():.2e} (over "
                            f"{over(th_s, th):+.1e}), |dg|/|g| "
                            f"{rel(g_s, g):.1e}")
            print("; ".join(line), flush=True)


def cg_sensitivity():
    torch.set_num_threads(1)
    params, _, batch = inputs(0)["bm"]
    cfg = T._jcfg("bm")
    obs = batch["obs"].reshape(-1, batch["obs"].shape[-1])
    damping, P = cfg.trpo.cg_damping, sum(v.size for v in params.values())
    f_port = make_gn_fvp({k: torch.tensor(v) for k, v in params.items()},
                         torch.tensor(obs), damping)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    f_jax = jfvp.make_gn_fvp(jp, ravel_pytree(jp)[1], jnp.asarray(obs),
                             damping)
    F = np.stack([f_port(torch.tensor(e)).numpy().astype(np.float64)
                  for e in np.eye(P, dtype=np.float32)], 1)
    F = (F + F.T) / 2
    lam = np.linalg.eigvalsh(F)
    rng = np.random.RandomState(0)
    g = (rng.standard_normal(P) * 1e-2).astype(np.float32)
    g2 = g * (1 + rng.standard_normal(P).astype(np.float32) * 3e-7)
    F32, F64 = torch.tensor(F.astype(np.float32)), torch.tensor(F)
    solvers = {
        "port FVP": lambda g: conjugate_gradient(
            f_port, torch.tensor(g), 10)[0].numpy(),
        "dense fp32 F": lambda g: conjugate_gradient(
            lambda v: F32 @ v, torch.tensor(g), 10)[0].numpy(),
        "JAX FVP": lambda g: np.asarray(jax.jit(
            lambda g: j_cg(f_jax, g, 10)[0])(jnp.asarray(g))),
        "dense fp64 F": lambda g: conjugate_gradient(
            lambda v: F64 @ v, torch.tensor(g.astype(np.float64)),
            10)[0].numpy()}
    x64 = solvers["dense fp64 F"](g)
    print(f"batch 0 bm Fisher: eigenvalues {lam[0]:.4g} to {lam[-1]:.4g}")
    for name, solve in solvers.items():
        x = solve(g)
        print(f"{name}: x from the fp64 CG {rel(x, x64):.2e}; x moved by "
              f"{rel(solve(g2), x):.2e} for g moved by {rel(g2, g):.1e}")


if __name__ == "__main__":
    order_spread(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
    cg_sensitivity()
