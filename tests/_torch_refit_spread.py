"""How far the linear baseline's ridge refit moves when only the order of
its fp32 sums changes, at c3's full width, in the port and in the JAX
package (ROADMAP C5); no tests here.

  python tests/_torch_refit_spread.py [SEED ...]     (default 49 50 51 52)

For each seed, one c3 batch (4096 envs x 200 steps, bf16 storage, F 52)
from the port's plain rollout on the CPU (``envs/arm.make_rollout_fn``
with ``init_state(cfg, seed)``, as ``chip_smoke.py`` phase 13b makes its
batches on the card, but from the CPU generator: other draws). The
update's step 1 up to the solve: values from the zero baseline, GAE, the
targets. The fp32 normal equations (``baseline.normal_eq_ff``, the
reference form K2 is held to) in two orders: the whole batch, and the two
env halves each summed and then added (what two data ranks all-reduce);
the ridge added after. Each solved by JAX's ``models/baseline.py``
``fit_normal`` (XLA's eigh), the port's plain ``fit_normal`` (torch's
eigh) and the fit_normal kernel's arithmetic
(``tests/test_torch_helpers.fit_normal_jacobi_statement``), and in fp64
(the same floor) from the normal equations summed exactly in fp64. Prints,
per seed and solver: the solve's move between the two orders and each
order's error against the fp64 solve, in the A-norm (the relative RMS
error of the predictions over the batch) and in the max form (max |dv|
over the mean |v|, tests/test_sharding.py's form), and the kept
directions and condition number.
"""
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import conftest  # noqa: E402,F401  (JAX on the CPU, as the tests)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_helpers import (a_norm_rel, fit_normal_jacobi_statement,  # noqa: E402
                                fp64_floored_solve)
from trpo_robot_control_tpu.models import baseline as jb  # noqa: E402
from trpo_robot_control_tpu_torch.configs import C3_FRANKA7  # noqa: E402
from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn  # noqa: E402
from trpo_robot_control_tpu_torch.models import baseline as pb  # noqa: E402
from trpo_robot_control_tpu_torch.ops.cuda.fit_kernel import \
    fit_normal_plain  # noqa: E402
from trpo_robot_control_tpu_torch.ops.gae import gae  # noqa: E402
from trpo_robot_control_tpu_torch.trpo.train import init_state  # noqa: E402

SEEDS = (49, 50, 51, 52)


def normal_equations(cfg, batch):
    """(rows, {"whole"|"halves": (A + ridge I, b) fp32}, fp64 exact (A, b),
    phi (B, F) fp64 for the predictions)."""
    tr = cfg.trpo
    obs_ff, rew = batch["obs_ff"], batch["rewards_ff"]
    T, do, N = obs_ff.shape
    w0 = torch.zeros(pb.n_features(do))
    values = pb.values_ff(w0, obs_ff, cfg.horizon)
    targets = gae(rew, values, tr.gamma, tr.lam, time_axis=0) + values
    ridge = tr.baseline_reg * torch.eye(pb.n_features(do))
    whole = pb.normal_eq_ff(obs_ff, targets, cfg.horizon)
    h = N // 2
    halves = [pb.normal_eq_ff(obs_ff[..., s].contiguous(),
                              targets[:, s].contiguous(), cfg.horizon)
              for s in (slice(0, h), slice(h, N))]
    systems = {"whole": (whole[0] + ridge, whole[1]),
               "halves": (halves[0][0] + halves[1][0] + ridge,
                          halves[0][1] + halves[1][1])}
    tau = pb._time_features(T, cfg.horizon, obs_ff.device).double()
    v = pb.data_rows(obs_ff, targets).double()               # (T, 2do+1, N)
    phi = torch.cat([v[:, :2 * do].permute(0, 2, 1),
                     tau[:, None, :].expand(T, N, 4)], -1).reshape(-1, 2 * do + 4)
    y = v[:, 2 * do].reshape(-1)
    exact = (phi.T @ phi + ridge.double(), phi.T @ y)
    return systems, exact, phi


def solvers():
    j_fit = jax.jit(jb.fit_normal)
    return {"JAX (XLA eigh)": lambda A, b: torch.tensor(np.asarray(
                j_fit(jnp.asarray(A.numpy()), jnp.asarray(b.numpy())))),
            "port plain (torch eigh)": fit_normal_plain,
            "kernel's Jacobi": lambda A, b: fit_normal_jacobi_statement(
                A, b)[0]}


def max_form(phi, w, ref):
    v, v_ref = phi @ w.double(), phi @ ref.double()
    return float((v - v_ref).abs().max() / (v_ref.abs().mean() + 1e-6))


def main(seeds):
    torch.set_num_threads(4)
    cfg = C3_FRANKA7
    for seed in seeds:
        t0 = time.perf_counter()
        st = init_state(cfg, seed=seed, device="cpu")
        batch = make_rollout_fn(cfg)(st.params, st.gen)
        systems, (A64, b64), phi = normal_equations(cfg, batch)
        w64, cond64 = fp64_floored_solve(A64, b64)
        A_w, b_w = systems["whole"]
        d = torch.sqrt(torch.diagonal(A64))
        dA = float(((systems["halves"][0] - A_w).double().abs()
                    / (d[:, None] * d[None, :])).max())
        print(f"seed {seed} ({time.perf_counter() - t0:.0f} s to make): "
              f"|dA| between the orders {dA:.3e} of sqrt(A_ii A_jj); fp64 "
              f"kept condition {cond64:.3e}", flush=True)
        for name, solve in solvers().items():
            w = {k: solve(*systems[k]).double() for k in systems}
            kept = fp64_floored_solve(*systems["whole"])[1]
            print(f"  {name}: whole -> halves moves A-norm "
                  f"{a_norm_rel(A64, w['halves'], w['whole']):.3e} / max "
                  f"{max_form(phi, w['halves'], w['whole']):.3e}; against "
                  f"fp64, whole {a_norm_rel(A64, w['whole'], w64):.3e} / "
                  f"{max_form(phi, w['whole'], w64):.3e}, halves "
                  f"{a_norm_rel(A64, w['halves'], w64):.3e} / "
                  f"{max_form(phi, w['halves'], w64):.3e} (fp32 kept "
                  f"condition {kept:.3e})", flush=True)


if __name__ == "__main__":
    main([int(s) for s in sys.argv[1:]] or SEEDS)
