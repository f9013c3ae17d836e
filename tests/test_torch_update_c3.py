"""The c3 slice as a whole: the port's ``trpo_update`` against the JAX
package's on the same bf16 batch and the same carried-over params at c3
(7-DoF arm with gravity, bf16 storage, Fisher time stride 8, line search
on every 8th env), cut to N = 128 envs x T = 16 steps. Held to
``tests/test_parity.py``'s criteria: direction cosine >= 0.999, |beta|
relative error <= 1e-3, the same accepted exponent; then three training
iterations with shared per-iteration noise must accept the same exponents.

The JAX side keeps ``auto``, which on the CPU takes its twins
(``surrogate_grad_ff(store_dtype=bf16)``, ``make_gn_fvp`` on the fp32
relayout). The port's config forces the surrogate-gradient (K5) and
feature-first FVP (K6) routes at this size; their plain versions on the
CPU are those same twins."""
import dataclasses

import numpy as np
import torch

import jax

from test_torch_helpers import (cosine, env_inputs_np, j, jax_batch3d, n,
                                policy_params_np, t, torch_batch_from_jax)
from trpo_robot_control_tpu.configs import C3_FRANKA7 as J_C3
from trpo_robot_control_tpu.trpo.update import trpo_update as j_update
from trpo_robot_control_tpu_torch.configs import C3_FRANKA7 as P_C3
from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel
from trpo_robot_control_tpu_torch.trpo.update import trpo_update
from trpo_robot_control_tpu_torch.utils.convert import (params_from_numpy,
                                                        params_to_numpy,
                                                        w_from_numpy)

N, T = 128, 16
JCFG = J_C3.replace(n_envs=N, horizon=T)
PCFG = P_C3.replace(n_envs=N, horizon=T, trpo=dataclasses.replace(
    P_C3.trpo, surrgrad_impl="pallas", fvp_impl="pallas"))
_J_UPDATE = jax.jit(lambda p, w, b: j_update(JCFG, p, w, b,
                                             return_directions=True))


def _params_np(seed):
    return policy_params_np(np.random.RandomState(seed), JCFG.obs_dim, 7)


def test_update_parity_c3():
    pn = _params_np(1)
    w0 = np.zeros(2 * JCFG.obs_dim + 4, np.float32)
    bj = jax_batch3d(JCFG, pn, *env_inputs_np(JCFG, N, seed=2))
    new_j, _, st_j = _J_UPDATE({k: j(v) for k, v in pn.items()}, j(w0), bj)
    kernels.reset_counts()
    new_t, w_t, st_t = trpo_update(PCFG, params_from_numpy(pn, "cpu"),
                                   w_from_numpy(w0, "cpu"),
                                   torch_batch_from_jax(bj),
                                   return_directions=True)
    # the K5 and K6 routes ran (through their plain versions on the CPU)
    assert kernels.plain_calls()["pg"] == 1
    assert kernels.plain_calls()["fvp_ff"] == PCFG.trpo.cg_iters
    assert kernels.plain_calls()["fvp"] == 0
    assert cosine(n(st_t["g"]), st_j["g"]) > 0.9995
    assert cosine(n(st_t["x"]), st_j["x"]) >= 0.999
    beta_j = float(st_j["beta"])
    assert abs(float(st_t["beta"]) - beta_j) / beta_j <= 1e-3
    assert int(st_t["accepted"]) == int(st_j["accepted"])
    for k in ("kl", "surr", "surr_old", "mean_return", "adv_std", "entropy"):
        np.testing.assert_allclose(float(st_t[k]), float(st_j[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    th_j = np.asarray(jax.flatten_util.ravel_pytree(new_j)[0])
    np.testing.assert_allclose(n(ppol.flatten(new_t)), th_j, rtol=1e-2,
                               atol=1e-3)
    assert w_t.shape == (2 * JCFG.obs_dim + 4,)
    assert bool(torch.isfinite(w_t).all())


def test_three_iterations_accept_the_same_c3():
    """Each package collects its own bf16 batch with its own params from
    the same per-iteration states and noise, then updates; the accepted
    line-search exponents must agree iteration by iteration."""
    pn = _params_np(3)
    p_j = {k: j(v) for k, v in pn.items()}
    w_j = j(np.zeros(2 * JCFG.obs_dim + 4))
    p_t = params_from_numpy(pn, "cpu")
    w_t = w_from_numpy(np.zeros(2 * JCFG.obs_dim + 4), "cpu")
    acc_j, acc_t = [], []
    for it in range(3):
        q0, qd0, tgt, eps = env_inputs_np(JCFG, N, seed=10 + it)
        bj = jax_batch3d(JCFG, {k: np.asarray(v) for k, v in p_j.items()},
                         q0, qd0, tgt, eps)
        bt = batch_from_ff(*rollout3d_kernel.rollout3d(
            PCFG, p_t, t(q0), t(qd0), t(tgt),
            torch.zeros(N, dtype=torch.int32), eps=t(eps),
            store_dtype=torch.bfloat16))
        p_j, w_j, st_j = _J_UPDATE(p_j, w_j, bj)
        p_t, w_t, st_t = trpo_update(PCFG, p_t, w_t, bt)
        acc_j.append(int(st_j["accepted"]))
        acc_t.append(int(st_t["accepted"]))
        np.testing.assert_allclose(float(st_t["mean_return"]),
                                   float(st_j["mean_return"]), rtol=1e-3)
        np.testing.assert_allclose(float(st_t["kl"]), float(st_j["kl"]),
                                   rtol=5e-2)
    assert acc_t == acc_j
    th0 = n(ppol.flatten(params_from_numpy(pn, "cpu")))
    th_j = np.asarray(jax.flatten_util.ravel_pytree(p_j)[0])
    moved = params_to_numpy(p_t)
    th_t = np.concatenate([moved[k].reshape(-1) for k in sorted(moved)])
    assert cosine(th_t - th0, th_j - th0) > 0.99


def test_convert_carries_c3_params():
    """The numpy carriers hold c3's 24 -> 64 -> 64 -> 7 policy and its 52
    baseline weights unchanged, in the JAX package's flat order."""
    pn = _params_np(4)
    back = params_to_numpy(params_from_numpy(pn, "cpu"))
    assert set(back) == set(pn)
    for k in pn:
        assert back[k].dtype == np.float32
        np.testing.assert_array_equal(back[k], pn[k])
    flat_j = np.asarray(jax.flatten_util.ravel_pytree(
        {k: j(v) for k, v in pn.items()})[0])
    flat_t = n(ppol.flatten(params_from_numpy(pn, "cpu")))
    np.testing.assert_array_equal(flat_t, flat_j)
    assert flat_j.shape == (6222,)
    w = np.arange(52, dtype=np.float32)
    np.testing.assert_array_equal(n(w_from_numpy(w, "cpu")), w)
