"""The c4/c5 slice as a whole: the port's ``trpo_update`` against the JAX
package's at c4 (obstacle cost, Fisher env stride 4) and c5 (three task
families, 27-wide observations, env stride 8), both with bf16 storage,
Fisher time stride 8 and the line search on every 8th env, cut to N = 128
envs x T = 16 steps. Held to ``tests/test_parity.py``'s criteria:
direction cosine >= 0.999, |beta| relative error <= 1e-3, the same
accepted exponent; then three training iterations must accept the same
exponents.

The JAX side keeps ``auto``, which on the CPU takes its twins
(``surrogate_grad_ff(store_dtype=bf16)``, ``make_gn_fvp`` on the flattened
time- and env-strided subsample). The port's config forces the
surrogate-gradient (K5) and feature-first FVP (K6) routes at this size;
their plain versions on the CPU are those same twins. The JAX rollout runs
op by op (~18 s a batch here), so it makes the parity batch only; in the
three iterations both packages update on the port's batch of the
iteration, collected with the port's params (the rollout itself is held
against ``rollout3d_reference`` in the parity test and in
``test_torch_tasks.py``)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_helpers import (cosine, env_inputs_np, j, jax_batch3d, n,
                                policy_params_np, t, tasks_np,
                                torch_batch_from_jax)
from trpo_robot_control_tpu.configs import CONFIGS as J_CONFIGS
from trpo_robot_control_tpu.trpo.update import trpo_update as j_update
from trpo_robot_control_tpu_torch.configs import CONFIGS as P_CONFIGS
from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
from trpo_robot_control_tpu_torch.trpo.update import trpo_update
from trpo_robot_control_tpu_torch.utils.convert import (params_from_numpy,
                                                        w_from_numpy)

N, T = 128, 16
NAMES = ["c4_franka7_obstacle", "c5_multitask"]


@functools.lru_cache(maxsize=None)
def _setup(name):
    jcfg = J_CONFIGS[name].replace(n_envs=N, horizon=T)
    pcfg = P_CONFIGS[name].replace(n_envs=N, horizon=T, trpo=dataclasses.replace(
        P_CONFIGS[name].trpo, surrgrad_impl="pallas", fvp_impl="pallas"))
    j_up = jax.jit(lambda p, w, b: j_update(jcfg, p, w, b,
                                            return_directions=True))
    return jcfg, pcfg, j_up


def _jax_batch(bt):
    """The port's batch as the JAX package's batch dict (bf16 stays bf16)."""
    def arr(x):
        out = jnp.asarray(n(x.float()))
        return out.astype(jnp.bfloat16) if x.dtype == torch.bfloat16 else out
    return dict(obs=arr(bt["obs"].float()), actions=arr(bt["actions"].float()),
                rewards=arr(bt["rewards"]), obs_ff=arr(bt["obs_ff"]),
                actions_ff=arr(bt["actions_ff"]),
                rewards_ff=arr(bt["rewards_ff"]))


@pytest.mark.parametrize("name", NAMES)
def test_update_parity_c4_c5(name):
    jcfg, pcfg, j_up = _setup(name)
    pn = policy_params_np(np.random.RandomState(1), jcfg.obs_dim, 7)
    w0 = np.zeros(2 * jcfg.obs_dim + 4, np.float32)
    ins = env_inputs_np(jcfg, N, seed=2)
    task = tasks_np(jcfg, N, seed=3)
    bj = jax_batch3d(jcfg, pn, *ins, task=task)
    # the port's rollout of the same inputs, at the kernel's tolerance
    obs, act, rew = r3.rollout3d(pcfg, params_from_numpy(pn, "cpu"),
                                 *(t(x) for x in ins[:3]), torch.tensor(task),
                                 eps=t(ins[3]))
    for mine, key in ((obs, "obs"), (act, "actions")):
        ref = np.transpose(np.asarray(bj[key]), (1, 2, 0))
        np.testing.assert_allclose(n(mine)[:8], ref[:8], atol=1e-5)
    np.testing.assert_allclose(n(rew)[:8], np.asarray(bj["rewards_ff"])[:8],
                               atol=1e-5)

    new_j, _, st_j = j_up({k: j(v) for k, v in pn.items()}, j(w0), bj)
    kernels.reset_counts()
    new_t, w_t, st_t = trpo_update(pcfg, params_from_numpy(pn, "cpu"),
                                   w_from_numpy(w0, "cpu"),
                                   torch_batch_from_jax(bj),
                                   return_directions=True)
    # the K5 and K6 routes ran (through their plain versions on the CPU)
    assert kernels.plain_calls()["pg"] == 1
    assert kernels.plain_calls()["fvp_ff"] == pcfg.trpo.cg_iters
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
    assert w_t.shape == (2 * jcfg.obs_dim + 4,)
    assert bool(torch.isfinite(w_t).all())


@pytest.mark.parametrize("name", NAMES)
def test_three_iterations_accept_the_same_c4_c5(name):
    jcfg, pcfg, j_up = _setup(name)
    pn = policy_params_np(np.random.RandomState(4), jcfg.obs_dim, 7)
    p_j = {k: j(v) for k, v in pn.items()}
    w_j = j(np.zeros(2 * jcfg.obs_dim + 4))
    p_t = params_from_numpy(pn, "cpu")
    w_t = w_from_numpy(np.zeros(2 * jcfg.obs_dim + 4), "cpu")
    acc_j, acc_t = [], []
    for it in range(3):
        q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=10 + it)
        bt = batch_from_ff(*r3.rollout3d(
            pcfg, p_t, t(q0), t(qd0), t(tgt),
            torch.tensor(tasks_np(jcfg, N, seed=20 + it)), eps=t(eps),
            store_dtype=torch.bfloat16))
        p_j, w_j, st_j = j_up(p_j, w_j, _jax_batch(bt))
        p_t, w_t, st_t = trpo_update(pcfg, p_t, w_t, bt)
        acc_j.append(int(st_j["accepted"]))
        acc_t.append(int(st_t["accepted"]))
        np.testing.assert_allclose(float(st_t["kl"]), float(st_j["kl"]),
                                   rtol=5e-2)
    assert acc_t == acc_j
    th0 = n(ppol.flatten(params_from_numpy(pn, "cpu")))
    th_j = np.asarray(jax.flatten_util.ravel_pytree(p_j)[0])
    assert cosine(n(ppol.flatten(p_t)) - th0, th_j - th0) > 0.99
