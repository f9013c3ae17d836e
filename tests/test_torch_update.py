"""The slice as a whole: the port's ``trpo_update`` against the JAX
package's on the same batch and the same carried-over params, held to
``tests/test_parity.py``'s criteria (direction cosine >= 0.999, |beta|
relative error <= 1e-3, the same accepted exponent), then three training
iterations with shared per-iteration noise that must accept the same
exponents. The JAX batch comes from the Pallas rollout in interpret mode
(so it carries obs_ff) and JAX's update runs its CPU twins under jit."""
import dataclasses

import numpy as np
import pytest

import jax

from test_torch_helpers import (cosine, env_inputs_np, j, jax_batch,
                                jit_jax_update, n, t, torch_batch_from_jax)
from trpo_robot_control_tpu.configs import CONFIGS as JCONFIGS
from trpo_robot_control_tpu.models import policy as jpol
from trpo_robot_control_tpu_torch.configs import CONFIGS as PCONFIGS
from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel
from trpo_robot_control_tpu_torch.trpo.update import trpo_update
from trpo_robot_control_tpu_torch.utils.convert import (params_from_numpy,
                                                        params_to_numpy,
                                                        w_from_numpy,
                                                        w_to_numpy)

CASES = [("c1_reacher2", 64, 10), ("c2_reacher3", 128, 16)]


def _cfgs(name, N, T):
    return (JCONFIGS[name].replace(n_envs=N, horizon=T),
            PCONFIGS[name].replace(n_envs=N, horizon=T))


def _init_np(jcfg, seed):
    p = jpol.init_params(jax.random.PRNGKey(seed), jcfg.obs_dim,
                         jcfg.arm.n_joints, jcfg.trpo.hidden,
                         jcfg.trpo.logstd_init)
    return {k: np.asarray(v) for k, v in p.items()}


# the last case takes a trust region wide enough that the line search
# backtracks (accepted exponent 1 on this batch)
@pytest.mark.parametrize("name,N,T,delta", [c + (None,) for c in CASES]
                         + [("c2_reacher3", 128, 16, 1.0)])
def test_update_parity(name, N, T, delta):
    jcfg, pcfg = _cfgs(name, N, T)
    if delta is not None:
        jcfg = jcfg.replace(trpo=dataclasses.replace(jcfg.trpo, delta=delta))
        pcfg = pcfg.replace(trpo=dataclasses.replace(pcfg.trpo, delta=delta))
    pn = _init_np(jcfg, seed=1)
    w0 = np.zeros(2 * jcfg.obs_dim + 4, np.float32)
    bj = jax_batch(jcfg, pn, *env_inputs_np(jcfg, N, seed=2))
    new_j, w_j, st_j = jit_jax_update(jcfg)({k: j(v) for k, v in pn.items()},
                                            j(w0), bj)
    new_t, w_t, st_t = trpo_update(pcfg, params_from_numpy(pn, "cpu"),
                                   w_from_numpy(w0, "cpu"),
                                   torch_batch_from_jax(bj),
                                   return_directions=True)
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
    # the refit baseline agrees in prediction space
    obs = np.asarray(bj["obs"]).reshape(-1, jcfg.obs_dim)
    tt = np.tile(np.arange(T) / T, N)[:, None]
    phi = np.concatenate([obs, obs ** 2, tt, tt ** 2, tt ** 3,
                          np.ones_like(tt)], axis=1)
    v_j, v_t = phi @ np.asarray(w_j), phi @ w_to_numpy(w_t)
    assert np.abs(v_t - v_j).max() / (np.abs(v_j).mean() + 1e-6) < 2e-2


@pytest.mark.parametrize("name,N,T", CASES)
def test_three_iterations_accept_the_same(name, N, T):
    """Each package collects its own batch with its own params from the
    same per-iteration states and noise, then updates; the accepted
    line-search exponents must agree iteration by iteration."""
    jcfg, pcfg = _cfgs(name, N, T)
    pn = _init_np(jcfg, seed=3)
    upd = jit_jax_update(jcfg)
    p_j = {k: j(v) for k, v in pn.items()}
    w_j = j(np.zeros(2 * jcfg.obs_dim + 4))
    p_t = params_from_numpy(pn, "cpu")
    w_t = w_from_numpy(np.zeros(2 * jcfg.obs_dim + 4), "cpu")
    acc_j, acc_t = [], []
    for it in range(3):
        q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=10 + it)
        bj = jax_batch(jcfg, {k: np.asarray(v) for k, v in p_j.items()},
                       q0, qd0, tgt, eps)
        bt = batch_from_ff(*rollout_kernel.rollout(
            pcfg, p_t, t(q0), t(qd0), t(tgt), eps=t(eps)))
        p_j, w_j, st_j = upd(p_j, w_j, bj)
        p_t, w_t, st_t = trpo_update(pcfg, p_t, w_t, bt)
        acc_j.append(int(st_j["accepted"]))
        acc_t.append(int(st_t["accepted"]))
        np.testing.assert_allclose(float(st_t["mean_return"]),
                                   float(st_j["mean_return"]), rtol=1e-3)
        # each package rolls out its own params, so from the second
        # iteration on the batches differ by compounded fp32 round-off
        np.testing.assert_allclose(float(st_t["kl"]), float(st_j["kl"]),
                                   rtol=5e-2)
    assert acc_t == acc_j
    # the total parameter movement: each package rolls out its own params,
    # so fp32 differences compound through three batches and updates
    th0 = n(ppol.flatten(params_from_numpy(pn, "cpu")))
    th_j = np.asarray(jax.flatten_util.ravel_pytree(p_j)[0])
    moved = params_to_numpy(p_t)
    th_t = np.concatenate([moved[k].reshape(-1) for k in sorted(moved)])
    assert cosine(th_t - th0, th_j - th0) > 0.99
