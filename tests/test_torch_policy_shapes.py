"""Policy shapes other than (64, 64) on the 7-DoF path (ROADMAP B3), on the
CPU against the JAX package: the plain versions of the 3-D rollout (K4),
the surrogate gradient (K5, fp32 and with bf16 rounding points) and the
feature-first FVP (K6) at 1-3 hidden layers of widths up to 64, the whole
c3 update at OpenAI Baselines' (32, 32) and at (64, 64, 64), and the
port's kernel resolver against the JAX package's width rule.
``test_torch_cuda.py`` holds the CUDA kernels to these plain versions on
the card."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from test_torch_helpers import (check_update_parity, env_inputs_np, j,
                                jax_batch3d, n, policy_params_np,
                                surrogate_grad_fp64, t, tasks_np)
from trpo_robot_control_tpu.configs import C3_FRANKA7 as J_C3
from trpo_robot_control_tpu.configs import C5_MULTITASK as J_C5
from trpo_robot_control_tpu.models import policy as jpol
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.pallas.pg_kernel import (
    pallas_surrogate_grad_ff, tiles_ok)
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import (fvp_ff_kernel, pg_kernel,
                                                   rollout3d_kernel)
from trpo_robot_control_tpu_torch.trpo.update import (kernel_routes,
                                                      trpo_update)
from trpo_robot_control_tpu_torch.utils.convert import (params_from_numpy,
                                                        w_from_numpy)

BF16 = jnp.bfloat16
# one and three hidden layers, Baselines' (32, 32), and widths that are no
# multiple of the kernels' tiles (JAX's tests/test_pallas_pg.py shape)
SHAPES = [(32,), (32, 32), (33, 57), (64, 64, 64)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _batch(seed, T, do, da, N):
    """(T, d, N) obs/actions as bf16 values (numpy fp32) and fp32
    advantages."""
    rng = np.random.RandomState(seed)
    obs = np.asarray(jnp.asarray(rng.standard_normal((T, do, N)),
                                 BF16).astype(jnp.float32))
    act = np.asarray(jnp.asarray(0.5 * rng.standard_normal((T, da, N)),
                                 BF16).astype(jnp.float32))
    return obs, act, rng.standard_normal((T, N)).astype(np.float32)


@pytest.mark.parametrize("hidden", SHAPES)
@pytest.mark.parametrize("jcfg", [J_C3, J_C5], ids=["c3", "c5"])
def test_rollout3d_plain_matches_reference(jcfg, hidden):
    """K4's plain version against ``rollout3d_reference`` on shared noise,
    at c3's arm and at c5's three task families: the tolerance of the
    (64, 64) test (tests/test_torch_rollout3d.py)."""
    T, N = 4, 64
    jcfg = jcfg.replace(horizon=T)
    pcfg = pconfigs.CONFIGS[jcfg.name].replace(horizon=T)
    pn = policy_params_np(np.random.RandomState(1), jcfg.obs_dim, 7, hidden)
    ins = env_inputs_np(jcfg, N, seed=2)
    task = tasks_np(jcfg, N, seed=3) if jcfg.n_tasks > 1 else None
    ref = jax_batch3d(jcfg, pn, *ins, store_bf16=False, task=task)
    out = rollout3d_kernel.rollout3d(
        pcfg, {k: t(v) for k, v in pn.items()}, *(t(x) for x in ins[:3]),
        torch.zeros(N, dtype=torch.int32) if task is None
        else torch.tensor(task), eps=t(ins[3]))
    for key, mine in zip(("obs_ff", "actions_ff", "rewards_ff"), out):
        np.testing.assert_allclose(n(mine), np.asarray(ref[key]), atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("hidden", SHAPES)
def test_surrogate_grad_plain_matches_jax(hidden):
    """K5's plain version, fp32 and with bf16 rounding points, against
    ``policy.surrogate_grad_ff``: the bounds of the (64, 64) test
    (tests/test_torch_bf16.py). With bf16 roundings, where a value lies
    within fp32 roundings of a bf16 boundary either side may round it the
    other way (more such points at more layers): mu is held within the
    fp64 evaluation's slack on each side, g on the samples with no such
    rounding (``surrogate_grad_fp64``, as the card test holds the
    kernel)."""
    obs, act, adv = _batch(4, 8, 27, 7, 96)
    pn = policy_params_np(np.random.RandomState(5), 27, 7, hidden)
    pj = {k: j(v) for k, v in pn.items()}
    pt = {k: t(v) for k, v in pn.items()}
    for store in (None, BF16):
        slack, adv_g = 0.0, adv
        if store is not None:
            ref = surrogate_grad_fp64(pt, t(obs), t(act), t(adv))
            slack = 2.0 * n(ref["mu_slack"])
            adv_g = adv * n(ref["kept"]).astype(np.float32)
            # 29 % of the samples at three layers, 47 % at (64, 64)
            assert float(n(ref["kept"]).mean()) > 0.25
        cast = (lambda x: x) if store is None else (lambda x: x.astype(BF16))
        g_j, mu_j, lp_j = jpol.surrogate_grad_ff(
            pj, cast(j(obs)), cast(j(act)), j(adv_g), store_dtype=store)
        tcast = torch.bfloat16 if store is not None else torch.float32
        g_t, mu_t, lp_t = pg_kernel.surrogate_grad(
            pt, t(obs).to(tcast), t(act).to(tcast), t(adv_g))
        assert _rel(n(ppol.flatten(g_t)), ravel_pytree(g_j)[0]) <= 1e-4
        assert (np.abs(n(mu_t) - np.asarray(mu_j, np.float32))
                <= 5e-4 + slack).all()
        np.testing.assert_allclose(n(lp_t), np.asarray(lp_j, np.float32),
                                   rtol=1e-3, atol=1e-3)


def test_surrogate_grad_plain_matches_pallas_interpret():
    """Once against the Pallas kernel at JAX's own odd widths (48, 40)
    (tests/test_pallas_pg.py), with the bounds of the (64, 64) test: its
    kernel also rounds the weights to bf16."""
    obs, act, adv = _batch(6, 1, 27, 7, 256)
    pn = policy_params_np(np.random.RandomState(7), 27, 7, (48, 40),
                          out_scale=3.0)
    g_p, mu_p, lp_p = pallas_surrogate_grad_ff(
        {k: j(v) for k, v in pn.items()}, j(obs).astype(BF16),
        j(act).astype(BF16), j(adv), interpret=True)
    g_t, mu_t, lp_t = pg_kernel.surrogate_grad_plain(
        {k: t(v) for k, v in pn.items()}, t(obs).to(torch.bfloat16),
        t(act).to(torch.bfloat16), t(adv))
    assert float(np.abs(n(mu_t) - np.asarray(mu_p)).max()) < 0.1
    assert float(np.abs(n(lp_t) - np.asarray(lp_p)).max()) \
        < 0.04 * float(np.abs(n(lp_t)).max())
    for k in pn:
        scale = float(np.abs(n(g_t[k])).max()) + 1e-12
        err = float(np.abs(n(g_t[k]) - np.asarray(g_p[k])).max()) / scale
        assert err < 5e-2, (k, err)


@pytest.mark.parametrize("hidden", SHAPES)
def test_fvp_ff_plain_matches_jax(hidden):
    """K6's plain version on a time- and env-strided bf16 subsample against
    JAX's ``make_gn_fvp`` on the same samples flattened to fp32 (its CPU
    route), within the (64, 64) test's bound."""
    obs, _, _ = _batch(8, 16, 27, 7, 128)
    pn = policy_params_np(np.random.RandomState(9), 27, 7, hidden)
    pj = {k: j(v) for k, v in pn.items()}
    theta, unravel = ravel_pytree(pj)
    sub = obs[::8, :, ::2]
    f_j = j_make_gn_fvp(pj, unravel,
                        j(sub.transpose(0, 2, 1).reshape(-1, 27)), 0.1)
    f_t = fvp_ff_kernel.make_gn_fvp_ff(
        {k: t(v) for k, v in pn.items()},
        t(obs).to(torch.bfloat16)[::8, :, ::2], 0.1)
    v = np.random.RandomState(10).standard_normal(theta.shape[0]) \
        .astype(np.float32)
    assert _rel(n(f_t(t(v))), f_j(j(v))) <= 1e-5


@pytest.mark.parametrize("hidden", [(32, 32), (64, 64, 64)])
def test_update_parity_c3(hidden):
    """The whole c3 update (N = 128 envs x T = 16 steps, bf16 storage) at
    Baselines' (32, 32) and a 3-layer policy against the JAX package's on
    the same batch: cosine >= 0.999, |beta| rel <= 1e-3, the same accepted
    exponent; the port forces the K5 and K6 routes at this size, which run
    their plain versions here."""
    N, T = 128, 16
    jcfg = J_C3.replace(n_envs=N, horizon=T,
                        trpo=dataclasses.replace(J_C3.trpo, hidden=hidden))
    pcfg = pconfigs.C3_FRANKA7.replace(
        n_envs=N, horizon=T, trpo=dataclasses.replace(
            pconfigs.C3_FRANKA7.trpo, hidden=hidden, surrgrad_impl="pallas",
            fvp_impl="pallas"))
    pn = policy_params_np(np.random.RandomState(11), jcfg.obs_dim, 7, hidden)
    batch = jax_batch3d(jcfg, pn, *env_inputs_np(jcfg, N, seed=12))
    kernels.reset_counts()
    check_update_parity(jcfg, pcfg, pn, batch)
    calls = kernels.plain_calls()
    assert calls["pg"] == 1 and calls["fvp_ff"] == pcfg.trpo.cg_iters
    assert calls["fvp"] == 0


def _jax_routes(jp, T, N, Ts, Ns):
    """The JAX package's decisions past its gates (trpo/update.py there):
    the packed kernels where ``tiles_ok`` holds, else the XLA surrogate
    gradient and the batch-major FVP."""
    return dict(surrgrad="pallas" if tiles_ok(T, N, jp) else "xla",
                fvp="ff" if tiles_ok(Ts, Ns, jp) else "bm")


@pytest.mark.parametrize("hidden", [(96, 96), (64, 64), (32, 32),
                                    (64, 64, 64), (100, 50, 25)])
@pytest.mark.parametrize("forced", [False, True])
def test_resolver_width_rule_matches_jax(hidden, forced):
    """At c3's full size, past the port's batch gates: a policy wider than
    64 takes the plain surrogate gradient and the batch-major FVP, forced
    or not, as the JAX package's resolver decides; the others take K5
    and K6."""
    tr = pconfigs.C3_FRANKA7.trpo
    if forced:
        tr = dataclasses.replace(tr, surrgrad_impl="pallas",
                                 fvp_impl="pallas")
    T, N = 200, 4096
    Ts, Ns = T // tr.fvp_subsample, N // tr.fvp_env_subsample
    pn = policy_params_np(np.random.RandomState(13), 24, 7, hidden)
    routes = kernel_routes(tr, {k: t(v) for k, v in pn.items()}, T, N, Ts, Ns)
    assert routes == _jax_routes({k: j(v) for k, v in pn.items()}, T, N, Ts,
                                 Ns)
    wide = max(hidden) > 64
    assert routes == (dict(surrgrad="xla", fvp="bm") if wide
                      else dict(surrgrad="pallas", fvp="ff"))


def test_wide_policy_update_takes_the_plain_routes():
    """A (96, 96) policy at a small c3 with both kernels forced: the update
    never enters K5's or K6's wrapper and runs CG on the batch-major FVP,
    as the JAX package does."""
    N, T, hidden = 64, 16, (96, 96)
    pcfg = pconfigs.C3_FRANKA7.replace(
        n_envs=N, horizon=T, trpo=dataclasses.replace(
            pconfigs.C3_FRANKA7.trpo, hidden=hidden, surrgrad_impl="pallas",
            fvp_impl="pallas"))
    pn = policy_params_np(np.random.RandomState(14), pcfg.obs_dim, 7, hidden)
    pt = params_from_numpy(pn, "cpu")
    q0, qd0, tgt, eps = (t(x) for x in env_inputs_np(pcfg, N, seed=15))
    from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
    batch = batch_from_ff(*rollout3d_kernel.rollout3d(
        pcfg, pt, q0, qd0, tgt, torch.zeros(N, dtype=torch.int32), eps=eps,
        store_dtype=torch.bfloat16))
    kernels.reset_counts()
    _, _, st = trpo_update(pcfg, pt, w_from_numpy(
        np.zeros(2 * pcfg.obs_dim + 4, np.float32), "cpu"), batch)
    calls = kernels.plain_calls()
    assert calls["pg"] == 0 and calls["fvp_ff"] == 0
    assert calls["fvp"] == pcfg.trpo.cg_iters
    assert float(st["kl"]) <= pcfg.trpo.delta
    assert all(bool(torch.isfinite(v).all()) for v in st.values())
