"""bf16 storage in the PyTorch port against the JAX package on the CPU:
the baseline's values and normal equations, the surrogate gradient with
its bf16 rounding points, the line search on an env-strided subsample,
and the plain versions of the surrogate-gradient kernel (K5) and the
feature-first FVP kernel (K6) against their JAX twins and, once each,
against the Pallas kernels in interpret mode."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from test_torch_helpers import cosine, j, n, policy_params_np, t, torch_ff
from trpo_robot_control_tpu.models import baseline as jbase
from trpo_robot_control_tpu.models import policy as jpol
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.pallas.fvp_ff_kernel import \
    make_pallas_gn_fvp_ff
from trpo_robot_control_tpu.ops.pallas.pg_kernel import \
    pallas_surrogate_grad_ff
from trpo_robot_control_tpu_torch.configs import C3_FRANKA7
from trpo_robot_control_tpu_torch.models import baseline as pbase
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import (fvp_ff_kernel,
                                                   moments_kernel, pg_kernel)
from trpo_robot_control_tpu_torch.trpo.update import _eval_candidates

BF16 = jnp.bfloat16


def _bf16_batch(seed, T=16, do=24, da=7, N=64):
    """(T, d, N) obs/actions rounded to bf16 (as numpy fp32 values) and
    fp32 advantages."""
    rng = np.random.RandomState(seed)
    obs = np.asarray(jnp.asarray(rng.standard_normal((T, do, N)),
                                 BF16).astype(jnp.float32))
    act = np.asarray(jnp.asarray(0.5 * rng.standard_normal((T, da, N)),
                                 BF16).astype(jnp.float32))
    adv = rng.standard_normal((T, N)).astype(np.float32)
    return obs, act, adv


def _rel_max(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_baseline_bf16_matches_jax():
    obs, _, y = _bf16_batch(0, T=12, do=24, N=40)
    y = 3.0 * y
    w = (0.1 * np.random.RandomState(1).standard_normal(52)) \
        .astype(np.float32)
    o16_j, o16_t = j(obs).astype(BF16), t(obs).to(torch.bfloat16)
    v_j = jbase.values_ff(j(w), o16_j, 20, tn=True)
    v_t = pbase.values_ff(t(w), o16_t, 20)
    assert _rel_max(n(v_t), v_j) <= 1e-5
    A_j, b_j = jbase.normal_eq_ff(o16_j, j(y), 20)
    A_t, b_t = pbase.normal_eq_ff(o16_t, t(y), 20)
    assert _rel_max(n(A_t), A_j) <= 1e-5 and _rel_max(n(b_t), b_j) <= 1e-5
    # the moments kernel's plain version gives the same (A, b)
    A_k, b_k = moments_kernel.baseline_moments(o16_t, t(y), 20)
    assert _rel_max(n(A_k), A_j) <= 1e-5 and _rel_max(n(b_k), b_j) <= 1e-5
    # bf16 rounds obs^2 and y: the fp32 path differs measurably
    A_32, _ = pbase.normal_eq_ff(t(obs), t(y), 20)
    assert not torch.equal(A_32, A_t)


def test_surrogate_grad_bf16_matches_jax():
    obs, act, adv = _bf16_batch(2)
    pn = policy_params_np(np.random.RandomState(3), 24, 7)
    pj = {k: j(v) for k, v in pn.items()}
    g_j, mu_j, lp_j = jpol.surrogate_grad_ff(
        pj, j(obs).astype(BF16), j(act).astype(BF16), j(adv),
        store_dtype=BF16)
    g_t, mu_t, lp_t = pg_kernel.surrogate_grad(
        {k: t(v) for k, v in pn.items()}, t(obs).to(torch.bfloat16),
        t(act).to(torch.bfloat16), t(adv))
    gj = np.asarray(ravel_pytree(g_j)[0], np.float64)
    gt = n(ppol.flatten(g_t)).astype(np.float64)
    assert np.linalg.norm(gt - gj) / np.linalg.norm(gj) <= 1e-4
    # a 1-ulp fp32 difference in a pre-activation can flip the bf16
    # rounding of a hidden unit (2^-9 relative): mu and logp move by that
    np.testing.assert_allclose(n(mu_t), np.asarray(mu_j, np.float32),
                               atol=5e-4)
    np.testing.assert_allclose(n(lp_t), np.asarray(lp_j, np.float32),
                               rtol=1e-3, atol=1e-3)
    # the rounding points matter: the fp32 form is measurably different
    g_32, _, _ = ppol.surrogate_grad_ff({k: t(v) for k, v in pn.items()},
                                        t(obs), t(act), t(adv))
    assert not torch.equal(ppol.flatten(g_32), ppol.flatten(g_t))


def test_surrogate_grad_plain_matches_pallas_interpret():
    """Once against the Pallas kernel in bf16 mode, with the JAX package's
    own bounds (its kernel also rounds the weights to bf16)."""
    obs, act, adv = _bf16_batch(4, T=8, do=27, da=7, N=512)
    pn = policy_params_np(np.random.RandomState(5), 27, 7, out_scale=3.0)
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


def test_fvp_ff_plain_matches_jax_twin():
    """The plain feature-first FVP on the bf16 subsample against JAX's
    make_gn_fvp on the flattened fp32 subsample (its CPU route)."""
    obs, _, _ = _bf16_batch(6, T=16)
    sub16 = t(obs).to(torch.bfloat16)[::8]
    pn = policy_params_np(np.random.RandomState(7), 24, 7)
    pj = {k: j(v) for k, v in pn.items()}
    theta, unravel = ravel_pytree(pj)
    flat = jnp.transpose(j(obs)[::8], (0, 2, 1)).reshape(-1, 24)
    f_j = j_make_gn_fvp(pj, unravel, flat, 0.1)
    f_t = fvp_ff_kernel.make_gn_fvp_ff({k: t(v) for k, v in pn.items()},
                                       sub16, 0.1)
    rng = np.random.RandomState(8)
    for _ in range(3):
        v = rng.standard_normal(theta.shape[0]).astype(np.float32)
        r_j, r_t = np.asarray(f_j(j(v))), n(f_t(t(v)))
        assert np.linalg.norm(r_t - r_j) / np.linalg.norm(r_j) <= 1e-5


def test_fvp_ff_plain_matches_pallas_interpret():
    """Once against the Pallas kernel in bf16 mode at the smallest shape
    of the JAX package's own test, with its bounds."""
    T, do, da, N = 8, 27, 7, 512
    rng = np.random.RandomState(9)
    obs = rng.standard_normal((T, do, N)).astype(np.float32)
    pn = policy_params_np(rng, do, da)
    pj = {k: j(v) for k, v in pn.items()}
    theta, unravel = ravel_pytree(pj)
    v = rng.standard_normal(theta.shape[0]).astype(np.float32)
    r_p = np.asarray(make_pallas_gn_fvp_ff(
        pj, unravel, j(obs).astype(BF16), 0.1, interpret=True)(j(v)))
    r_t = n(fvp_ff_kernel.make_gn_fvp_ff(
        {k: t(x) for k, x in pn.items()}, t(obs).to(torch.bfloat16),
        0.1)(t(v)))
    assert _rel_max(r_t, r_p) < 2e-2
    assert cosine(r_t, r_p) > 0.9999


def test_line_search_inputs_on_env_stride():
    """Candidate surrogate and KL on every 8th env, with bf16-rounded
    hidden activations, against the JAX package's eval_fn math on the same
    env-strided inputs."""
    obs, act, adv = _bf16_batch(10, T=16, N=64)
    pn = policy_params_np(np.random.RandomState(11), 24, 7)
    pj = {k: j(v) for k, v in pn.items()}
    pt = {k: t(v) for k, v in pn.items()}
    o16, a16 = t(obs).to(torch.bfloat16), t(act).to(torch.bfloat16)
    _, mu_old, lp_old = pg_kernel.surrogate_grad_plain(pt, o16, a16, t(adv))
    k = C3_FRANKA7.trpo.ls_subsample
    ls_t = (o16[..., ::k], a16[..., ::k], t(adv)[:, ::k],
            mu_old[..., ::k], lp_old[:, ::k])
    theta, unravel = ravel_pytree(pj)
    step = 0.01 * np.random.RandomState(12).standard_normal(theta.shape[0])
    thetas = np.stack([np.asarray(theta), np.asarray(theta) + step,
                       np.asarray(theta) + 2 * step]).astype(np.float32)
    surr_t, kl_t = _eval_candidates(pt, t(thetas), *ls_t, pt["logstd"],
                                    store_dtype=torch.bfloat16)
    o_j, a_j = j(obs).astype(BF16)[..., ::k], j(act).astype(BF16)[..., ::k]
    for i in range(3):
        p = unravel(j(thetas[i]))
        mu, ls = jpol.dist_ff(p, o_j, hs=jpol.hidden_ff(p, o_j,
                                                       store_dtype=BF16))
        logp = jpol.log_prob_ff(mu, ls, a_j)
        surr = jnp.mean(jnp.exp(logp - j(n(ls_t[4]))) * j(n(ls_t[2])))
        kl = jpol.kl_ff(j(n(ls_t[3])), pj["logstd"], mu, ls)
        np.testing.assert_allclose(float(surr_t[i]), float(surr), rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(float(kl_t[i]), float(kl), rtol=1e-4,
                                   atol=1e-9)


def test_new_wrappers_take_the_plain_version_on_cpu():
    kernels.reset_counts()
    obs, act, adv = _bf16_batch(13, T=16, N=16)
    pt = {k: t(v) for k, v in policy_params_np(np.random.RandomState(14), 24,
                                               7).items()}
    o16 = torch_ff(jnp.asarray(obs, BF16))
    pg_kernel.surrogate_grad(pt, o16, t(act).to(torch.bfloat16), t(adv))
    fvp_ff_kernel.make_gn_fvp_ff(pt, o16[::8], 0.1)(
        torch.ones(sum(v.numel() for v in pt.values())))
    counts = kernels.launch_counts()
    assert set(counts) == {"rollout", "moments", "fvp", "rollout3d", "pg",
                           "fvp_ff", "fit_normal"}
    assert all(c == 0 for c in counts.values())
    assert kernels.plain_calls()["pg"] == 1
    assert kernels.plain_calls()["fvp_ff"] == 1


@pytest.mark.parametrize("over", [dict(ls_subsample=3),
                                  dict(fvp_subsample=3),
                                  dict(fvp_env_subsample=3)])
def test_subsample_shape_checks(over):
    """The env strides need N % k == 0, the time stride T % k == 0."""
    from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    cfg = C3_FRANKA7.replace(n_envs=16, horizon=16)
    cfg = cfg.replace(trpo=dataclasses.replace(cfg.trpo, **over))
    st = init_state(cfg, device="cpu")
    obs, act, adv = _bf16_batch(15, T=16, N=16)
    batch = batch_from_ff(t(obs).to(torch.bfloat16),
                          t(act).to(torch.bfloat16), t(adv))
    with pytest.raises(ValueError, match="subsample"):
        trpo_update(cfg, st.params, st.w, batch)
