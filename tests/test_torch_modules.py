"""Module-by-module parity of the PyTorch port against the JAX package on
the CPU: policy (ff forms, surrogate gradient, flatten order), GAE, the
linear baseline, the plain GN-FVP, CG and the line search. Inputs come
from numpy with a seed and go through both."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from test_torch_helpers import cosine, j, n, policy_params_np, t
from trpo_robot_control_tpu.models import baseline as jbase
from trpo_robot_control_tpu.models import policy as jpol
from trpo_robot_control_tpu.ops.cg import conjugate_gradient as jcg
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.gae import gae as jgae
from trpo_robot_control_tpu.ops.linesearch import line_search as jls
from trpo_robot_control_tpu_torch.models import baseline as pbase
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.ops.cg import conjugate_gradient as pcg
from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp as p_make_gn_fvp
from trpo_robot_control_tpu_torch.ops.gae import gae as pgae
from trpo_robot_control_tpu_torch.ops.linesearch import line_search as pls


def _params(seed, do=12, da=3):
    pn = policy_params_np(np.random.RandomState(seed), do, da)
    return pn, {k: j(v) for k, v in pn.items()}, {k: t(v) for k, v in pn.items()}


def test_flatten_order_matches_ravel_pytree():
    pn, pj, pt = _params(0)
    flat_j, unravel = ravel_pytree(pj)
    flat_t = ppol.flatten(pt)
    np.testing.assert_array_equal(n(flat_t), np.asarray(flat_j))
    back = ppol.unflatten(flat_t, pt)
    for k in pn:
        np.testing.assert_array_equal(n(back[k]), pn[k])
    two = ppol.unflatten(torch.stack([flat_t, 2 * flat_t]), pt)
    np.testing.assert_array_equal(n(two["W1"][1]), 2 * pn["W1"])


def test_init_params_family():
    g = torch.Generator().manual_seed(0)
    p = ppol.init_params(g, 12, 3, (64, 64), -0.5)
    assert sorted(p) == ["W0", "W1", "W2", "b0", "b1", "b2", "logstd"]
    assert p["W0"].shape == (12, 64) and p["W2"].shape == (64, 3)
    assert abs(float(p["W1"].std()) - 1 / 8) < 0.01
    assert float(p["W2"].abs().max()) < 0.01
    assert torch.all(p["logstd"] == -0.5)


def test_policy_forms_match_jax():
    rng = np.random.RandomState(1)
    pn, pj, pt = _params(1)
    T, do, N, da = 5, 12, 16, 3
    obs_ff = rng.standard_normal((T, do, N)).astype(np.float32)
    act_ff = rng.standard_normal((T, da, N)).astype(np.float32)
    tol = dict(rtol=1e-5, atol=1e-5)
    for hj, ht in zip(jpol.hidden_ff(pj, j(obs_ff)), ppol.hidden_ff(pt, t(obs_ff))):
        np.testing.assert_allclose(n(ht), np.asarray(hj), **tol)
    mu_j, ls_j = jpol.dist_ff(pj, j(obs_ff))
    mu_t, ls_t = ppol.dist_ff(pt, t(obs_ff))
    np.testing.assert_allclose(n(mu_t), np.asarray(mu_j), **tol)
    np.testing.assert_allclose(
        n(ppol.log_prob_ff(mu_t, ls_t, t(act_ff))),
        np.asarray(jpol.log_prob_ff(mu_j, ls_j, j(act_ff))), **tol)
    mu2 = mu_t + 0.1
    np.testing.assert_allclose(
        float(ppol.kl_ff(mu_t, ls_t, mu2, ls_t + 0.05)),
        float(jpol.kl_ff(mu_j, ls_j, j(mu2), ls_j + 0.05)), **tol)
    obs = obs_ff.transpose(2, 0, 1).reshape(-1, do)
    act = act_ff.transpose(2, 0, 1).reshape(-1, da)
    m_j = jpol.mean_net(pj, j(obs))
    m_t = ppol.mean_net(pt, t(obs))
    np.testing.assert_allclose(n(m_t), np.asarray(m_j), **tol)
    np.testing.assert_allclose(n(ppol.log_prob(m_t, ls_t, t(act))),
                               np.asarray(jpol.log_prob(m_j, ls_j, j(act))),
                               **tol)
    np.testing.assert_allclose(float(ppol.kl(m_t, ls_t, m_t + 0.2, ls_t)),
                               float(jpol.kl(m_j, ls_j, m_j + 0.2, ls_j)),
                               **tol)
    np.testing.assert_allclose(float(ppol.entropy(ls_t)),
                               float(jpol.entropy(ls_j)), **tol)


def test_surrogate_grad_ff_matches_jax():
    rng = np.random.RandomState(2)
    pn, pj, pt = _params(2)
    T, do, N, da = 6, 12, 32, 3
    obs_ff = rng.standard_normal((T, do, N)).astype(np.float32)
    act_ff = rng.standard_normal((T, da, N)).astype(np.float32)
    adv = rng.standard_normal((T, N)).astype(np.float32)
    g_j, mu_j, lp_j = jpol.surrogate_grad_ff(pj, j(obs_ff), j(act_ff), j(adv))
    g_t, mu_t, lp_t = ppol.surrogate_grad_ff(pt, t(obs_ff), t(act_ff), t(adv))
    gj = np.asarray(ravel_pytree(g_j)[0])
    gt = n(ppol.flatten(g_t))
    np.testing.assert_allclose(gt, gj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(n(mu_t), np.asarray(mu_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(n(lp_t), np.asarray(lp_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("time_axis,with_dones", [(1, False), (0, False),
                                                  (1, True), (0, True)])
def test_gae_matches_jax(time_axis, with_dones):
    rng = np.random.RandomState(3)
    shape = (7, 19) if time_axis == 1 else (19, 7)
    r = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    d = (rng.uniform(size=shape) < 0.1).astype(np.float32) if with_dones \
        else None
    a_j = jgae(j(r), j(v), 0.99, 0.97, dones=None if d is None else j(d),
               time_axis=time_axis)
    a_t = pgae(t(r), t(v), 0.99, 0.97, dones=None if d is None else t(d),
               time_axis=time_axis)
    np.testing.assert_allclose(n(a_t), np.asarray(a_j), rtol=1e-5, atol=1e-5)


def test_linear_baseline_matches_jax():
    rng = np.random.RandomState(4)
    T, do, N = 12, 12, 40
    obs_ff = rng.standard_normal((T, do, N)).astype(np.float32)
    y = (3.0 * rng.standard_normal((T, N))).astype(np.float32)
    w = (0.1 * rng.standard_normal(2 * do + 4)).astype(np.float32)
    assert pbase.n_features(do) == jbase.n_features(do)
    np.testing.assert_allclose(
        n(pbase.values_ff(t(w), t(obs_ff), 20)),
        np.asarray(jbase.values_ff(j(w), j(obs_ff), 20, tn=True)),
        rtol=1e-5, atol=1e-5)
    A_j, b_j = jbase.normal_eq_ff(j(obs_ff), j(y), 20)
    A_t, b_t = pbase.normal_eq_ff(t(obs_ff), t(y), 20)
    np.testing.assert_allclose(n(A_t), np.asarray(A_j), rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(n(b_t), np.asarray(b_j), rtol=2e-5, atol=2e-4)
    A = np.asarray(A_j) + 1e-3 * np.eye(A_j.shape[0], dtype=np.float32)
    w_j = jbase.fit_normal(j(A), b_j)
    w_t = pbase.fit_normal(t(A), t(b_j))
    # compare in prediction space: near-null directions of A are free
    phi = np.asarray(jbase.features(j(obs_ff.transpose(2, 0, 1)), 20)) \
        .reshape(-1, 2 * do + 4)
    v_j, v_t = phi @ np.asarray(w_j), phi @ n(w_t)
    assert np.abs(v_t - v_j).max() / (np.abs(v_j).mean() + 1e-6) < 1e-3
    # the relative eigenvalue floor and the non-finite guard
    bad = np.diag([1.0, 1e-9, 1.0]).astype(np.float32)
    np.testing.assert_allclose(n(pbase.fit_normal(t(bad), t(np.ones(3)))),
                               np.asarray(jbase.fit_normal(j(bad), j(np.ones(3)))),
                               rtol=1e-5)


def test_gn_fvp_and_cg_match_jax():
    rng = np.random.RandomState(5)
    pn, pj, pt = _params(5)
    obs = rng.standard_normal((300, 12)).astype(np.float32)
    theta, unravel = ravel_pytree(pj)
    f_j = j_make_gn_fvp(pj, unravel, j(obs), damping=0.1)
    f_t = p_make_gn_fvp(pt, t(obs), damping=0.1)
    for s in range(3):
        v = rng.standard_normal(theta.shape[0]).astype(np.float32)
        np.testing.assert_allclose(n(f_t(t(v))), np.asarray(f_j(j(v))),
                                   rtol=2e-4, atol=2e-6)
    g = rng.standard_normal(theta.shape[0]).astype(np.float32)
    x_j, r_j, res_j = jcg(f_j, j(g), 10)
    x_t, r_t, res_t = pcg(f_t, t(g), 10)
    assert cosine(n(x_t), np.asarray(x_j)) > 0.99999
    np.testing.assert_allclose(n(x_t), np.asarray(x_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(float(res_t), float(res_j), rtol=1e-2,
                               atol=1e-7)


@pytest.mark.parametrize("case", ["first", "later", "none"])
def test_line_search_matches_jax(case):
    """Same semantics as the reference's early-exit loop: the first k with
    surr > surr_old and kl <= delta; accepted = -1, kl = 0 and
    surr = surr_old when none accepts."""
    rng = np.random.RandomState(6)
    P = 7
    theta0 = rng.standard_normal(P).astype(np.float32)
    step = rng.standard_normal(P).astype(np.float32)
    # surrogate rises along the step; KL grows with the step length
    kl_scale = {"first": 1e-4, "later": 0.5, "none": 0.5}[case]
    sign = -1.0 if case == "none" else 1.0

    def f(theta, xp):
        d = theta - theta0
        surr = sign * xp.sum(d * step) - 0.01 * xp.sum(d * d)
        return surr, kl_scale * xp.sum(d * d)

    def eval_j(theta):
        return f(theta, jnp)

    def eval_t(thetas):
        d = thetas - t(theta0)[None]
        surr = sign * (d * t(step)[None]).sum(1) - 0.01 * (d * d).sum(1)
        return surr, kl_scale * (d * d).sum(1)

    out_j = jls(eval_j, j(theta0), j(step), jnp.float32(0.0), 0.01, 10, 0.5)
    out_t = pls(eval_t, t(theta0), t(step), torch.tensor(0.0), 0.01, 10, 0.5)
    assert int(out_t[1]) == int(out_j[1])
    k = int(out_t[1])
    assert (k == 0) if case == "first" else (k > 0) if case == "later" \
        else (k == -1)
    np.testing.assert_allclose(n(out_t[0]), np.asarray(out_j[0]), rtol=1e-6)
    np.testing.assert_allclose(float(out_t[2]), float(out_j[2]), rtol=1e-5)
    np.testing.assert_allclose(float(out_t[3]), float(out_j[3]), rtol=1e-5)
