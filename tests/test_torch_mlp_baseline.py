"""The port's MLP value baseline (``models/baseline.py``) against the JAX
package's on the same numpy inputs: ``features``, ``predict_mlp`` and
``fit_mlp`` (50 full-batch Adam steps, fresh moments, JAX's update rule),
with the weights held in ``tests/test_mlp_baseline.py``'s band (rtol 2e-3,
atol 2e-4) and the predictions within 1e-4 relative L2; then the port's
mirrors of that file's checks: the refit halves the MSE, and c1 trains with
the MLP baseline inside the trust region and improves."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from test_torch_helpers import j, n, t
from trpo_robot_control_tpu.models import baseline as jb
from trpo_robot_control_tpu_torch.configs import C1_REACHER2
from trpo_robot_control_tpu_torch.models import baseline as pb
from trpo_robot_control_tpu_torch.utils.convert import (w_from_numpy,
                                                        w_to_numpy)


def _data(seed=0, B=512, F=10):
    rng = np.random.RandomState(seed)
    phi = rng.standard_normal((B, F)).astype(np.float32)
    y = (np.sin(phi[:, 0]) + 0.5 * phi[:, 1] ** 2).astype(np.float32)
    return phi, y


def _jax_w(F, hidden, seed=1):
    w = jb.init_mlp(jax.random.PRNGKey(seed), F, hidden)
    return {k: np.asarray(v) for k, v in w.items()}


def test_features_match_jax():
    obs = np.random.RandomState(2).standard_normal((6, 7, 9)) \
        .astype(np.float32)
    np.testing.assert_array_equal(n(pb.features(t(obs), 50)),
                                  np.asarray(jb.features(j(obs), 50)))
    assert pb.n_features(9) == jb.n_features(9)


def test_linear_fit_and_predict_match_jax():
    """The batch-major ridge fit (``fit``: the normal equations on phi,
    then ``fit_normal``) and ``predict``, in prediction space."""
    rng = np.random.RandomState(3)
    obs = rng.standard_normal((16, 20, 9)).astype(np.float32)
    phi = np.asarray(jb.features(j(obs), 20)).reshape(-1, 22)
    y = (phi[:, 0] - 0.3 * phi[:, 9] + 0.1 * rng.standard_normal(320)) \
        .astype(np.float32)
    w_j = np.asarray(jb.fit(j(phi), j(y), 1e-3))
    w_t = pb.fit(t(phi), t(y), 1e-3)
    v_j = np.asarray(jb.predict(j(w_j), j(phi)))
    v_t = n(pb.predict(w_t, t(phi)))
    assert np.linalg.norm(v_t - v_j) / np.linalg.norm(v_j) <= 1e-4


@pytest.mark.parametrize("hidden", [(32,), (64,), (16, 8)])
def test_predict_mlp_matches_jax(hidden):
    phi, _ = _data()
    wn = _jax_w(phi.shape[1], hidden)
    got = n(pb.predict_mlp(w_from_numpy(wn, "cpu"), t(phi)))
    want = np.asarray(jb.predict_mlp({k: j(v) for k, v in wn.items()},
                                     j(phi)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fit_mlp_matches_jax():
    phi, y = _data()
    wn = _jax_w(phi.shape[1], (32,))
    w_j = jax.jit(lambda w: jb.fit_mlp(w, j(phi), j(y), 1e-2, 50))(
        {k: j(v) for k, v in wn.items()})
    w_t = pb.fit_mlp(w_from_numpy(wn, "cpu"), t(phi), t(y), 1e-2, 50)
    got = w_to_numpy(w_t)
    assert set(got) == set(wn)
    for k in wn:
        np.testing.assert_allclose(got[k], np.asarray(w_j[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    p_t = n(pb.predict_mlp(w_t, t(phi)))
    p_j = np.asarray(jb.predict_mlp(w_j, j(phi)))
    assert np.linalg.norm(p_t - p_j) / np.linalg.norm(p_j) <= 1e-4


def test_init_mlp_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    w = pb.init_mlp(gen, 52, (64,))
    assert {k: tuple(v.shape) for k, v in w.items()} == {
        "W0": (52, 64), "b0": (64,), "W1": (64, 1), "b1": (1,)}
    assert float(w["b0"].abs().max()) == 0.0
    # N(0, 2 / m): the sample std of W0's 3328 draws within 5 %
    assert abs(float(w["W0"].std()) / np.sqrt(2.0 / 52) - 1.0) < 0.05
    wj = _jax_w(52, (64,))
    assert {k: v.shape for k, v in wj.items()} == \
        {k: tuple(v.shape) for k, v in w.items()}


def test_fit_mlp_keeps_old_weights_where_not_finite():
    phi, y = _data(B=64)
    w = pb.init_mlp(torch.Generator().manual_seed(0), phi.shape[1], (8,))
    y_bad = t(y)
    y_bad[3] = float("inf")
    # an infinite target makes every gradient, so every refit weight, NaN
    w2 = pb.fit_mlp(w, t(phi), y_bad, 1e-2, 3)
    for k in w:
        assert torch.equal(w2[k], w[k]), k
    w3 = pb.fit_mlp(w, t(phi), t(y), 1e-2, 3)
    assert not any(torch.equal(w3[k], w[k]) for k in w)


def test_fit_mlp_reduces_mse():
    phi, y = _data()
    w = pb.init_mlp(torch.Generator().manual_seed(0), phi.shape[1], (32,))

    def mse(w):
        return float(torch.mean((pb.predict_mlp(w, t(phi)) - t(y)) ** 2))

    before = mse(w)
    after = mse(pb.fit_mlp(w, t(phi), t(y), 1e-2, 50))
    assert after < 0.5 * before, (before, after)


MLP_CFG = C1_REACHER2.replace(
    n_envs=32, horizon=20,
    trpo=dataclasses.replace(C1_REACHER2.trpo, baseline="mlp",
                             baseline_hidden=(32,)))


def test_mlp_baseline_training_improves():
    from trpo_robot_control_tpu_torch.trpo.train import train
    state, hist = train(MLP_CFG, n_iters=10, seed=0, device="cpu")
    rets = [h["mean_return"] for h in hist]
    assert all(h["kl"] <= MLP_CFG.trpo.delta + 1e-6 for h in hist)
    assert np.mean(rets[-3:]) > np.mean(rets[:3]), rets
    assert set(state.w) == {"W0", "b0", "W1", "b1"}
    assert all(bool(torch.isfinite(v).all()) for v in state.w.values())
