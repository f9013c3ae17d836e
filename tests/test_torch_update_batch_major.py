"""The batch-major branch of the port's ``trpo_update`` against the JAX
package's on the same numpy batch, held to ``tests/test_parity.py``'s
criteria (direction cosine >= 0.999, |beta| relative error <= 1e-3, the
same accepted exponent), and the refit MLP baseline to
``tests/test_mlp_baseline.py``'s band (rtol 2e-3, atol 2e-4):

- the MLP baseline, which ignores obs_ff as in JAX: c1 (64 x 10), a small
  c3 (64 x 16, the bf16-rounded obs in fp32, Fisher stride 8, the line
  search on every 8th env) and c1 with ``fvp_impl="kl"``;
- the linear baseline on a batch without obs_ff at c1 and a small c2, and
  the same batch with its feature-first keys through the port's
  feature-first branch, within the same contract;
- a batch with obs_ff but no actions_ff (the feature-first baseline
  pipeline, then the batch-major policy math on the transposed
  advantages) against the plain batch-major batch, the port's mirror of
  ``tests/test_ls_subsample.py``'s alignment test.

JAX's batch-major branch calls no Pallas kernel on the CPU. The policies
are the JAX package's own initialisation (its small final layer), as in
``tests/test_torch_update.py``: with a wide random final layer the fp32 CG
of either package strays up to 1e-2 in beta from the fp64 oracle's
(``oracle/trpo.py``) on these batches, so the 1e-3 contract between the two
fp32 sides would measure that conditioning, not the port."""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from test_torch_helpers import (cosine, env_inputs_np, j, jax_batch,
                                jax_batch3d, jax_init_params_np, n, t,
                                torch_batch_from_jax)
from trpo_robot_control_tpu.configs import CONFIGS as JCONFIGS
from trpo_robot_control_tpu.models import baseline as jb
from trpo_robot_control_tpu.trpo.update import trpo_update as j_update
from trpo_robot_control_tpu_torch.configs import CONFIGS as PCONFIGS
from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
from trpo_robot_control_tpu_torch.models import baseline as pb
from trpo_robot_control_tpu_torch.models import policy as ppol
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.trpo.train import init_state
from trpo_robot_control_tpu_torch.trpo.update import (kernel_routes,
                                                      trpo_update)
from trpo_robot_control_tpu_torch.utils.convert import (params_from_numpy,
                                                        w_from_numpy,
                                                        w_to_numpy)

BM_KEYS = ("obs", "actions", "rewards")


def _cfgs(name, N, T, **trpo):
    jc, pc = JCONFIGS[name], PCONFIGS[name]
    return (jc.replace(n_envs=N, horizon=T,
                       trpo=dataclasses.replace(jc.trpo, **trpo)),
            pc.replace(n_envs=N, horizon=T,
                       trpo=dataclasses.replace(pc.trpo, **trpo)))


def _jax_update(cfg, params_np, w_np, batch):
    up = jax.jit(lambda p, w, b: j_update(cfg, p, w, b,
                                          return_directions=True))
    w = {k: j(v) for k, v in w_np.items()} if isinstance(w_np, dict) \
        else j(w_np)
    return up({k: j(v) for k, v in params_np.items()}, w, batch)


def _check_contract(st_t, st_j):
    assert cosine(n(st_t["g"]), n(st_j["g"])) > 0.9995
    assert cosine(n(st_t["x"]), n(st_j["x"])) >= 0.999
    beta_j = float(st_j["beta"])
    assert abs(float(st_t["beta"]) - beta_j) / beta_j <= 1e-3
    assert int(st_t["accepted"]) == int(st_j["accepted"])
    for k in ("kl", "surr", "surr_old", "mean_return", "adv_std", "entropy"):
        np.testing.assert_allclose(float(st_t[k]), float(st_j[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)


def _mlp_case(name, N, T, **trpo):
    jcfg, pcfg = _cfgs(name, N, T, baseline="mlp", **trpo)
    pn = jax_init_params_np(jcfg, 1)
    wn = {k: np.asarray(v) for k, v in jb.init_mlp(
        jax.random.PRNGKey(2), jb.n_features(jcfg.obs_dim),
        jcfg.trpo.baseline_hidden).items()}
    return jcfg, pcfg, pn, wn


def _run_mlp(jcfg, pcfg, pn, wn, bj, bt):
    new_j, w_j, st_j = _jax_update(jcfg, pn, wn, bj)
    kernels.reset_counts()
    new_t, w_t, st_t = trpo_update(pcfg, params_from_numpy(pn, "cpu"),
                                   w_from_numpy(wn, "cpu"), bt,
                                   return_directions=True)
    # the batch-major branch: no moments, no K5, no K6
    calls = kernels.plain_calls()
    assert calls["moments"] == calls["pg"] == calls["fvp_ff"] == 0
    _check_contract(st_t, st_j)
    got = w_to_numpy(w_t)
    assert set(got) == set(wn)
    for k in wn:
        np.testing.assert_allclose(got[k], np.asarray(w_j[k]), rtol=2e-3,
                                   atol=2e-4, err_msg=k)
    th_j = np.asarray(jax.flatten_util.ravel_pytree(new_j)[0])
    np.testing.assert_allclose(n(ppol.flatten(new_t)), th_j, rtol=1e-2,
                               atol=1e-3)
    return st_t, calls


def test_mlp_update_parity_c1():
    jcfg, pcfg, pn, wn = _mlp_case("c1_reacher2", 64, 10)
    bj = jax_batch(jcfg, pn, *env_inputs_np(jcfg, 64, seed=3))
    # the JAX batch carries obs_ff/actions_ff: the MLP baseline ignores
    # them in both packages
    _, calls = _run_mlp(jcfg, pcfg, pn, wn, bj, torch_batch_from_jax(bj))
    assert calls["fvp"] == pcfg.trpo.cg_iters          # K3's plain version


def test_mlp_update_parity_c1_kl_fvp():
    jcfg, pcfg, pn, wn = _mlp_case("c1_reacher2", 64, 10, fvp_impl="kl")
    bj = jax_batch(jcfg, pn, *env_inputs_np(jcfg, 64, seed=4))
    _, calls = _run_mlp(jcfg, pcfg, pn, wn, bj, torch_batch_from_jax(bj))
    assert calls["fvp"] == 0                            # make_kl_fvp


def test_mlp_update_parity_small_c3():
    """bf16 stores: the port reads the bf16 batch's fp32 values, the JAX
    side gets them as its rollout kernels hand them over (fp32 copies of
    the bf16 stores); Fisher stride 8 on the n-major order, the line
    search on every 8th env."""
    jcfg, pcfg, pn, wn = _mlp_case("c3_franka7", 64, 16)
    assert pcfg.trpo.fvp_subsample == 8 and pcfg.trpo.ls_subsample == 8
    ref = jax_batch3d(jcfg, pn, *env_inputs_np(jcfg, 64, seed=5))
    bt = torch_batch_from_jax(ref)
    assert bt["obs"].dtype == torch.bfloat16
    bj = {k: j(bt[k].float()) for k in BM_KEYS}
    _, calls = _run_mlp(jcfg, pcfg, pn, wn, bj, bt)
    assert calls["fvp"] == pcfg.trpo.cg_iters


@pytest.mark.parametrize("name,N,T", [("c1_reacher2", 64, 10),
                                      ("c2_reacher3", 128, 16)])
def test_linear_update_without_obs_ff(name, N, T):
    jcfg, pcfg = _cfgs(name, N, T)
    pn = jax_init_params_np(jcfg, 6)
    w0 = np.zeros(2 * jcfg.obs_dim + 4, np.float32)
    full = jax_batch(jcfg, pn, *env_inputs_np(jcfg, N, seed=7))
    bj = {k: full[k] for k in BM_KEYS}
    _, w_j, st_j = _jax_update(jcfg, pn, w0, bj)
    bt = {k: t(full[k]) for k in BM_KEYS}
    kernels.reset_counts()
    _, w_t, st_t = trpo_update(pcfg, params_from_numpy(pn, "cpu"),
                               w_from_numpy(w0, "cpu"), bt,
                               return_directions=True)
    calls = kernels.plain_calls()
    assert calls["moments"] == calls["pg"] == calls["fvp_ff"] == 0
    _check_contract(st_t, st_j)
    # the ridge fits agree in prediction space
    phi = n(pb.features(bt["obs"], T)).reshape(-1, 2 * jcfg.obs_dim + 4)
    v_j, v_t = phi @ np.asarray(w_j), phi @ w_to_numpy(w_t)
    assert np.abs(v_t - v_j).max() / (np.abs(v_j).mean() + 1e-6) < 2e-2
    # the same batch with its feature-first keys: the port's feature-first
    # branch, within the same contract of the batch-major one
    _, _, st_ff = trpo_update(pcfg, params_from_numpy(pn, "cpu"),
                              w_from_numpy(w0, "cpu"),
                              torch_batch_from_jax(full),
                              return_directions=True)
    assert kernels.plain_calls()["moments"] == 1
    _check_contract(st_ff, st_t)


def test_batch_major_routes():
    """K5 and K6 never run on the batch-major branch, forced or not."""
    cfg = PCONFIGS["c3_franka7"]
    tr = dataclasses.replace(cfg.trpo, surrgrad_impl="pallas",
                             fvp_impl="pallas")
    params = init_state(cfg.replace(n_envs=8, horizon=8),
                        device="cpu").params
    T, N = cfg.horizon, cfg.n_envs
    assert kernel_routes(tr, params, T, N, T // 8, N) == dict(
        surrgrad="pallas", fvp="ff")
    assert kernel_routes(tr, params, T, N, T // 8, N, ff=False) == dict(
        surrgrad="autograd", fvp="bm")
    assert kernel_routes(tr, params, T, N, T // 8, N, fvp_form="kl",
                         ff=False) == dict(surrgrad="autograd", fvp="kl")


def test_ls_subsample_obs_ff_without_actions_ff_alignment():
    """With obs_ff but no actions_ff and ls_subsample > 1, adv is (T, N):
    the env-strided line-search slice must take it transposed, or the
    candidates' surrogates pair ratios with the wrong advantages. The
    obs_ff batch must agree with the plain batch-major one on the accepted
    exponent and, to fp32 reassociation (the feature-first baseline
    pipeline is the same math reassociated), on the line search's stats
    and the new params (``tests/test_ls_subsample.py:98-130``)."""
    cfg = PCONFIGS["c3_franka7"].replace(n_envs=192, horizon=24)
    assert cfg.trpo.ls_subsample == 8
    state = init_state(cfg, seed=0, device="cpu")
    roll = make_rollout_fn(cfg)(state.params, state.gen)
    batch = {k: roll[k].float().contiguous() for k in BM_KEYS}
    batch_ff = dict(batch, obs_ff=batch["obs"].permute(1, 2, 0).contiguous())
    p1, _, s1 = trpo_update(cfg, state.params, state.w, batch)
    p2, _, s2 = trpo_update(cfg, state.params, state.w, batch_ff)
    assert int(s1["accepted"]) == int(s2["accepted"])
    np.testing.assert_allclose(float(s1["surr"]), float(s2["surr"]),
                               rtol=5e-3, atol=1e-8)
    np.testing.assert_allclose(float(s1["kl"]), float(s2["kl"]),
                               rtol=5e-3, atol=1e-10)
    for name in p1:
        np.testing.assert_allclose(n(p1[name]), n(p2[name]), rtol=2e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("k,e", [(1, 1), (8, 1), (1, 4), (8, 4)])
def test_batch_major_fvp_gets_contiguous_aligned_fp32(monkeypatch, k, e):
    """K3 takes only contiguous, 16-byte-aligned fp32 samples, so the
    n-major Fisher subsample reaches ``make_gn_fvp`` as a fresh copy of
    that form, whatever the strides of the batch (here the rollout's
    views of its feature-first stores) and the two strides."""
    from trpo_robot_control_tpu_torch.trpo import update
    cfg = PCONFIGS["c2_reacher3"].replace(n_envs=64, horizon=16)
    cfg = cfg.replace(trpo=dataclasses.replace(
        cfg.trpo, fvp_subsample=k, fvp_env_subsample=e))
    state = init_state(cfg, seed=0, device="cpu")
    roll = make_rollout_fn(cfg)(state.params, state.gen)
    batch = {key: roll[key] for key in BM_KEYS}
    seen = []

    def spy(params, obs, damping):
        seen.append(obs)
        return make_gn_fvp(params, obs, damping)

    make_gn_fvp = update.make_gn_fvp
    monkeypatch.setattr(update, "make_gn_fvp", spy)
    trpo_update(cfg, state.params, state.w, batch)
    (obs,) = seen
    do = cfg.obs_dim
    want = batch["obs"].float()[::e].reshape(-1, do)[::k]
    assert obs.dtype == torch.float32 and obs.is_contiguous()
    assert obs.data_ptr() % 16 == 0
    assert obs.untyped_storage().data_ptr() != \
        batch["obs"].untyped_storage().data_ptr()
    torch.testing.assert_close(obs, want, rtol=0, atol=0)
