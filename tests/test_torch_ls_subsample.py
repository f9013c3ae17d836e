"""The line-search subsample's estimator on the port's batch-major branch
(the port of ``tests/test_ls_subsample.py:37-95``). c3-c5 estimate the
line search's statistics (surrogate improvement, mean KL) on every 8th
env: whole trajectories, since envs are i.i.d. while time steps are not
(GAE advantages and the state distribution are time-structured).

- At c3-small (192 envs x 24 steps, 24 envs in the subsample), six seeded
  iterations accept the same exponent with ``ls_subsample`` 1 and 8, so
  the updated params are equal, and the subsample's KL is within 35 % of
  the exact one.
- On a real advantage batch the env-strided subsample's mean advantage
  lies within 6 standard errors of the whitened batch's 0. The time
  stride's offset is printed, not asserted: the JAX test asserts only the
  env half."""
import dataclasses

import numpy as np
import torch

import test_torch_helpers  # noqa: F401  (pins torch threads)
from trpo_robot_control_tpu_torch.configs import C3_FRANKA7
from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
from trpo_robot_control_tpu_torch.models import baseline
from trpo_robot_control_tpu_torch.ops.gae import gae
from trpo_robot_control_tpu_torch.trpo.train import init_state
from trpo_robot_control_tpu_torch.trpo.update import trpo_update

BM_KEYS = ("obs", "actions", "rewards")


def _cfg(k_ls, n_envs=192, horizon=24):
    return C3_FRANKA7.replace(
        n_envs=n_envs, horizon=horizon,
        trpo=dataclasses.replace(C3_FRANKA7.trpo, ls_subsample=k_ls))


def _batch_major(batch):
    """The rollout's batch without its feature-first keys, in fp32."""
    return {k: batch[k].float().contiguous() for k in BM_KEYS}


def test_ls_subsample_same_accept_and_params():
    cfg1, cfg8 = _cfg(1), _cfg(8)
    state = init_state(cfg1, seed=0, device="cpu")
    roll = make_rollout_fn(cfg1)
    gen = torch.Generator().manual_seed(100)
    params, w = state.params, state.w
    kl_errs = []
    for _ in range(6):
        batch = _batch_major(roll(params, gen))
        p1, w1, s1 = trpo_update(cfg1, params, w, batch)
        p8, _, s8 = trpo_update(cfg8, params, w, batch)
        assert int(s1["accepted"]) == int(s8["accepted"]), (
            s1["accepted"], s8["accepted"])
        for name in p1:
            assert torch.equal(p1[name], p8[name]), name
        kl1, kl8 = float(s1["kl"]), float(s8["kl"])
        kl_errs.append(abs(kl8 - kl1) / max(kl1, 1e-12))
        params, w = p1, w1
    print(f"KL relative errors of the 24-env subsample: {kl_errs}")
    assert max(kl_errs) < 0.35, kl_errs


def test_ls_subsample_env_stride_unbiased_vs_time_stride():
    cfg = _cfg(1, n_envs=256, horizon=24)
    state = init_state(cfg, seed=0, device="cpu")
    batch = make_rollout_fn(cfg)(state.params,
                                 torch.Generator().manual_seed(5))
    # the update's advantage pipeline on the batch-major branch
    obs = batch["obs"].float()
    values = baseline.predict(state.w, baseline.features(obs, cfg.horizon))
    adv_raw = gae(batch["rewards"], values, cfg.trpo.gamma, cfg.trpo.lam)
    adv = (adv_raw - adv_raw.mean()) / (adv_raw.std(unbiased=False) + 1e-8)
    adv = adv.numpy()                                        # (N, T)
    env_strided = adv[::8].mean()
    sem_env = 1.0 / np.sqrt(adv[::8].size)           # whitened: std ~ 1
    time_strided = adv[:, ::8].mean()
    sem_time = 1.0 / np.sqrt(adv[:, ::8].size)
    print(f"mean advantage: every 8th env {env_strided:+.4f} "
          f"({env_strided / sem_env:+.2f} sigma), every 8th step "
          f"{time_strided:+.4f} ({time_strided / sem_time:+.2f} sigma)")
    assert abs(env_strided) < 6 * sem_env, (env_strided, sem_env)
