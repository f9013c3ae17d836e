"""The c4/c5 task terms of the PyTorch port against the JAX package on the
CPU: the 3-D rollout kernel's plain version with the obstacle penalty and
three task families (one-hot, track, push) against ``rollout3d_reference``,
the reset's task draw and the one-hot rows of the observation, the routes
of c4/c5, and the feature-first FVP's plain version on the time- and
env-strided Fisher subsample against JAX's ``make_gn_fvp`` on that
subsample flattened (its CPU route)."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from test_torch_helpers import (OBSTACLE_ON_ARM, env_inputs_np, j,
                                jax_batch3d, n, policy_params_np, t, tasks_np)
from trpo_robot_control_tpu.configs import C5_MULTITASK as J_C5
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu_torch.configs import (C3_FRANKA7,
                                                  C4_FRANKA7_OBSTACLE)
from trpo_robot_control_tpu_torch.configs import C5_MULTITASK as P_C5
from trpo_robot_control_tpu_torch.envs import arm
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import fvp_ff_kernel
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3


def _with_obstacle(cfg):
    """c5 with c4's obstacle term, its sphere moved onto the arm so that
    the penalty bites from the first step."""
    return cfg.replace(cost=dataclasses.replace(
        cfg.cost, obstacle_weight=1.0, obstacle_center=OBSTACLE_ON_ARM))


def test_rollout3d_plain_task_terms_match_reference():
    """Obstacle, one-hot, track and push in one run of the reference, at
    the tolerance of the c3 comparison (atol 1e-5 over 8 steps)."""
    T, N = 8, 48
    jcfg = _with_obstacle(J_C5.replace(horizon=T))
    pcfg = _with_obstacle(P_C5.replace(horizon=T))
    pn = policy_params_np(np.random.RandomState(21), jcfg.obs_dim, 7)
    ins = env_inputs_np(jcfg, N, seed=22)
    task = tasks_np(jcfg, N, seed=23)
    assert set(task) == {0, 1, 2}
    ref = jax_batch3d(jcfg, pn, *ins, store_bf16=False, task=task)
    pt = {k: t(v) for k, v in pn.items()}
    mine = r3.rollout3d(pcfg, pt, *(t(x) for x in ins[:3]),
                        torch.tensor(task), eps=t(ins[3]))
    assert mine[0].shape == (T, 27, N)
    for key, x in zip(("obs_ff", "actions_ff", "rewards_ff"), mine):
        np.testing.assert_allclose(n(x), np.asarray(ref[key]), atol=1e-5,
                                   err_msg=key)
    # every term is live: drop one and the rewards move
    c = r3.arm3d_consts(pcfg)
    rew = n(mine[2])
    no_obstacle = r3.rollout3d(pcfg.replace(cost=dataclasses.replace(
        pcfg.cost, obstacle_weight=0.0)), pt, *(t(x) for x in ins[:3]),
        torch.tensor(task), eps=t(ins[3]))[2]
    assert (n(no_obstacle) > rew + 1e-4).any()
    reach_only = r3.rollout3d(pcfg, pt, *(t(x) for x in ins[:3]),
                              torch.zeros(N, dtype=torch.int32),
                              eps=t(ins[3]))[2]
    for k in (1, 2):
        assert not np.allclose(n(reach_only)[:, task == k], rew[:, task == k])
    assert c.n_tasks == 3 and c.obstacle_weight == 1.0


def test_reset_draws_tasks_and_observation_carries_one_hot():
    gen = torch.Generator().manual_seed(5)
    s5 = arm.reset(P_C5, gen, 6000)
    assert s5.task.dtype == torch.int32 and s5.task.shape == (6000,)
    share = torch.bincount(s5.task.long(), minlength=3).double() / 6000
    assert set(s5.task.tolist()) == {0, 1, 2}
    assert bool(((share - 1.0 / 3.0).abs() < 0.03).all()), share
    # the task is drawn last: single-task configs keep their streams
    gen3 = torch.Generator().manual_seed(5)
    s3 = arm.reset(C3_FRANKA7, gen3, 6000)
    for a, b in zip(s3[:3], s5[:3]):
        assert torch.equal(a, b)
    assert not s3.task.any()
    assert not arm.reset(C4_FRANKA7_OBSTACLE, gen3, 8).task.any()
    # obs rows 3n+3.. are the one-hot of the env's task at every step
    cfg = P_C5.replace(horizon=3, n_envs=32)
    pt = {k: t(v) for k, v in policy_params_np(
        np.random.RandomState(6), cfg.obs_dim, 7).items()}
    s = arm.reset(cfg, gen, 32)
    obs = r3.rollout3d(cfg, pt, s.q, s.qd, s.tgt, s.task,
                       eps=torch.zeros(3, 32, 7))[0]
    one_hot = torch.nn.functional.one_hot(s.task.long(), 3).T.float()
    for step in obs:
        assert torch.equal(step[24:], one_hot)


@pytest.mark.parametrize("name", ["c4_franka7_obstacle", "c5_multitask"])
def test_c4_c5_route_to_the_3d_kernel(name):
    from trpo_robot_control_tpu_torch.configs import CONFIGS
    cfg = CONFIGS[name].replace(n_envs=16, horizon=4)
    pt = {k: t(v) for k, v in policy_params_np(
        np.random.RandomState(7), cfg.obs_dim, 7).items()}
    kernels.reset_counts()
    batch = arm.make_rollout_fn(cfg)(pt, torch.Generator().manual_seed(0))
    assert kernels.plain_calls()["rollout3d"] == 1
    assert kernels.plain_calls()["rollout"] == 0
    assert batch["obs_ff"].shape == (4, cfg.obs_dim, 16)
    assert batch["obs_ff"].dtype == torch.bfloat16
    assert bool(torch.isfinite(batch["rewards_ff"]).all())


@pytest.mark.parametrize("e", [4, 8])
def test_fvp_ff_plain_on_env_stride_matches_jax_twin(e):
    """c4's (e = 4, do 24) and c5's (e = 8, do 27) Fisher subsamples, read
    through the strided view, against JAX's make_gn_fvp on the same
    samples flattened; repeat calls are bit-identical."""
    T, do, N = 16, 24 if e == 4 else 27, 64 * e
    rng = np.random.RandomState(30 + e)
    obs = np.asarray(jnp.asarray(rng.standard_normal((T, do, N)),
                                 jnp.bfloat16).astype(jnp.float32))
    pn = policy_params_np(rng, do, 7)
    pj = {k: j(v) for k, v in pn.items()}
    theta, unravel = ravel_pytree(pj)
    flat = jnp.transpose(j(obs)[::8][..., ::e], (0, 2, 1)).reshape(-1, do)
    f_j = j_make_gn_fvp(pj, unravel, flat, 0.1)
    sub = t(obs).to(torch.bfloat16)[::8, :, ::e]
    assert sub.shape == (2, do, 64) and sub.stride(2) == e
    f_t = fvp_ff_kernel.make_gn_fvp_ff({k: t(v) for k, v in pn.items()},
                                       sub, 0.1)
    for _ in range(3):
        v = rng.standard_normal(theta.shape[0]).astype(np.float32)
        r_j, r_t = np.asarray(f_j(j(v))), f_t(t(v))
        assert np.linalg.norm(n(r_t) - r_j) / np.linalg.norm(r_j) <= 1e-5
        assert torch.equal(r_t, f_t(t(v)))
