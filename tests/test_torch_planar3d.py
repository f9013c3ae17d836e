"""Planar arms that the 3-D rollout kernel (K4) takes, on the CPU: task
terms, the obstacle or gravity send a planar arm there, as in the JAX
package (its ``envs/arm.py`` routes "reach/track/push + obstacle for ANY
arm, planar included" to ``pallas_rollout3d``).

- K4's plain version on ``planar_arm(3)`` with three task families
  (c5-planar3: ``C5_MULTITASK`` with ``planar_arm(3)`` and
  ``CostSpec(ctrl_weight=0.01)``, the JAX package's
  ``tests/test_multitask.py`` C5_SMALL), one family with the obstacle, two
  families, three with the obstacle, and on ``planar_arm(2,
  gravity=9.81)``, against ``rollout3d_reference`` within 1e-5 over 8
  steps (the tolerance of the Pallas kernel against its jnp twin);
- the terminating c5-planar3 rollout against JAX's terminating rollout
  from the same key (identical dones; obs and actions within 5e-4,
  rewards within 2e-3, as ``test_torch_termination3d.py``);
- the update at c5-planar3 (obs 15 wide, 3 actions; K5's and K6's plain
  versions forced, as the card runs them at full width) and at c2 with
  bf16 storage (K1's bf16 stores into K2-bf16 and K3), each against the
  JAX package's with ``tests/test_parity.py``'s criteria.
"""
import dataclasses

import numpy as np
import pytest
import torch

from test_torch_helpers import (check_against_jax, check_update_parity,
                                env_inputs_np, jax_batch, jax_batch3d,
                                jax_ff_batch, jax_init_params_np, n,
                                policy_params_np, t, tasks_np)
from trpo_robot_control_tpu import configs as jc
from trpo_robot_control_tpu_torch import configs as pc
from trpo_robot_control_tpu_torch.envs.arm import _planar_route
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3

# an obstacle sphere on the planar arm's second joint origin at q = 0, so
# that its penalty is active from the first step
OBSTACLE_ON_PLANE = (0.5, 0.0, 0.0)


def c5_planar3(mod):
    """c5's task mix on a 3-link planar arm, in the JAX package's configs
    (``mod`` = its ``configs``) or the port's."""
    return mod.C5_MULTITASK.replace(arm=mod.planar_arm(3),
                                    cost=mod.CostSpec(ctrl_weight=0.01))


def _obstacle(mod):
    return mod.CostSpec(ctrl_weight=0.01, obstacle_weight=1.0,
                        obstacle_radius=0.15,
                        obstacle_center=OBSTACLE_ON_PLANE)


VARIANTS = {
    "three-tasks": c5_planar3,
    "one-task-obstacle": lambda mod: c5_planar3(mod).replace(
        n_tasks=1, cost=_obstacle(mod)),
    "two-tasks": lambda mod: c5_planar3(mod).replace(n_tasks=2),
    "three-tasks-obstacle": lambda mod: c5_planar3(mod).replace(
        cost=_obstacle(mod)),
    "gravity": lambda mod: mod.C1_REACHER2.replace(
        arm=mod.planar_arm(2, gravity=9.81)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_rollout3d_plain_on_planar_arms_matches_reference(variant):
    T, N = 8, 64
    jcfg = VARIANTS[variant](jc).replace(horizon=T, n_envs=N)
    pcfg = VARIANTS[variant](pc).replace(horizon=T, n_envs=N)
    assert not _planar_route(pcfg) and pcfg.obs_dim == jcfg.obs_dim
    n_j = jcfg.arm.n_joints
    pn = policy_params_np(np.random.RandomState(11), jcfg.obs_dim, n_j)
    ins = env_inputs_np(jcfg, N, seed=12)
    assert not ins[2][:, 2].any()           # targets in the arm's plane
    task = tasks_np(jcfg, N, seed=13) if jcfg.n_tasks > 1 else None
    ref = jax_batch3d(jcfg, pn, *ins, store_bf16=False, task=task)
    obs_ff, act_ff, rew_ff = r3.rollout3d(
        pcfg, {k: t(v) for k, v in pn.items()}, *(t(x) for x in ins[:3]),
        torch.zeros(N, dtype=torch.int32) if task is None
        else torch.tensor(task), eps=t(ins[3]))
    assert obs_ff.shape == (T, jcfg.obs_dim, N)
    for key, mine in (("obs_ff", obs_ff), ("actions_ff", act_ff),
                      ("rewards_ff", rew_ff)):
        np.testing.assert_allclose(n(mine), np.asarray(ref[key]), atol=1e-5,
                                   err_msg=key)


def test_planar_multitask_terminates_as_jax():
    """The fresh targets of the planar arm lie in its plane, the fresh
    tasks are redrawn: the port's plain version on JAX's draws."""
    early, *_ = check_against_jax((c5_planar3(jc), c5_planar3(pc)), 64, 16,
                                  0.4, 5, 5e-4, 2e-3)
    assert early > 0


def _forced_kernel_routes(cfg):
    return cfg.replace(trpo=dataclasses.replace(
        cfg.trpo, surrgrad_impl="pallas", fvp_impl="pallas"))


def test_update_parity_c5_planar3():
    """bf16 storage, Fisher strides 8 and 8, the line search on every 8th
    env, do 15 and da 3, on a reference batch of N 64 x T 16."""
    N, T = 64, 16
    jcfg = c5_planar3(jc).replace(n_envs=N, horizon=T)
    pcfg = _forced_kernel_routes(c5_planar3(pc).replace(n_envs=N, horizon=T))
    pn = jax_init_params_np(jcfg, 21)
    ins = env_inputs_np(jcfg, N, seed=22)
    ref = jax_batch3d(jcfg, pn, *ins, task=tasks_np(jcfg, N, seed=23))
    check_update_parity(jcfg, pcfg, pn, jax_ff_batch(jcfg, ref))


def test_update_parity_c2_bf16():
    """c2 with bf16 storage on the Pallas rollout's batch (N 128 x T 16):
    K2's bf16 mode and K3 on the fp32 relayout of the bf16 subsample."""
    N, T = 128, 16

    def cfg(mod):
        c2 = mod.C2_REACHER3
        return c2.replace(n_envs=N, horizon=T, trpo=dataclasses.replace(
            c2.trpo, ff_store_dtype="bf16"))

    jcfg, pcfg = cfg(jc), cfg(pc)
    pn = jax_init_params_np(jcfg, 24)
    bj = jax_batch(jcfg, pn, *env_inputs_np(jcfg, N, seed=25))
    batch = {k: np.asarray(bj[k]) for k in ("obs", "actions", "rewards")}
    check_update_parity(jcfg, pcfg, pn, jax_ff_batch(jcfg, batch))
