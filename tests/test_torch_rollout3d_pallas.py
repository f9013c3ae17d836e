"""The 3-D rollout kernel's plain version against the Pallas kernel in
interpret mode, once, at the shape the JAX package's own interpret test
uses (T = 5, one 128-env tile), on c5's three task families with c4's
obstacle term added (its sphere moved onto the arm so that it bites): the
branches of c3, c4 and c5 together. c3's reach-only path stays held
against ``rollout3d_reference`` in ``test_torch_rollout3d.py``. Its own
file: the interpret run takes about a minute on the CPU, and a file of its
own lets it share the workers with the rest of the suite."""
import dataclasses

import numpy as np

import jax.numpy as jnp

from test_torch_helpers import (OBSTACLE_ON_ARM, env_inputs_np, j, n,
                                policy_params_np, t, tasks_np)
from trpo_robot_control_tpu.configs import C5_MULTITASK as J_C5
from trpo_robot_control_tpu.ops.pallas.rollout3d_kernel import \
    pallas_rollout3d
from trpo_robot_control_tpu_torch.configs import C5_MULTITASK as P_C5
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3


def _all_terms(cfg, T):
    return cfg.replace(horizon=T, cost=dataclasses.replace(
        cfg.cost, obstacle_weight=1.0, obstacle_center=OBSTACLE_ON_ARM))


def test_rollout3d_plain_matches_pallas_interpret():
    T, N = 5, 128
    jcfg, pcfg = _all_terms(J_C5, T), _all_terms(P_C5, T)
    pn = policy_params_np(np.random.RandomState(7), jcfg.obs_dim, 7)
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=8)
    task = tasks_np(jcfg, N, seed=9)
    pal = pallas_rollout3d(jcfg, {k: j(v) for k, v in pn.items()}, 0,
                           n_envs=N, eps=j(eps), block_b=128, interpret=True,
                           q0=j(q0), qd0=j(qd0), tgt=j(tgt),
                           task=jnp.asarray(task))
    mine = r3.rollout3d(pcfg, {k: t(v) for k, v in pn.items()}, t(q0),
                        t(qd0), t(tgt), t(task).int(), eps=t(eps))
    assert mine[0].shape == (T, 27, N)
    for key, x in zip(("obs_ff", "actions_ff", "rewards_ff"), mine):
        np.testing.assert_allclose(n(x), np.asarray(pal[key]), atol=1e-5,
                                   err_msg=key)
