"""The 3-D rollout kernel's plain version against the Pallas kernel in
interpret mode, once, at the shape the JAX package's own interpret test
uses (T = 5, one 128-env tile). Its own file: the interpret run takes
about a minute on the CPU, and a file of its own lets it share the
workers with the rest of the suite."""
import numpy as np

from test_torch_helpers import env_inputs_np, j, n, policy_params_np, t
from trpo_robot_control_tpu.configs import C3_FRANKA7 as J_C3
from trpo_robot_control_tpu.ops.pallas.rollout3d_kernel import \
    pallas_rollout3d
from trpo_robot_control_tpu_torch.configs import C3_FRANKA7 as P_C3
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3


def test_rollout3d_plain_matches_pallas_interpret():
    T, N = 5, 128
    jcfg, pcfg = J_C3.replace(horizon=T), P_C3.replace(horizon=T)
    pn = policy_params_np(np.random.RandomState(7), jcfg.obs_dim, 7)
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=8)
    pal = pallas_rollout3d(jcfg, {k: j(v) for k, v in pn.items()}, 0,
                           n_envs=N, eps=j(eps), block_b=128, interpret=True,
                           q0=j(q0), qd0=j(qd0), tgt=j(tgt))
    mine = r3.rollout3d(pcfg, {k: t(v) for k, v in pn.items()}, t(q0),
                        t(qd0), t(tgt), eps=t(eps))
    for key, x in zip(("obs_ff", "actions_ff", "rewards_ff"), mine):
        np.testing.assert_allclose(n(x), np.asarray(pal[key]), atol=1e-5,
                                   err_msg=key)
