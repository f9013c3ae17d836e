"""The port held to the JAX package's own parity contract
(``tests/test_parity.py``): the port's fp32 c1 update on the CPU against
the fp64 oracle's (``oracle/trpo.py:trpo_update``) on the oracle's own
batches, seeds 0-2, with that test's bounds: cos g > 0.9995, cos x >
0.999, |beta| rel < 2e-3, the same accepted exponent, the baseline refit
within 2e-2 of the oracle's in prediction space and the updated
parameters at rtol 1e-2 / atol 1e-3. Only the oracle and the port are
imported: nothing here is jitted."""
import numpy as np
import pytest
import torch

from oracle import net as onet
from oracle.trpo import OracleEnv, baseline_features, collect_rollouts
from oracle.trpo import trpo_update as oracle_update
from trpo_robot_control_tpu_torch.configs import C1_REACHER2
from trpo_robot_control_tpu_torch.envs.arm import batch_from_ff
from trpo_robot_control_tpu_torch.models import policy
from trpo_robot_control_tpu_torch.trpo.update import trpo_update
from trpo_robot_control_tpu_torch.utils.convert import (params_from_numpy,
                                                        w_from_numpy)

CFG = C1_REACHER2.replace(n_envs=24, horizon=30)


def _oracle_setup(seed):
    """``tests/test_parity.py``'s data: the oracle's initial policy and its
    batch, both from one ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    env = OracleEnv(CFG)
    params = onet.init_params(rng, CFG.arm.obs_dim, CFG.arm.n_joints,
                              CFG.trpo.hidden, CFG.trpo.logstd_init)
    batch = collect_rollouts(CFG, env, params, rng)
    return params, batch


def _ff(x):
    """(N, T, ...) fp64 -> the contiguous fp32 feature-first (T, ..., N)."""
    x = torch.tensor(np.asarray(x, np.float32))
    return x.permute(1, 2, 0).contiguous() if x.dim() == 3 \
        else x.T.contiguous()


def cosine(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-30))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_update_matches_oracle(seed):
    params_o, batch = _oracle_setup(seed)
    w0 = np.zeros(2 * CFG.obs_dim + 4)
    new_o, w_o, st_o = oracle_update(CFG, params_o, w0, batch)

    tb = batch_from_ff(_ff(batch["obs"]), _ff(batch["actions"]),
                       _ff(batch["rewards"]))
    new_t, w_t, st_t = trpo_update(CFG, params_from_numpy(params_o, "cpu"),
                             w_from_numpy(w0, "cpu"), tb,
                             return_directions=True)
    g_t = st_t["g"].double().numpy()
    x_t = st_t["x"].double().numpy()
    assert cosine(g_t, st_o["g"]) > 0.9995, cosine(g_t, st_o["g"])
    assert cosine(x_t, st_o["x"]) > 0.999, cosine(x_t, st_o["x"])
    beta_rel = abs(float(st_t["beta"]) - st_o["beta"]) / st_o["beta"]
    assert beta_rel < 2e-3, beta_rel
    assert int(st_t["accepted"]) == st_o["accepted"]
    # the baseline refit, in prediction space (the weights have
    # near-null-space freedom under the small ridge at fp32)
    phi = baseline_features(batch["obs"], CFG.horizon)
    v_t = phi @ w_t.double().numpy()
    v_o = phi @ w_o
    assert np.abs(v_t - v_o).max() / (np.abs(v_o).mean() + 1e-6) < 2e-2
    # the updated parameters, flattened in sorted-key order
    np.testing.assert_allclose(policy.flatten(new_t).double().numpy(),
                               onet.flatten(new_o), rtol=1e-2, atol=1e-3)
