"""Policy shapes other than (64, 64) on the planar path (ROADMAP B3), on the
CPU against the JAX package: the plain versions of the planar rollout (K1)
and of the batch-major FVP (K3) at 1-3 hidden layers of widths up to 64,
each once against its Pallas kernel in interpret mode, the whole c2 update
at OpenAI Baselines' (32, 32) and at (64, 64, 64), and the port's kernel
routes at c2's full size against the JAX package's.
``test_torch_cuda.py`` holds the CUDA kernels to these plain versions on
the card."""
import dataclasses

import numpy as np
import pytest

from jax.flatten_util import ravel_pytree

from test_torch_helpers import (check_update_parity, env_inputs_np, j,
                                jax_batch, jax_init_params_np, n,
                                policy_params_np, t)
from trpo_robot_control_tpu.configs import C2_REACHER3 as J_C2
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.pallas.fvp_kernel import make_pallas_gn_fvp
from trpo_robot_control_tpu.ops.pallas.pg_kernel import tiles_ok
from trpo_robot_control_tpu.ops.pallas.rollout_kernel import \
    rollout_reference
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import (build, fvp_kernel,
                                                   rollout_kernel)
from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp as p_make_gn_fvp
from trpo_robot_control_tpu_torch.trpo.update import kernel_routes

# one and three hidden layers, Baselines' (32, 32), and widths that are no
# multiple of the kernels' tiles
SHAPES = [(32,), (32, 32), (33, 57), (64, 64, 64)]
P_C2 = pconfigs.C2_REACHER3


def _c2(hidden, **kw):
    """c2 at ``hidden`` in both packages."""
    return (J_C2.replace(trpo=dataclasses.replace(J_C2.trpo, hidden=hidden),
                         **kw),
            P_C2.replace(trpo=dataclasses.replace(P_C2.trpo, hidden=hidden),
                         **kw))


@pytest.mark.parametrize("hidden", SHAPES)
def test_rollout_plain_matches_reference(hidden):
    """K1's plain version against ``rollout_reference`` (the plain scan)
    at c2's arm on shared eps, within 1e-5 over 10 steps, the (64, 64)
    test's bound (tests/test_torch_kernels.py)."""
    jcfg, pcfg = _c2(hidden, horizon=10)
    N = 64
    pn = policy_params_np(np.random.RandomState(40), jcfg.obs_dim, 3, hidden)
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=41)
    ref = rollout_reference(jcfg, {k: j(v) for k, v in pn.items()}, j(q0),
                            j(qd0), j(tgt), j(eps))
    obs_ff, act_ff, rew_ff = rollout_kernel.rollout(
        pcfg, {k: t(v) for k, v in pn.items()}, t(q0), t(qd0), t(tgt),
        eps=t(eps))
    np.testing.assert_allclose(n(obs_ff.permute(2, 0, 1)),
                               np.asarray(ref["obs"]), atol=1e-5)
    np.testing.assert_allclose(n(act_ff.permute(2, 0, 1)),
                               np.asarray(ref["actions"]), atol=1e-5)
    np.testing.assert_allclose(n(rew_ff.T), np.asarray(ref["rewards"]),
                               atol=1e-5)


def test_rollout_plain_matches_pallas_interpret():
    """Once against ``pallas_rollout`` in interpret mode at Baselines'
    (32, 32), at small N, as the (64, 64) test does."""
    jcfg, pcfg = _c2((32, 32), horizon=10)
    N = 128
    pn = policy_params_np(np.random.RandomState(42), jcfg.obs_dim, 3,
                          (32, 32))
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=43)
    pal = jax_batch(jcfg, pn, q0, qd0, tgt, eps)
    out = rollout_kernel.rollout(pcfg, {k: t(v) for k, v in pn.items()},
                                 t(q0), t(qd0), t(tgt), eps=t(eps))
    for key, mine in zip(("obs_ff", "actions_ff", "rewards_ff"), out):
        np.testing.assert_allclose(n(mine), np.asarray(pal[key]), atol=1e-5,
                                   err_msg=key)


def _fvp_case(hidden, B, seed):
    rng = np.random.RandomState(seed)
    pn = policy_params_np(rng, 12, 3, hidden)
    pj = {k: j(v) for k, v in pn.items()}
    obs = rng.standard_normal((B, 12)).astype(np.float32)
    theta, unravel = ravel_pytree(pj)
    f_t = p_make_gn_fvp({k: t(v) for k, v in pn.items()}, t(obs), 0.1)
    vs = [rng.standard_normal(theta.shape[0]).astype(np.float32)
          for _ in range(2)]
    return pj, unravel, obs, f_t, vs


@pytest.mark.parametrize("hidden", SHAPES)
def test_fvp_plain_matches_jax(hidden):
    """K3's plain version, through ``ops.fvp.make_gn_fvp`` on CPU tensors,
    against JAX's ``make_gn_fvp``, within the (64, 64) test's bounds."""
    pj, unravel, obs, f_t, vs = _fvp_case(hidden, 300, 44)
    f_ref = j_make_gn_fvp(pj, unravel, j(obs), damping=0.1)
    for v in vs:
        np.testing.assert_allclose(n(f_t(t(v))), np.asarray(f_ref(j(v))),
                                   rtol=2e-4, atol=2e-6)


def test_fvp_plain_matches_pallas_interpret():
    """Once against ``make_pallas_gn_fvp`` in interpret mode at (32,), with
    a padded tail (300 samples in blocks of 128)."""
    pj, unravel, obs, f_t, vs = _fvp_case((32,), 300, 45)
    f_pal = make_pallas_gn_fvp(pj, unravel, j(obs), damping=0.1,
                               block_b=128, interpret=True)
    for v in vs:
        np.testing.assert_allclose(n(f_t(t(v))), np.asarray(f_pal(j(v))),
                                   rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("hidden", [(32, 32), (64, 64, 64)])
def test_update_parity_c2(hidden):
    """The whole c2 update (N = 128 envs x T = 16 steps) at Baselines'
    (32, 32) and a 3-layer policy, initialised as the JAX package's
    trainer does, against the JAX package's on the same batch: cosine >= 0.999, |beta| rel <= 1e-3, the same accepted
    exponent; on the plain surrogate gradient and K3's plain version, as
    at full size."""
    N, T = 128, 16
    jcfg, pcfg = _c2(hidden, n_envs=N, horizon=T)
    pn = jax_init_params_np(jcfg, seed=46)
    batch = jax_batch(jcfg, pn, *env_inputs_np(jcfg, N, seed=47))
    kernels.reset_counts()
    check_update_parity(jcfg, pcfg, pn, batch)
    calls = kernels.plain_calls()
    assert calls["fvp"] == pcfg.trpo.cg_iters
    assert calls["pg"] == 0 and calls["fvp_ff"] == 0


# the JAX package's gates (its trpo/update.py): the packed surrogate
# gradient from 400,000 samples, the feature-first FVP from 64,000
# subsampled ones, each where ``tiles_ok`` holds
J_SURRGRAD_MIN_B, J_FVP_FF_MIN_B = 400_000, 64_000


@pytest.mark.parametrize("hidden", [(32, 32), (64, 64, 64)])
def test_routes_keep_c2_on_k3(hidden):
    """At c2's full size (1024 envs x 100 steps, 25,600 Fisher samples) the
    port routes the policy to the plain surrogate gradient and the
    batch-major FVP (K3), below both gates, as the JAX package does."""
    tr = P_C2.trpo
    T, N = P_C2.horizon, P_C2.n_envs
    Ts, Ns = T // tr.fvp_subsample, N // tr.fvp_env_subsample
    pn = policy_params_np(np.random.RandomState(48), P_C2.obs_dim, 3, hidden)
    routes = kernel_routes(tr, {k: t(v) for k, v in pn.items()}, T, N, Ts,
                           Ns)
    pj = {k: j(v) for k, v in pn.items()}
    jax_routes = dict(
        surrgrad="pallas" if T * N >= J_SURRGRAD_MIN_B and tiles_ok(T, N, pj)
        else "xla",
        fvp="ff" if Ts * Ns >= J_FVP_FF_MIN_B and tiles_ok(Ts, Ns, pj)
        else "bm")
    assert routes == jax_routes == dict(surrgrad="xla", fvp="bm")


@pytest.mark.parametrize("hidden", [(32, 32, 32, 32), (129,), (64, 129)])
def test_kernels_refuse_shapes_past_b3_before_building(hidden):
    """K1's and K3's occupancy refuse four layers or a 129-wide one (their
    unpacked forms take up to 128 units), naming ROADMAP B3, before they
    build anything: the rule the wrappers apply to CUDA tensors
    (``build.check_hidden``)."""
    before = set(build.LIBS)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        rollout_kernel.occupancy(3, False, hidden=hidden)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        fvp_kernel.occupancy(12, 3, hidden)
    assert set(build.LIBS) == before
