"""Policies wider than 64 units (ROADMAP B3), on the CPU against the JAX
package: the plain versions of the planar rollout (K1), the 3-D rollout
(K4) and the batch-major FVP (K3) at rllab's (100, 50, 25) policy (Duan
et al. 2016), JAX's own unpacked test shape (96, 96) and the top of the
range (128, 128, 128), once each against the Pallas kernel's unpacked
form in interpret mode, the c2 and c3 updates at (100, 50, 25), and the
per-kernel width caps of ``build.check_hidden``.
``test_torch_cuda.py`` holds the CUDA kernels' wide forms to these plain
versions on the card."""
import dataclasses

import numpy as np
import pytest
import torch

from jax.flatten_util import ravel_pytree

from test_torch_helpers import (check_update_parity, env_inputs_np, j,
                                jax_batch, jax_batch3d, jax_ff_batch,
                                jax_init_params_np, n, policy_params_np, t)
from trpo_robot_control_tpu.configs import C2_REACHER3 as J_C2
from trpo_robot_control_tpu.configs import C3_FRANKA7 as J_C3
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.pallas.fvp_kernel import make_pallas_gn_fvp
from trpo_robot_control_tpu.ops.pallas.rollout_kernel import \
    rollout_reference
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import (build, fvp_ff_kernel,
                                                   rollout3d_kernel,
                                                   rollout_kernel)
from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp as p_make_gn_fvp

RLLAB = (100, 50, 25)


def _cfgs(jbase, pbase, hidden, **kw):
    """A config at ``hidden`` in both packages."""
    return (jbase.replace(trpo=dataclasses.replace(jbase.trpo, hidden=hidden),
                          **kw),
            pbase.replace(trpo=dataclasses.replace(pbase.trpo, hidden=hidden),
                          **kw))


@pytest.mark.parametrize("hidden", [RLLAB, (128, 128, 128)])
def test_rollout_plain_matches_reference(hidden):
    """K1's plain version against ``rollout_reference`` (the plain scan) at
    c2's arm on shared eps, within 1e-5 over 10 steps, the (64, 64)
    test's bound (tests/test_torch_kernels.py)."""
    jcfg, pcfg = _cfgs(J_C2, pconfigs.C2_REACHER3, hidden, horizon=10)
    N = 64
    pn = policy_params_np(np.random.RandomState(60), jcfg.obs_dim, 3, hidden)
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=61)
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
    """Once against ``pallas_rollout`` in interpret mode at (100, 50, 25),
    whose widths take its unpacked ``_policy_ff``, at small N and T."""
    jcfg, pcfg = _cfgs(J_C2, pconfigs.C2_REACHER3, RLLAB, horizon=6)
    N = 32
    pn = policy_params_np(np.random.RandomState(62), jcfg.obs_dim, 3, RLLAB)
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=63)
    pal = jax_batch(jcfg, pn, q0, qd0, tgt, eps)
    out = rollout_kernel.rollout(pcfg, {k: t(v) for k, v in pn.items()},
                                 t(q0), t(qd0), t(tgt), eps=t(eps))
    for key, mine in zip(("obs_ff", "actions_ff", "rewards_ff"), out):
        np.testing.assert_allclose(n(mine), np.asarray(pal[key]), atol=1e-5,
                                   err_msg=key)


@pytest.fixture(scope="module")
def c3_rllab():
    """A small c3 at (100, 50, 25), N = 128 envs x T = 16 steps (the size
    of the (32, 32) and (64, 64, 64) update tests), in both packages: the
    configs, the policy, the inputs and the JAX reference batch
    (``rollout3d_reference``, bf16 storage), shared by the rollout and the
    update test."""
    N, T = 128, 16
    jcfg, pcfg = _cfgs(J_C3, pconfigs.C3_FRANKA7, RLLAB, n_envs=N, horizon=T)
    pn = policy_params_np(np.random.RandomState(70), jcfg.obs_dim, 7, RLLAB)
    ins = env_inputs_np(jcfg, N, seed=71)
    return jcfg, pcfg, pn, ins, jax_batch3d(jcfg, pn, *ins)


def test_rollout3d_plain_matches_reference(c3_rllab):
    """K4's plain version against ``rollout3d_reference`` on shared noise at
    a small c3, at (100, 50, 25): the tolerance of the (64, 64) test
    (tests/test_torch_rollout3d.py)."""
    _, pcfg, pn, ins, ref = c3_rllab
    N = ins[0].shape[0]
    out = rollout3d_kernel.rollout3d(
        pcfg, {k: t(v) for k, v in pn.items()}, *(t(x) for x in ins[:3]),
        torch.zeros(N, dtype=torch.int32), eps=t(ins[3]))
    # the reference's batch-major (N, T, d) and (N, T) in the kernel's
    # feature-first layout
    want = (np.asarray(ref["obs"]).transpose(1, 2, 0),
            np.asarray(ref["actions"]).transpose(1, 2, 0),
            np.asarray(ref["rewards"]).T)
    for key, mine, ref_ff in zip(("obs", "actions", "rewards"), out, want):
        np.testing.assert_allclose(n(mine), ref_ff, atol=1e-5, err_msg=key)


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


@pytest.mark.parametrize("hidden", [(96, 96), RLLAB])
def test_fvp_plain_matches_jax(hidden):
    """K3's plain version, through ``ops.fvp.make_gn_fvp`` on CPU tensors,
    against JAX's ``make_gn_fvp``, within the (64, 64) test's bounds."""
    pj, unravel, obs, f_t, vs = _fvp_case(hidden, 300, 66)
    f_ref = j_make_gn_fvp(pj, unravel, j(obs), damping=0.1)
    for v in vs:
        np.testing.assert_allclose(n(f_t(t(v))), np.asarray(f_ref(j(v))),
                                   rtol=2e-4, atol=2e-6)


def test_fvp_plain_matches_pallas_interpret():
    """Once against ``make_pallas_gn_fvp`` in interpret mode at
    (100, 50, 25), which takes its unpacked ``_fvp_kernel``, with a
    padded tail (100 samples in blocks of 64)."""
    pj, unravel, obs, f_t, vs = _fvp_case(RLLAB, 100, 67)
    f_pal = make_pallas_gn_fvp(pj, unravel, j(obs), damping=0.1,
                               block_b=64, interpret=True)
    for v in vs:
        np.testing.assert_allclose(n(f_t(t(v))), np.asarray(f_pal(j(v))),
                                   rtol=2e-4, atol=2e-6)


@pytest.mark.parametrize("path", ["c2", "c3"])
def test_update_parity_rllab(path, request):
    """The whole c2 update (fp32 storage) and c3 update (bf16 storage) at
    rllab's (100, 50, 25) on N = 128 envs x T = 16 steps (the size of the
    (32, 32) and (64, 64, 64) tests), against the JAX package's on the same
    batch: cosine >= 0.999, |beta| rel <= 1e-3, the same accepted exponent;
    on the plain surrogate gradient and K3's plain version (JAX's width
    rule: no K5 or K6 past 64 units)."""
    if path == "c2":
        N, T = 128, 16
        jcfg, pcfg = _cfgs(J_C2, pconfigs.C2_REACHER3, RLLAB, n_envs=N,
                           horizon=T)
        pn = jax_init_params_np(jcfg, seed=68)
        q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=69)
        batch = jax_ff_batch(jcfg, {k: np.asarray(v) for k, v in
                                    rollout_reference(
                                        jcfg, {k: j(v) for k, v in pn.items()},
                                        j(q0), j(qd0), j(tgt),
                                        j(eps)).items()})
    else:
        jcfg, pcfg, pn, _, batch = request.getfixturevalue("c3_rllab")
    kernels.reset_counts()
    check_update_parity(jcfg, pcfg, pn, batch)
    calls = kernels.plain_calls()
    assert calls["fvp"] == pcfg.trpo.cg_iters
    assert calls["pg"] == 0 and calls["fvp_ff"] == 0


@pytest.mark.parametrize("source", ["rollout", "rollout3d", "fvp"])
def test_unpacked_kernels_take_widths_up_to_128(source):
    """K1, K4 and K3 take 1-3 hidden layers of up to 128 units and refuse a
    129-wide layer or a fourth layer, naming ROADMAP B3, before they build
    anything; the check is the one their wrappers make on CUDA tensors."""
    before = set(build.LIBS)
    assert build.check_hidden((128, 128, 128), source) == (128, 128, 128)
    assert build.check_hidden(RLLAB, source) == RLLAB
    for hidden in [(129,), (64, 129), (32, 32, 32, 32)]:
        with pytest.raises(NotImplementedError, match="ROADMAP B3"):
            build.check_hidden(hidden, source)
    assert set(build.LIBS) == before


def test_packed_kernels_keep_widths_up_to_64():
    """K5 and K6 keep their TPU twins' packed widths: (64, 64, 64) passes,
    a 65-wide layer raises, naming ROADMAP B3, in the check and in K6's
    occupancy, before anything is built."""
    before = set(build.LIBS)
    for source in ("pg", "fvp_ff"):
        assert build.check_hidden((64, 64, 64), source) == (64, 64, 64)
        with pytest.raises(NotImplementedError, match="ROADMAP B3"):
            build.check_hidden((65,), source)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        fvp_ff_kernel.occupancy(hidden=(65,))
    assert set(build.LIBS) == before
