"""The port's three kernels against the JAX package: on the CPU each
wrapper runs its plain PyTorch version, which is held against the Pallas
kernel in interpret mode and against its JAX twin on the same numpy
inputs (the planar rollout at 1-8 links, and with bf16 stores).
``test_torch_cuda.py`` holds each CUDA kernel against its plain version on
the card."""
import numpy as np
import pytest
import torch

from jax.flatten_util import ravel_pytree

from test_torch_helpers import (env_inputs_np, j, jax_batch, n,
                                policy_params_np, t)
from trpo_robot_control_tpu.configs import (C1_REACHER2, C2_REACHER3,
                                            planar_arm)
from trpo_robot_control_tpu.models import baseline as jbase
from trpo_robot_control_tpu.ops.fvp import make_gn_fvp as j_make_gn_fvp
from trpo_robot_control_tpu.ops.pallas.fvp_kernel import make_pallas_gn_fvp
from trpo_robot_control_tpu.ops.pallas.moments_kernel import \
    pallas_baseline_moments
from trpo_robot_control_tpu.ops.pallas.rollout_kernel import (
    pallas_rollout, rollout_reference)
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.models import baseline
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import (moments_kernel,
                                                   rollout_kernel)
from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp as p_make_gn_fvp


def _planar_cfgs(name, **kw):
    """A config name, or ``planarN``: c2 with ``planar_arm(N)``, in both
    packages."""
    if name.startswith("planar"):
        links = int(name[len("planar"):])
        return (C2_REACHER3.replace(arm=planar_arm(links), **kw),
                pconfigs.C2_REACHER3.replace(arm=pconfigs.planar_arm(links),
                                             **kw))
    return ({"c1_reacher2": C1_REACHER2, "c2_reacher3": C2_REACHER3}[name]
            .replace(**kw), pconfigs.CONFIGS[name].replace(**kw))


# Arms whose fp32 rollouts part within a few steps: at 4 and 8 links the
# mass matrix is ill-conditioned enough that two fp32 operation orders
# drift past 1e-5 (JAX's own fp32 rollout is as far from an fp64
# evaluation as the port's, 1.7e-4 at 8 links after one step), so these
# cases hold the same function in fp64.
FP64_CASES = ("planar4", "planar8")


@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3", "planar1",
                                  "planar4", "planar8"])
def test_rollout_plain_matches_pallas_and_reference(name):
    """The plain version against the Pallas kernel in interpret mode and
    ``rollout_reference`` within 1e-5; at FP64_CASES the plain version in
    float64 against ``rollout_reference`` under ``jax.enable_x64`` (the
    Pallas kernel is fp32 only)."""
    jcfg, pcfg = _planar_cfgs(name, horizon=10)
    N = 128
    pn = policy_params_np(np.random.RandomState(0), jcfg.obs_dim,
                          jcfg.arm.n_joints)
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=1)
    if name in FP64_CASES:
        import jax
        import jax.numpy as jnp
        with jax.enable_x64(True):
            ref = rollout_reference(
                jcfg, {k: jnp.asarray(v, jnp.float64) for k, v in pn.items()},
                *(jnp.asarray(x, jnp.float64) for x in (q0, qd0, tgt, eps)))
            ref = {k: np.asarray(v) for k, v in ref.items()}
        assert ref["obs"].dtype == np.float64
        mine = rollout_kernel.rollout_plain(
            pcfg, {k: torch.tensor(v, dtype=torch.float64)
                   for k, v in pn.items()},
            *(torch.tensor(x, dtype=torch.float64)
              for x in (q0, qd0, tgt, eps)))
        for key, x, order in (("obs", mine[0], (2, 0, 1)),
                              ("actions", mine[1], (2, 0, 1))):
            np.testing.assert_allclose(n(x.permute(*order)), ref[key],
                                       atol=1e-5, err_msg=key)
        np.testing.assert_allclose(n(mine[2].T), ref["rewards"], atol=1e-5)
        return
    pal = jax_batch(jcfg, pn, q0, qd0, tgt, eps)
    ref = rollout_reference(jcfg, {k: j(v) for k, v in pn.items()}, j(q0),
                            j(qd0), j(tgt), j(eps))
    obs_ff, act_ff, rew_ff = rollout_kernel.rollout(
        pcfg, {k: t(v) for k, v in pn.items()}, t(q0), t(qd0), t(tgt),
        eps=t(eps))
    assert obs_ff.shape == (10, jcfg.obs_dim, N)
    # same tolerance as the Pallas kernel against its JAX twin
    for key, mine in (("obs_ff", obs_ff), ("actions_ff", act_ff),
                      ("rewards_ff", rew_ff)):
        np.testing.assert_allclose(n(mine), np.asarray(pal[key]), atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(n(obs_ff.permute(2, 0, 1)),
                               np.asarray(ref["obs"]), atol=1e-5)
    np.testing.assert_allclose(n(act_ff.permute(2, 0, 1)),
                               np.asarray(ref["actions"]), atol=1e-5)
    np.testing.assert_allclose(n(rew_ff.T), np.asarray(ref["rewards"]),
                               atol=1e-5)


def test_rollout_bf16_stores_match_pallas():
    """c2 with bf16 stores: the plain version's obs and actions within one
    bf16 ulp of ``pallas_rollout(store_dtype=bf16)`` in interpret mode, and
    0 ulps from its own fp32 output rounded once; rewards stay fp32."""
    import jax.numpy as jnp
    jcfg, pcfg = _planar_cfgs("c2_reacher3", horizon=10)
    N = 128
    pn = policy_params_np(np.random.RandomState(6), jcfg.obs_dim, 3)
    q0, qd0, tgt, eps = env_inputs_np(jcfg, N, seed=7)
    pal = pallas_rollout(jcfg, {k: j(v) for k, v in pn.items()}, 0,
                         n_envs=N, eps=j(eps), block_b=128, interpret=True,
                         q0=j(q0), qd0=j(qd0), tgt=j(tgt),
                         store_dtype=jnp.bfloat16)
    pt = {k: t(v) for k, v in pn.items()}
    b16 = rollout_kernel.rollout(pcfg, pt, t(q0), t(qd0), t(tgt), eps=t(eps),
                                 store_dtype=torch.bfloat16)
    f32 = rollout_kernel.rollout(pcfg, pt, t(q0), t(qd0), t(tgt), eps=t(eps))
    for key, mine, own in (("obs_ff", b16[0], f32[0]),
                           ("actions_ff", b16[1], f32[1])):
        assert mine.dtype == torch.bfloat16
        assert torch.equal(mine, own.to(torch.bfloat16)), key
        ref = np.asarray(pal[key].astype(jnp.float32))
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 2.0 ** -126)))
                      - 7)
        assert (np.abs(n(mine.float()) - ref) / ulp).max() <= 1.0, key
    assert b16[2].dtype == torch.float32 and torch.equal(b16[2], f32[2])


@pytest.mark.parametrize("n", [0, 9, 12])
def test_rollout_occupancy_refuses_joint_counts_it_is_not_built_for(n):
    """The planar kernel has instantiations for 1-8 joints only;
    ``occupancy`` says so before it builds or loads anything."""
    with pytest.raises(NotImplementedError, match="1-8 joints"):
        rollout_kernel.occupancy(n, False)


def test_moments_plain_matches_pallas_and_twin():
    rng = np.random.RandomState(2)
    T, do, N = 16, 12, 256
    obs = rng.standard_normal((T, do, N)).astype(np.float32)
    y = (5.0 * rng.standard_normal((T, N))).astype(np.float32)
    A_p, b_p = pallas_baseline_moments(j(obs), j(y), horizon=T,
                                       interpret=True)
    A_j, b_j = jbase.normal_eq_ff(j(obs), j(y), horizon=T)
    A_t, b_t = moments_kernel.baseline_moments(t(obs), t(y), T)
    for A_ref, b_ref in ((A_p, b_p), (A_j, b_j)):
        np.testing.assert_allclose(n(A_t), np.asarray(A_ref), rtol=2e-5,
                                   atol=2e-3)
        np.testing.assert_allclose(n(b_t), np.asarray(b_ref), rtol=2e-5,
                                   atol=2e-3)
    # the A_tt block is the same exact fp32 N tau^T tau
    np.testing.assert_allclose(n(A_t)[2 * do:, 2 * do:],
                               np.asarray(A_j)[2 * do:, 2 * do:], rtol=1e-6)


# (T, N) of c1, c2, c3, c4, c5 and ragged ones (N not a multiple of the
# 128-sample tile; tiles that straddle two steps)
@pytest.mark.parametrize("T,N", [(50, 64), (100, 1024), (200, 4096),
                                 (200, 16384), (200, 65536), (100, 1000),
                                 (20, 300), (7, 37)])
def test_moments_fp32_grid_and_scratch(T, N):
    """K2 fp32 mode's grid and scratch, as the wrapper computes them: at
    most F32_GRID blocks and no more than the 128-sample tiles (block b
    walks tiles b, b + grid, ..., so every block has one); each block the
    same most tiles the fixed grid allows, and the fewest blocks that do;
    room for every block's partial and every group's sum."""
    grid = moments_kernel.fp32_grid(T, N)
    tiles = -(-T * N // moments_kernel.TILE)
    most = -(-tiles // moments_kernel.F32_GRID)
    assert 1 <= grid <= min(tiles, moments_kernel.F32_GRID)
    assert -(-tiles // grid) == most
    assert grid == 1 or -(-tiles // (grid - 1)) > most
    groups = -(-grid // moments_kernel.F32_GROUP)
    for do in (1, 9, 12, 32):
        E = (2 * do + 5) * (2 * do + 6) // 2
        assert moments_kernel.fp32_scratch(grid, do) == (grid + groups) * E


@pytest.mark.parametrize("B", [300, 512])
def test_fvp_plain_matches_pallas_and_twin(B):
    rng = np.random.RandomState(3)
    pn = policy_params_np(rng, 12, 3)
    pj = {k: j(v) for k, v in pn.items()}
    obs = rng.standard_normal((B, 12)).astype(np.float32)
    theta, unravel = ravel_pytree(pj)
    f_pal = make_pallas_gn_fvp(pj, unravel, j(obs), damping=0.1,
                               block_b=128, interpret=True)
    f_ref = j_make_gn_fvp(pj, unravel, j(obs), damping=0.1)
    f_t = p_make_gn_fvp({k: t(v) for k, v in pn.items()}, t(obs), 0.1)
    for s in range(2):
        v = rng.standard_normal(theta.shape[0]).astype(np.float32)
        mine = n(f_t(t(v)))
        np.testing.assert_allclose(mine, np.asarray(f_pal(j(v))), rtol=2e-4,
                                   atol=2e-6)
        np.testing.assert_allclose(mine, np.asarray(f_ref(j(v))), rtol=2e-4,
                                   atol=2e-6)


def test_wrappers_take_the_plain_version_on_cpu():
    kernels.reset_counts()
    cfg = pconfigs.C1_REACHER2.replace(horizon=4)
    pn = policy_params_np(np.random.RandomState(4), cfg.obs_dim, 2)
    pt = {k: t(v) for k, v in pn.items()}
    q0, qd0, tgt, eps = env_inputs_np(cfg, 8, seed=5)
    with pytest.raises(ValueError, match="Philox"):
        rollout_kernel.rollout(cfg, pt, t(q0), t(qd0), t(tgt),
                               seed=torch.zeros(2, dtype=torch.int64))
    obs_ff, _, rew_ff = rollout_kernel.rollout(cfg, pt, t(q0), t(qd0),
                                               t(tgt), eps=t(eps))
    A, b = moments_kernel.baseline_moments(obs_ff, rew_ff, 4)
    baseline.fit_normal(A + 1e-3 * torch.eye(A.shape[0]), b)
    p_make_gn_fvp(pt, obs_ff.permute(0, 2, 1).reshape(-1, cfg.obs_dim),
                  0.1)(torch.ones(sum(v.numel() for v in pt.values())))
    assert kernels.launch_counts() == {"rollout": 0, "moments": 0, "fvp": 0,
                                       "rollout3d": 0, "pg": 0, "fvp_ff": 0,
                                       "fit_normal": 0}
    assert kernels.plain_calls() == {"rollout": 1, "moments": 1, "fvp": 1,
                                     "rollout3d": 0, "pg": 0, "fvp_ff": 0,
                                     "fit_normal": 1}
