"""The 7-DoF arm of the PyTorch port against the JAX package on the CPU:
the generic rigid-body path (FK, mass matrix, forward dynamics), the 3-D
rollout kernel's plain version against JAX's ``rollout3d_reference`` and
against the port's own generic RNEA path, its bf16 stores, and the c3
rollout route. ``test_torch_rollout3d_pallas.py`` holds it against the
Pallas kernel in interpret mode; ``test_torch_cuda.py`` holds the CUDA
kernel against it on the card."""
import numpy as np
import pytest
import torch

from test_torch_helpers import (env_inputs_np, j, jax_batch3d, n,
                                policy_params_np, t)
from trpo_robot_control_tpu.configs import C3_FRANKA7 as J_C3
from trpo_robot_control_tpu.envs import rigid_body as jrb
from trpo_robot_control_tpu_torch.configs import C3_FRANKA7 as P_C3
from trpo_robot_control_tpu_torch.envs import arm
from trpo_robot_control_tpu_torch.envs import rigid_body as prb
from trpo_robot_control_tpu_torch.models import policy
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3


def _rel(a, b):
    b = np.asarray(b)
    return float(np.abs(n(a) - b).max() / np.abs(b).max())


def test_rigid_body_matches_jax():
    rng = np.random.RandomState(0)
    q = (0.2 * rng.uniform(-1, 1, (32, 7))).astype(np.float32)
    qd = (0.5 * rng.uniform(-1, 1, (32, 7))).astype(np.float32)
    tau = rng.uniform(-5, 5, (32, 7)).astype(np.float32)
    spec_j, spec_p = J_C3.arm, P_C3.arm
    R_j, p_j, ee_j = jrb.fk(spec_j, j(q))
    R_t, p_t, ee_t = prb.fk(spec_p, t(q))
    for a, b in zip(R_t + p_t + [ee_t], R_j + p_j + [ee_j]):
        np.testing.assert_allclose(n(a), np.asarray(b), atol=1e-5)
    assert _rel(prb.mass_matrix(spec_p, t(q)),
                jrb.mass_matrix(spec_j, j(q))) <= 1e-5
    assert _rel(prb.bias(spec_p, t(q), t(qd)),
                jrb.bias(spec_j, j(q), j(qd))) <= 1e-5
    assert _rel(prb.forward_dynamics(spec_p, t(q), t(qd), t(tau)),
                jrb.forward_dynamics(spec_j, j(q), j(qd), j(tau))) <= 1e-5
    # the constants keep the float32 rounding of the numpy literals
    cj, cp = jrb.ArmConstants(spec_j), prb.ArmConstants(spec_p)
    for a, b in zip(cp.T_rot + cp.T_pos + cp.com + cp.inertia,
                    cj.T_rot + cj.T_pos + cj.com + cj.inertia):
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_rollout3d_plain_matches_reference():
    """Same tolerance as the Pallas kernel against its jnp twin."""
    T, N = 8, 128
    jcfg, pcfg = J_C3.replace(horizon=T), P_C3.replace(horizon=T)
    pn = policy_params_np(np.random.RandomState(1), jcfg.obs_dim, 7)
    ins = env_inputs_np(jcfg, N, seed=2)
    ref = jax_batch3d(jcfg, pn, *ins, store_bf16=False)
    obs_ff, act_ff, rew_ff = r3.rollout3d(
        pcfg, {k: t(v) for k, v in pn.items()}, *(t(x) for x in ins[:3]),
        torch.zeros(N, dtype=torch.int32), eps=t(ins[3]))
    assert obs_ff.shape == (T, 24, N) and obs_ff.dtype == torch.float32
    for key, mine in (("obs_ff", obs_ff), ("actions_ff", act_ff),
                      ("rewards_ff", rew_ff)):
        np.testing.assert_allclose(n(mine), np.asarray(ref[key]), atol=1e-5,
                                   err_msg=key)


def _rnea_path_rollout(cfg, params, q, qd, tgt, eps):
    """The port's generic path: observe, policy mean, RNEA dynamics step,
    reward at the post-step state."""
    spec = cfg.arm
    sigma = torch.exp(params["logstd"])
    obs, acts, rews = [], [], []
    for eps_t in eps:
        ee = prb.fk(spec, q)[2]
        o = torch.cat([torch.cos(q), torch.sin(q), spec.qd_obs_scale * qd,
                       tgt - ee], dim=-1)
        a = policy.mean_net(params, o) + sigma * eps_t
        tau = torch.clamp(a, -spec.torque_limit, spec.torque_limit)
        q, qd = prb.dynamics_step(spec, q, qd, tau)
        d = prb.fk(spec, q)[2] - tgt
        rews.append(-(torch.sum(d * d, -1)
                      + cfg.cost.ctrl_weight * torch.sum(tau * tau, -1)))
        obs.append(o)
        acts.append(a)
    return torch.stack(obs), torch.stack(acts), torch.stack(rews)


def test_rollout3d_plain_matches_generic_rnea_path():
    """The fused component math against the generic RNEA path, within the
    JAX package's own bounds for the same comparison."""
    T, N = 8, 16
    cfg = P_C3.replace(horizon=T)
    pn = policy_params_np(np.random.RandomState(3), cfg.obs_dim, 7)
    pt = {k: t(v) for k, v in pn.items()}
    q0, qd0, tgt, eps = (t(x) for x in env_inputs_np(cfg, N, seed=4))
    obs, act, rew = _rnea_path_rollout(cfg, pt, q0, qd0, tgt, eps)
    obs_ff, act_ff, rew_ff = r3.rollout3d(
        cfg, pt, q0, qd0, tgt, torch.zeros(N, dtype=torch.int32), eps=eps)
    np.testing.assert_allclose(n(obs_ff.permute(0, 2, 1)), n(obs), atol=5e-4)
    np.testing.assert_allclose(n(act_ff.permute(0, 2, 1)), n(act), atol=5e-4)
    np.testing.assert_allclose(n(rew_ff), n(rew), atol=2e-3)


def test_rollout3d_bf16_stores_and_route():
    """bf16 stores round the fp32 trajectory once; rewards stay fp32. The
    c3 rollout function routes to this kernel with bf16 stores and 3-D
    targets on the upper hemisphere."""
    T, N = 4, 8
    cfg = P_C3.replace(horizon=T, n_envs=N)
    pn = policy_params_np(np.random.RandomState(5), cfg.obs_dim, 7)
    pt = {k: t(v) for k, v in pn.items()}
    ins = [t(x) for x in env_inputs_np(cfg, N, seed=6)]
    task = torch.zeros(N, dtype=torch.int32)
    f32 = r3.rollout3d(cfg, pt, *ins[:3], task, eps=ins[3])
    b16 = r3.rollout3d(cfg, pt, *ins[:3], task, eps=ins[3],
                       store_dtype=torch.bfloat16)
    for a, b in zip(b16[:2], f32[:2]):
        assert a.dtype == torch.bfloat16
        assert torch.equal(a, b.to(torch.bfloat16))
    assert b16[2].dtype == torch.float32 and torch.equal(b16[2], f32[2])
    with pytest.raises(ValueError, match="Philox"):
        r3.rollout3d(cfg, pt, *ins[:3], task,
                     seed=torch.zeros(2, dtype=torch.int64))

    gen = torch.Generator().manual_seed(0)
    s = arm.reset(cfg, gen, 256)
    radius = torch.linalg.norm(s.tgt, dim=-1)
    assert bool((s.tgt[:, 2] >= 0).all())
    assert bool((radius >= cfg.arm.target_rmin_frac * cfg.arm.reach - 1e-5)
                .all())
    assert bool((radius <= cfg.arm.target_rmax_frac * cfg.arm.reach + 1e-5)
                .all())
    before = r3.rollout3d_plain.calls
    batch = arm.make_rollout_fn(cfg)(pt, gen)
    assert r3.rollout3d_plain.calls == before + 1
    assert batch["obs_ff"].shape == (T, 24, N)
    assert batch["obs_ff"].dtype == torch.bfloat16
    assert batch["actions_ff"].dtype == torch.bfloat16
    assert batch["rewards_ff"].dtype == torch.float32
    assert bool(torch.isfinite(batch["rewards_ff"]).all())
