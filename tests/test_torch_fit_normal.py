"""The linear baseline's ridge solve: the statement of the fit_normal
kernel's arithmetic (``test_torch_helpers.fit_normal_jacobi_statement``:
cyclic Jacobi in the kernel's round-robin order, fp32) against numpy's
fp64 ``eigh`` on SPD systems of the port's sizes (F = 2 do + 4, do up to
32) and against JAX's ``fit_normal`` on the normal equations of c1-c5
batches; its eigenpairs' backward residual and its solve from them; the
kernel itself is held to the statement on the card (``test_torch_cuda.py``).
Every bound against an fp64 solve is capped (``fit_bound``) below what
w = 0 reads, and each test checks that it is."""
import numpy as np
import pytest
import torch

from test_torch_helpers import (FIT_CAP_SPD, FIT_RES_TOL, FIT_SOLVE_TOL,
                                _round_robin, a_norm_rel, fit_bound,
                                fit_normal_jacobi_statement,
                                fit_pairs_errors, fixed_position_schedule,
                                fp64_floored_solve, j, n,
                                schedule_index_at, schedule_position_of,
                                spd_system_np, t)
from trpo_robot_control_tpu.models import baseline as jbase
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.envs import arm
from trpo_robot_control_tpu_torch.models import baseline as pbase
from trpo_robot_control_tpu_torch.ops import cuda as kernels
from trpo_robot_control_tpu_torch.ops.cuda import fit_kernel, moments_kernel
from trpo_robot_control_tpu_torch.ops.gae import gae
from trpo_robot_control_tpu_torch.trpo.train import init_state

REL_FLOOR = 1e-6
# eigenvalues: within this of lambda_max, against fp64 eigh of the same
# fp32 matrix (fp32 Jacobi: backward error a few ulps of ||A_s||)
LAM_TOL = 1e-5
# w against the fp64 solve with the same floor (a_norm_rel: prediction
# space, ||w - w64||_A / ||w64||_A) within fit_bound: FIT_UNITS fp32 unit
# roundoffs times the kept spectrum's condition number, which any fp32
# solve of an fp32 A_s may reach (fp32 eigh, the plain version, is held to
# the same bound), capped at FIT_CAP_SPD. On the config batches below, the
# largest difference of phi @ w over the values' mean magnitude, capped at
# BATCH_CAP: readings up to 4.3e-3 (the plain version at c3-c5, 16 envs x
# 20 steps); w = 0 reads 2.8 or more
BATCH_CAP = 2e-2
# Q^T Q - I: each of the ~400-750 rotations of a solve keeps c^2 + s^2
# within a few fp32 roundings of 1, and nothing renormalises the columns
# (measured up to 1.8e-5 at F = 68)
ORTH_TOL = 1e-4


@pytest.mark.parametrize("cond", [1e2, 1e4, 1e6, 1e8])
@pytest.mark.parametrize("do", [6, 9, 12, 15, 24, 27, 32])
def test_jacobi_statement_matches_fp64_eigh(do, cond):
    A, b = (t(x) for x in spd_system_np(do, cond, seed=do))
    w, lam, Q, sweeps = fit_normal_jacobi_statement(A, b)
    w64, kept_cond = fp64_floored_solve(A, b)
    A64 = n(A).astype(np.float64)
    d = np.sqrt(np.diag(A64) + 1e-20)
    lam64 = np.linalg.eigvalsh(A64 / np.outer(d, d))
    assert 1 <= sweeps < fit_kernel.MAX_SWEEPS
    lam_err = np.abs(np.sort(n(lam).astype(np.float64)) - lam64).max()
    assert lam_err <= LAM_TOL * lam64[-1], (lam_err, lam64[-1])
    # Q stays orthonormal
    Qn = n(Q).astype(np.float64)
    assert np.abs(Qn.T @ Qn - np.eye(len(b))).max() < ORTH_TOL
    res, solve = fit_pairs_errors(A, b, w, lam, Q)
    assert res <= FIT_RES_TOL and solve <= FIT_SOLVE_TOL, (res, solve)
    if np.any(np.abs(lam64 - REL_FLOOR * lam64[-1])
              <= 0.1 * REL_FLOOR * lam64[-1]):
        return      # an eigenvalue at the floor: the two may cut it apart
    bound = fit_bound(kept_cond, FIT_CAP_SPD)
    assert a_norm_rel(A, torch.zeros_like(w), w64) > bound
    w_p = fit_kernel.fit_normal_plain(A, b)
    assert a_norm_rel(A, w, w64) <= bound, (kept_cond, bound)
    assert a_norm_rel(A, w_p, w64) <= bound
    assert a_norm_rel(A, w, w_p) <= bound


def _config_moments(name, seed):
    """(A + reg I, b, phi) of a small batch of config ``name`` from the
    port's CPU rollout (the plain versions), the GAE targets of a zero
    baseline as the targets; the kernels' moments in fp64 sums."""
    cfg = pconfigs.CONFIGS[name].replace(n_envs=16, horizon=20)
    state = init_state(cfg, seed=seed, device="cpu")
    batch = arm.make_rollout_fn(cfg)(state.params, state.gen)
    rew = batch["rewards_ff"]
    targets = gae(rew, torch.zeros_like(rew), cfg.trpo.gamma, cfg.trpo.lam,
                  time_axis=0)
    A, b = moments_kernel.baseline_moments(batch["obs_ff"], targets,
                                           cfg.horizon)
    A = A + cfg.trpo.baseline_reg * torch.eye(A.shape[0])
    phi = pbase.features(batch["obs"].float(), cfg.horizon)
    return A, b, phi.reshape(-1, A.shape[0])


@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3", "c3_franka7",
                                  "c4_franka7_obstacle", "c5_multitask"])
def test_jacobi_statement_matches_jax_fit_normal_on_config_moments(name):
    """In prediction space (phi @ w over the batch, the largest difference
    over the values' mean magnitude): the statement, JAX's ``fit_normal``
    and the plain version each against the fp64 solve, and the statement
    against JAX's, within FIT_UNITS unit roundoffs times the kept
    condition number (~1e6 at c1 and c3-c5 on these small batches), capped
    at BATCH_CAP; the statement's eigenpairs and solve as in the test
    above."""
    A, b, phi = _config_moments(name, seed=3)
    P = n(phi).astype(np.float64)
    w64, kept_cond = fp64_floored_solve(A, b)
    v64 = P @ n(w64)
    bound = fit_bound(kept_cond, BATCH_CAP)
    scale = np.abs(v64).mean()
    err = lambda v, ref=v64: np.abs(v - ref).max() / scale
    w, lam, Q, sweeps = fit_normal_jacobi_statement(A, b)
    assert 1 <= sweeps < fit_kernel.MAX_SWEEPS
    res, solve = fit_pairs_errors(A, b, w, lam, Q)
    assert res <= FIT_RES_TOL and solve <= FIT_SOLVE_TOL, (res, solve)
    v_s = P @ n(w).astype(np.float64)
    v_j = P @ np.asarray(jbase.fit_normal(j(A), j(b)), np.float64)
    v_p = P @ n(fit_kernel.fit_normal_plain(A, b)).astype(np.float64)
    assert err(np.zeros_like(v64)) > bound
    assert max(err(v_s), err(v_j), err(v_p), err(v_s, v_j)) <= bound, \
        (err(v_s), err(v_j), err(v_p), err(v_s, v_j), bound)


def test_jacobi_statement_floor_and_non_finite_guard():
    """A direction under the floor is dropped as JAX drops it (a singular
    2 x 2 block: its null direction goes, w takes the pseudo-inverse's
    [0.5, 0.5]); an all-NaN system gives w = 0, as in the plain version."""
    bad = np.array([[1, 1, 0, 0], [1, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 2]],
                   np.float32)
    w, lam, _, _ = fit_normal_jacobi_statement(t(bad), t(np.ones(4)))
    assert float(lam.min()) < 1e-6 * float(lam.max())
    np.testing.assert_allclose(n(w), [0.5, 0.5, 1.0, 0.5], rtol=1e-6)
    np.testing.assert_allclose(
        n(w), np.asarray(jbase.fit_normal(j(bad), j(np.ones(4)))), rtol=1e-6)
    nan = torch.full((6, 6), float("nan"))
    w, _, _, sweeps = fit_normal_jacobi_statement(nan, torch.ones(6))
    assert torch.equal(w, torch.zeros(6)) and sweeps == fit_kernel.MAX_SWEEPS
    assert torch.equal(fit_kernel.fit_normal_plain(nan, torch.ones(6)),
                       torch.zeros(6))


def test_fit_normal_takes_the_plain_version_on_cpu():
    kernels.reset_counts()
    A, b = (t(x) for x in spd_system_np(6, 1e3, seed=1))
    w = pbase.fit_normal(A, b)
    assert torch.equal(w, fit_kernel.fit_normal_plain(A, b))
    assert kernels.plain_calls()["fit_normal"] == 2
    assert kernels.launch_counts()["fit_normal"] == 0


@pytest.mark.parametrize("F", range(2, 70, 2))
def test_fixed_position_schedule_is_the_round_robin(F):
    """The kernel walks the statement's round-robin order by fixed
    positions: in every round the pairs of positions (k, F - 1 - k), each
    oriented p < q, are ``_round_robin(F)``'s pair k; the closed forms of
    what the kernel steps round by round give the same layout; after the
    F - 1 rounds of a sweep the layout is the identity again."""
    rounds, after = fixed_position_schedule(F)
    assert len(rounds) == F - 1
    for r, ((layout, pairs), (p, q)) in enumerate(zip(rounds,
                                                      _round_robin(F))):
        assert pairs == list(zip(p.tolist(), q.tolist())), r
        assert layout == [schedule_index_at(pos, r, F) for pos in range(F)]
        assert [schedule_position_of(i, r, F) for i in range(F)] == \
            [layout.index(i) for i in range(F)]
        assert sorted(layout) == list(range(F))
    assert after == list(range(F))
