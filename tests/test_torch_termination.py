"""Early termination in the planar slice (c1, c2) on the CPU: K1's plain
version on the draws that JAX's terminating rollout made, the c1 update
on that batch against JAX's (``tests/test_parity.py``'s criteria), the
plain versions' agreement with the non-terminating ones in the limit of
no done, the rollout function's done flags, and the entry points training
with ``done_dist > 0``.
``test_torch_termination3d.py`` holds K4's plain version and the c5
update; ``test_torch_cuda.py`` holds the kernels against their plain
versions on the card.

The tolerance of obs, act and rew is the JAX package's own for the fused
planar math against the generic RNEA path (``test_pallas_rollout.py``:
2e-4 on obs and actions, 5e-4 on rewards); measured here over 30 steps
with resets: 2.4e-6 / 4.2e-7 / 1.3e-6 at c1, 1.8e-5 / 2.7e-6 / 1.5e-5 at
c2. The done flags must be identical."""
import math

import numpy as np
import pytest
import torch

from test_torch_helpers import (check_against_jax, check_update_parity,
                                jax_ff_batch, jax_init_params_np,
                                policy_params_np, t)
from trpo_robot_control_tpu.configs import CONFIGS as JCONFIGS
from trpo_robot_control_tpu_torch.configs import CONFIGS as PCONFIGS
from trpo_robot_control_tpu_torch.envs import arm
from trpo_robot_control_tpu_torch.ops.cuda import rollout3d_kernel as r3
from trpo_robot_control_tpu_torch.ops.cuda import rollout_kernel as rk


# c1 is tests/test_termination.py's CFG; c2 at a small width
@pytest.mark.parametrize("name,N,T,done_dist,seed", [
    ("c1_reacher2", 24, 30, 0.25, 0), ("c2_reacher3", 32, 30, 0.15, 2)])
def test_rollout_plain_terminates_as_jax(name, N, T, done_dist, seed):
    check_against_jax(name, N, T, done_dist, seed, 2e-4, 5e-4)


def test_update_parity_on_a_terminating_batch_c1():
    """JAX's terminating c1 batch, collected by the JAX package's initial
    policy as in ``test_torch_update.py``, through both updates: GAE
    breaks the trajectories at the done flags on both sides (7 early
    dones). c1 runs CG on the whole batch (no Fisher subsample), and ten
    fp32 CG iterations leave |beta| sensitive to the summation order at
    this size: over JAX-initialised seeds 0-2 at N = 24 and 64 the
    relative |beta| difference was 4.3e-5 to 3.6e-3, and with
    ``policy_params_np(0)`` 9.6e-3 with the done flags and 3.9e-3
    without them, so the sensitivity is not the flags'. This seed is at
    4.3e-5."""
    jcfg = JCONFIGS["c1_reacher2"].replace(n_envs=24, horizon=30,
                                           done_dist=0.25)
    _, jcfg, pcfg, pn, bj = check_against_jax(
        "c1_reacher2", 24, 30, 0.25, 0, 2e-4, 5e-4,
        params_np=jax_init_params_np(jcfg, 0))
    check_update_parity(jcfg, pcfg, pn, jax_ff_batch(jcfg, bj))


def _random_state(cfg, N, seed):
    gen = torch.Generator().manual_seed(seed)
    s = arm.reset(cfg, gen, N)
    eps = torch.randn(cfg.horizon, N, cfg.arm.n_joints, generator=gen)
    return s, eps, arm.fresh_episodes(cfg, gen, N)


@pytest.mark.parametrize("name", ["c2_reacher3", "c5_multitask"])
def test_no_done_limit_is_the_nonterminating_rollout(name):
    """With done_dist = 1e-9 no env finishes: the terminating plain
    version returns the non-terminating outputs bit for bit, and every
    done row is zero."""
    cfg = PCONFIGS[name].replace(n_envs=32, horizon=12)
    pn = policy_params_np(np.random.RandomState(7), cfg.obs_dim,
                          cfg.arm.n_joints)
    pt = {k: t(v) for k, v in pn.items()}
    s, eps, fresh = _random_state(cfg, 32, 8)
    term = cfg.replace(done_dist=1e-9)
    if name == "c2_reacher3":
        base = rk.rollout_plain(cfg, pt, s.q, s.qd, s.tgt, eps)
        out = rk.rollout_plain(term, pt, s.q, s.qd, s.tgt, eps, fresh)
    else:
        base = r3.rollout3d_plain(cfg, pt, s.q, s.qd, s.tgt, s.task, eps)
        out = r3.rollout3d_plain(term, pt, s.q, s.qd, s.tgt, s.task, eps,
                                 fresh)
    assert len(base) == 3 and len(out) == 4
    for a, b in zip(out[:3], base):
        assert torch.equal(a, b)
    assert not bool(out[3].any())


def test_rollout_fn_returns_dones_with_the_last_step_done():
    cfg = PCONFIGS["c1_reacher2"].replace(n_envs=24, horizon=30,
                                          done_dist=0.25)
    gen = torch.Generator().manual_seed(0)
    params = {k: t(v) for k, v in policy_params_np(
        np.random.RandomState(9), cfg.obs_dim, 2).items()}
    before = rk.rollout_plain.calls
    batch = arm.make_rollout_fn(cfg)(params, gen)
    assert rk.rollout_plain.calls == before + 1
    d = batch["dones_ff"]
    assert d.shape == (30, 24) and d.dtype == torch.float32
    assert bool((d[-1] == 1.0).all()) and bool(d[:-1].any())
    assert set(d.unique().tolist()) <= {0.0, 1.0}
    assert batch["dones"].shape == (24, 30)
    assert torch.equal(batch["dones"], d.T)
    # a done env starts afresh: its next target-minus-end-effector jumps
    obs = batch["obs_ff"]
    early = torch.nonzero(d[:-1] > 0.5)
    jumps = [float(torch.linalg.norm(obs[tt + 1, 6:8, e] - obs[tt, 6:8, e]))
             for tt, e in early.tolist()]
    assert np.median(jumps) > 0.05, jumps
    fixed = arm.make_rollout_fn(cfg.replace(done_dist=0.0))(params, gen)
    assert "dones_ff" not in fixed and "dones" not in fixed


def test_fresh_episodes_follow_the_reset_distributions():
    cfg = PCONFIGS["c5_multitask"].replace(horizon=6)
    gen = torch.Generator().manual_seed(1)
    f = arm.fresh_episodes(cfg, gen, 500)
    spec = cfg.arm
    assert f.q.shape == (6, 500, 7) and f.task.shape == (6, 500)
    assert float(f.q.abs().max()) <= spec.q0_noise
    assert float(f.qd.abs().max()) <= spec.qd0_noise
    r = torch.linalg.norm(f.tgt, dim=-1)
    assert float(r.min()) >= spec.target_rmin_frac * spec.reach - 1e-5
    assert float(r.max()) <= spec.target_rmax_frac * spec.reach + 1e-5
    assert bool((f.tgt[..., 2] >= 0).all())
    assert set(f.task.unique().tolist()) == {0, 1, 2}
    assert not torch.equal(f.q[0], f.q[1])      # a draw per step


def test_task_draw_never_yields_n_tasks():
    """The kernels' uniform (csrc/philox.cuh: 23 random bits times 2^-23
    plus 2^-24) is at most 1 - 2^-24; times n_tasks in fp32 it rounds
    below n_tasks, so K4's fresh task floor(u n_tasks) (csrc/rollout3d.cu)
    stays in [0, n_tasks)."""
    bits = torch.tensor([0, 1, 2 ** 22, 2 ** 23 - 1], dtype=torch.int64)
    u = bits.to(torch.float32) * 2.0 ** -23 + 2.0 ** -24
    assert float(u[-1]) == 1.0 - 2.0 ** -24 and float(u[0]) > 0.0
    for n_tasks in range(1, 65):
        task = torch.floor(u * torch.tensor(float(n_tasks))).long()
        assert int(task.max()) == n_tasks - 1 and int(task.min()) == 0


@pytest.mark.parametrize("name", ["c1_reacher2", "c5_multitask"])
def test_train_step_and_cli_train_with_termination(name, capsys):
    from trpo_robot_control_tpu_torch.cli.train import main
    from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                         make_train_step,
                                                         stats_to_host)
    N, T = (24, 30) if name == "c1_reacher2" else (32, 8)
    cfg = PCONFIGS[name].replace(n_envs=N, horizon=T, done_dist=0.25)
    state = init_state(cfg, seed=0, device="cpu")
    step = make_train_step(cfg)
    for _ in range(2):
        state, stats = step(state)
        host = stats_to_host(stats)
        assert all(math.isfinite(v) for v in host.values()), host
        assert 0 <= host["early_dones"] <= (T - 1) * N
        assert host["early_dones"] == int(host["early_dones"])
    main(["--config", name, "--iters", "2", "--n-envs", str(N), "--horizon",
          str(T), "--done-dist", "0.25", "--device", "cpu", "--seed", "1"])
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("iter")]
    assert len(lines) == 2 and all("early dones" in ln for ln in lines)
