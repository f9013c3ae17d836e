"""The port's CUDA kernels against their plain PyTorch versions, on the
card. They skip without one. Run them there with

  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: the repo's conftest imports JAX, which the GPU machine
need not have; this file imports only numpy, torch and the port)."""
import dataclasses
import re

import numpy as np
import pytest
import torch

from test_torch_helpers import (OBSTACLE_ON_ARM, PG_G_KEPT_REL,
                                PG_MU_FP64_ATOL, FIT_CAP_SPD, FIT_RES_TOL,
                                FIT_SOLVE_TOL, a_norm_rel, env_inputs_np,
                                fit_bound, fit_normal_jacobi_statement,
                                fit_pairs_errors, fp64_floored_solve,
                                gn_fvp_ff_split, gn_fvp_split,
                                gn_fvp_wide_split, pg_fp64_errors,
                                policy_params_np, spd_system_np,
                                state_leaves, surrogate_grad_fp64, t,
                                tasks_np)
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.models import policy
from trpo_robot_control_tpu_torch.ops.fvp import make_gn_fvp
from trpo_robot_control_tpu_torch.ops.cuda import (build, fit_kernel,
                                                   fvp_ff_kernel, fvp_kernel,
                                                   moments_kernel, pg_kernel,
                                                   rollout3d_kernel,
                                                   rollout_kernel)


# K1 against its plain version, per (config, N) and (config, "term"): 0.0
# (torch.equal) wherever the one-thread-per-env kernel before it already
# gave the plain version's bits on an H100. At N = 1 the plain version's
# policy products are matrix-vector products, which round differently from
# the kernel's fmaf chains (3.6e-7 on an H100, both kernels), so that case
# keeps a tolerance.
K1_ATOL = {("c1_reacher2", 256): 0.0, ("c1_reacher2", 33): 0.0,
           ("c1_reacher2", 1): 1e-5, ("c2_reacher3", 256): 0.0,
           ("c2_reacher3", 33): 0.0, ("c2_reacher3", 1): 1e-5,
           ("c1_reacher2", "term"): 0.0, ("c2_reacher3", "term"): 0.0}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3"])
@pytest.mark.parametrize("N", [256, 33, 1])
def test_rollout_kernel_matches_plain_on_card(cuda, name, N):
    """N = 33 and 1 are not multiples of the 8-env block: their last block
    holds one live env, and its seven padded slots store nothing."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=10)
    n = cfg.arm.n_joints
    pn = policy_params_np(np.random.RandomState(6), cfg.obs_dim, n)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=7)]
    k_out = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3])
    p_out = rollout_kernel.rollout_plain(cfg, pc, *ins[:3], ins[3])
    assert k_out[0].shape == (10, cfg.obs_dim, N)
    _exact(k_out, p_out, K1_ATOL[(name, N)])
    seed = torch.tensor([3, 4], dtype=torch.int64, device=cuda)
    a1 = rollout_kernel.rollout(cfg, pc, *ins[:3], seed=seed)
    a2 = rollout_kernel.rollout(cfg, pc, *ins[:3], seed=seed)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


@pytest.mark.cuda
def test_rollout_kernel_has_no_spills_and_fills_the_card(cuda):
    """Every instantiation at 1-3 joints (terminating or not, fp32 or bf16
    stores) compiles with no spill store; those at 2 and 3 keep their
    five-warp block resident, and c2's 1024 envs make a grid of at least
    128 blocks."""
    occ = [rollout_kernel.occupancy(n, term, dt) for n in (2, 3)
           for term in (False, True)
           for dt in (torch.float32, torch.bfloat16)]
    libs = tuple(f"{build.lib_name('rollout', n)}: " for n in (1, 2, 3))
    report = "\n".join(ln for ln in build.ptxas_report().splitlines()
                       if ln.startswith(libs))
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", report)]
    assert len(spills) == 12 and not any(spills), report
    for o in occ:
        assert o["blocks_per_sm"] >= 1 and o["warps_per_sm"] >= 5, o
        assert -(-pconfigs.C2_REACHER3.n_envs // o["envs_per_block"]) >= 128, o


# (T, do, N) in fp32 mode: c1, c2, ragged N (tiles straddling two steps),
# do 1 and the widest, 32
K2_FP32_SHAPES = [(50, 9, 64), (100, 12, 1024), (20, 12, 300),
                  (100, 12, 1000), (20, 1, 300), (20, 32, 1000)]


def _k2_inputs(cuda, T, do, N, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    obs = torch.randn(T, do, N, generator=g, device=cuda)
    y = 5.0 * torch.randn(T, N, generator=g, device=cuda)
    return obs, y, moments_kernel._time_features(T, T, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("T,do,N", K2_FP32_SHAPES)
def test_moments_kernel_matches_plain_on_card(cuda, T, do, N):
    """fp32 mode, one launch: within 1e-5 relative of the Gram summed in
    fp64, exactly symmetric, and bit-identical from call to call."""
    obs, y, tau = _k2_inputs(cuda, T, do, N)
    gk = moments_kernel.extended_gram(obs, y, tau)
    gp = moments_kernel.extended_gram_plain(obs, y, tau)
    assert float((gk - gp).abs().max() / gp.abs().max()) < 1e-5
    assert torch.equal(gk, gk.T)
    for _ in range(3):
        assert torch.equal(gk, moments_kernel.extended_gram(obs, y, tau))


def _device_kernels(fn):
    """{kernel name: launches} of one call of ``fn``, from torch.profiler's
    device trace."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", None)
        if (t if t is not None else getattr(e, "cuda_time_total", 0)) > 0:
            out[e.key] = out.get(e.key, 0) + e.count
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("T,do,N", [(50, 9, 64), (100, 12, 1024)])
def test_moments_kernel_fp32_replays_in_a_cuda_graph_on_card(cuda, T, do,
                                                             N):
    """fp32 mode is one device kernel a call (the profiler's trace of an
    eager call), one wrapper launch under capture, and two replays of the
    captured graph give the eager call's bits: each launch leaves its
    tickets at zero."""
    obs, y, tau = _k2_inputs(cuda, T, do, N, seed=1)
    eager = moments_kernel.extended_gram(obs, y, tau)
    kernels = _device_kernels(lambda: moments_kernel.extended_gram(obs, y,
                                                                  tau))
    assert list(kernels.values()) == [1], kernels
    assert "moments_fp32_kernel" in next(iter(kernels)), kernels
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    n0 = moments_kernel.extended_gram.launches
    with torch.cuda.graph(graph):
        out = moments_kernel.extended_gram(obs, y, tau)
    assert moments_kernel.extended_gram.launches == n0 + 1
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)
    assert torch.equal(moments_kernel.extended_gram(obs, y, tau), eager)


@pytest.mark.cuda
@pytest.mark.parametrize("B, do, da", [
    (3200, 9, 2),           # c1's Fisher batch: 25 tiles of 128
    (25600, 12, 3),         # c2's: 200 tiles, two rounds on some blocks
    (1000, 12, 3),          # a ragged last tile (104 samples)
    (129, 12, 3),           # a last tile of one sample
    (300, 27, 7),           # do > 16, da > 4: the other instantiations
])
def test_fvp_kernel_matches_plain_on_card(cuda, B, do, da):
    """Against the plain version and against the statement of the
    kernel's plane products (``gn_fvp_split``); repeat calls are
    bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(8)
    pn = policy_params_np(np.random.RandomState(8), do, da)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(B, do, generator=g, device=cuda)
    hs = fvp_kernel.activations(pc, obs)
    scale = torch.exp(-2.0 * pc["logstd"]) / obs.shape[0]
    v = torch.randn(sum(x.numel() for x in pc.values()), generator=g,
                    device=cuda)
    ws = fvp_kernel.workspace(pc, obs)
    fk = fvp_kernel.gn_fvp(pc, obs, hs, scale, v, 0.1, ws)
    fp = fvp_kernel.gn_fvp_plain(pc, obs, hs, scale, v, 0.1)
    fs = gn_fvp_split(pc, obs, hs, v, 0.1)
    assert float(torch.linalg.norm(fk - fp) / torch.linalg.norm(fp)) < 1e-5
    assert float(torch.linalg.norm(fk - fs) / torch.linalg.norm(fs)) < 1e-6
    assert torch.equal(fk, fvp_kernel.gn_fvp(pc, obs, hs, scale, v, 0.1, ws))
    assert torch.equal(fk, fvp_kernel.gn_fvp(pc, obs, hs, scale, v, 0.1,
                                             fvp_kernel.workspace(pc, obs)))


@pytest.mark.cuda
def test_fvp_kernel_refuses_misaligned_inputs(cuda):
    """x, h0 and h1 are copied 16 bytes at a time: a contiguous view that
    starts off a 16-byte boundary is refused before the launch."""
    pn = policy_params_np(np.random.RandomState(8), 12, 3)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(257 * 12 + 1, device=cuda)[1:].view(257, 12)
    hs = fvp_kernel.activations(pc, obs)
    scale = torch.exp(-2.0 * pc["logstd"]) / obs.shape[0]
    v = torch.randn(sum(x.numel() for x in pc.values()), device=cuda)
    ws = fvp_kernel.workspace(pc, obs)
    with pytest.raises(ValueError, match="16-byte"):
        fvp_kernel.gn_fvp(pc, obs, hs, scale, v, 0.1, ws)


def _exact(k_out, p_out, atol=0.0):
    """The kernel's outputs equal the plain version's (up to the sign of a
    zero, as torch.equal compares), or lie within atol of them."""
    for a, b in zip(k_out, p_out):
        if atol == 0.0:
            assert torch.equal(a, b), float((a - b).abs().max())
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("N, atol", [(300, 0.0), (33, 0.0), (1, 1e-5)])
def test_rollout3d_kernel_matches_plain_on_card(cuda, N, atol):
    """N = 300 and 33 are not multiples of the 32-env block; N = 1 is a
    block with one live lane. At N = 1 the plain version's policy products
    round differently from the kernel's fmaf chains (1.5e-8 on an H100),
    so that case keeps a tolerance."""
    cfg = pconfigs.C3_FRANKA7.replace(horizon=8)
    pn = policy_params_np(np.random.RandomState(9), cfg.obs_dim, 7)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=10)]
    task = torch.zeros(N, dtype=torch.int32, device=cuda)
    k_out = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3])
    p_out = rollout3d_kernel.rollout3d_plain(cfg, pc, *ins[:3], task, ins[3])
    _exact(k_out, p_out, atol)
    k16 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3],
                                     store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))
    seed = torch.tensor([3, 4], dtype=torch.int64, device=cuda)
    a1 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, seed=seed)
    a2 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, seed=seed)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c4_franka7_obstacle", "c5_multitask"])
def test_rollout3d_kernel_task_terms_match_plain_on_card(cuda, name):
    """c4's obstacle term (its sphere moved onto the arm so that it bites
    within 8 steps) and c5's one-hot, track and push terms."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=8)
    if cfg.cost.obstacle_weight > 0.0:
        cfg = cfg.replace(cost=dataclasses.replace(
            cfg.cost, obstacle_center=OBSTACLE_ON_ARM))
    N = 300
    pn = policy_params_np(np.random.RandomState(13), cfg.obs_dim, 7)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=14)]
    task = torch.tensor(tasks_np(cfg, N, seed=15), device=cuda)
    k_out = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3])
    p_out = rollout3d_kernel.rollout3d_plain(cfg, pc, *ins[:3], task, ins[3])
    assert k_out[0].shape == (8, cfg.obs_dim, N)
    _exact(k_out, p_out)
    k16 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3],
                                     store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))
    seed = torch.tensor([5, 6], dtype=torch.int64, device=cuda)
    a1 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, seed=seed)
    a2 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, seed=seed)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c3_franka7", "c4_franka7_obstacle",
                                  "c5_multitask"])
def test_rollout3d_kernel_keeps_two_blocks_per_sm(cuda, name):
    """Every instantiation c3-c5 reach, terminating or not, fp32 or bf16
    stores: at least two 8-warp blocks resident on an SM."""
    cfg = pconfigs.CONFIGS[name]
    for done_dist in (0.0, 0.05):
        for dtype in (torch.float32, torch.bfloat16):
            occ = rollout3d_kernel.occupancy(
                cfg.replace(done_dist=done_dist), dtype)
            assert occ["blocks_per_sm"] >= 2 and occ["warps_per_sm"] >= 16, \
                occ


@pytest.mark.cuda
def test_rollout3d_kernel_refuses_a_pair_it_has_no_instantiation_for(cuda):
    """Nine joints (past the update kernels' 32 observation features,
    ROADMAP B3) and four task families: the kernel has no such
    instantiation, and the wrapper says so before it launches."""
    cfg = pconfigs.C5_MULTITASK.replace(arm=pconfigs.planar_arm(9),
                                        horizon=2)
    pn = policy_params_np(np.random.RandomState(16), cfg.obs_dim, 9)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, 32, seed=17)]
    task = torch.tensor(tasks_np(cfg, 32, seed=18), device=cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP B3"):
        rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3])
    with pytest.raises(NotImplementedError, match="task families"):
        rollout3d_kernel.occupancy(pconfigs.C5_MULTITASK.replace(n_tasks=4))


# K4 at 3 joints, each (task families, obstacle) pair on a planar arm (the
# obstacle sphere on its second joint origin, active from the first step)
PAIRS = [(n_tasks, obstacle) for n_tasks in (1, 2, 3)
         for obstacle in (False, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_tasks,obstacle", PAIRS)
def test_rollout3d_kernel_at_three_joints_matches_plain_on_card(
        cuda, n_tasks, obstacle):
    """c5-planar3's arm with each pair: eps mode 0.0 from the plain version
    with fp32 stores and the rounded fp32 output with bf16 stores; the
    terminating instantiation in fresh-state mode with the same done flags
    and trajectories."""
    cost = pconfigs.CostSpec(ctrl_weight=0.01,
                             obstacle_weight=1.0 if obstacle else 0.0,
                             obstacle_center=(0.5, 0.0, 0.0))
    cfg = pconfigs.C5_MULTITASK.replace(arm=pconfigs.planar_arm(3),
                                        cost=cost, n_tasks=n_tasks,
                                        horizon=16)
    N = 300
    pn = policy_params_np(np.random.RandomState(25), cfg.obs_dim, 3)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    s, eps, _ = _term_inputs(cfg, N, 26, cuda)
    k_out = rollout3d_kernel.rollout3d(cfg, pc, s.q, s.qd, s.tgt, s.task,
                                       eps=eps)
    _exact(k_out, rollout3d_kernel.rollout3d_plain(cfg, pc, s.q, s.qd, s.tgt,
                                                   s.task, eps))
    k16 = rollout3d_kernel.rollout3d(cfg, pc, s.q, s.qd, s.tgt, s.task,
                                     eps=eps, store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))
    term = cfg.replace(done_dist=0.4)
    s, eps, fresh = _term_inputs(term, N, 27, cuda)
    k_out = rollout3d_kernel.rollout3d(term, pc, s.q, s.qd, s.tgt, s.task,
                                       eps=eps, fresh=fresh)
    p_out = rollout3d_kernel.rollout3d_plain(term, pc, s.q, s.qd, s.tgt,
                                             s.task, eps, fresh)
    assert torch.equal(k_out[3], p_out[3]) and bool(k_out[3][:-1].any())
    _exact(k_out[:3], p_out[:3])


@pytest.mark.cuda
@pytest.mark.parametrize("links", [4, 8])
def test_rollout_kernel_more_links_and_bf16_match_plain_on_card(cuda, links):
    """K1 at 4 and 8 links (two action chains per state-warp part at 8):
    0.0 from the plain version with fp32 stores, and bf16 stores the fp32
    output rounded once, rewards unchanged."""
    cfg = pconfigs.C2_REACHER3.replace(arm=pconfigs.planar_arm(links),
                                       horizon=10)
    N = 256
    pn = policy_params_np(np.random.RandomState(28), cfg.obs_dim, links)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=29)]
    k_out = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3])
    _exact(k_out, rollout_kernel.rollout_plain(cfg, pc, *ins[:3], ins[3]))
    k16 = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3],
                                 store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert a.dtype == torch.bfloat16 and torch.equal(
            a, b.to(torch.bfloat16))
    assert torch.equal(k16[2], k_out[2])


# (T, do, N): c3/c4's do 24 and c5's 27 (7 column blocks), 30 (8) and
# the widest, 32 (9, 80 staged rows); N = 300 and 4096 + 37 are not
# multiples of 8 (plain loads), 4096 + 40 is (cp.async with the envs past
# N zero-filled); none is a multiple of the 256-env tile.
@pytest.mark.cuda
@pytest.mark.parametrize("T,do,N", [
    (20, 24, 300), (6, 27, 4096 + 37), (6, 27, 4096 + 40),
    (6, 30, 4096 + 40), (6, 32, 4096 + 37), (6, 32, 4096 + 40)])
def test_moments_kernel_bf16_matches_plain_on_card(cuda, T, do, N):
    g = torch.Generator(device=cuda).manual_seed(1)
    obs = torch.randn(T, do, N, generator=g, device=cuda).to(torch.bfloat16)
    y = 5.0 * torch.randn(T, N, generator=g, device=cuda)
    tau = moments_kernel._time_features(T, T, cuda)
    gk = moments_kernel.extended_gram(obs, y, tau)
    gp = moments_kernel.extended_gram_plain(obs, y, tau)
    assert float((gk - gp).abs().max() / gp.abs().max()) < 1e-5
    assert torch.equal(gk, moments_kernel.extended_gram(obs, y, tau))


# (dtype, T, do, N): the fp32 mode; the bf16 mode (tensor cores, 64-env
# tiles) at c3's do 24 and c5's 27, N = 200 with a ragged last tile, and
# 16 x 65 tiles on 264 blocks, so every block sums several tiles (N =
# 4096 + 40 staged by cp.async, 4096 + 37 by plain loads). In bf16 mode h0,
# h1, g1 and g0 are rounded to bf16; where a value before its rounding lies
# within fp32 roundings of a bf16 boundary, two fp32 summation orders (the
# kernel's, the plain version's) may round it to neighbouring bf16 values,
# and one h1 moves mu by |W2| 2^-8 (up to 6e-4 with this output layer).
# So mu is held to the fp64 evaluation within the slack of its ambiguous
# roundings, and g to it on the samples with none; mu against the plain
# version keeps its 1e-4 where no rounding is ambiguous. The plain
# version must meet the same fp64 checks.
@pytest.mark.cuda
@pytest.mark.parametrize("dtype,T,do,N", [
    (torch.float32, 6, 24, 200), (torch.bfloat16, 6, 24, 200),
    (torch.bfloat16, 6, 27, 200), (torch.bfloat16, 16, 27, 4096 + 40),
    (torch.bfloat16, 16, 24, 4096 + 37)])
def test_pg_kernel_matches_plain_on_card(cuda, dtype, T, do, N):
    _check_pg(cuda, dtype, T, do, N, (64, 64))


def _check_pg(cuda, dtype, T, do, N, hidden):
    g = torch.Generator(device=cuda).manual_seed(2)
    da = 7
    pn = policy_params_np(np.random.RandomState(11), do, da, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(T, do, N, generator=g, device=cuda).to(dtype)
    act = (0.5 * torch.randn(T, da, N, generator=g, device=cuda)).to(dtype)
    adv = torch.randn(T, N, generator=g, device=cuda)
    gk, muk, lpk = pg_kernel.surrogate_grad(pc, obs, act, adv)
    gp, mup, lpp = pg_kernel.surrogate_grad_plain(pc, obs, act, adv)
    if dtype == torch.bfloat16:
        ref = surrogate_grad_fp64(pc, obs, act, adv)
        adv_kept = adv * ref["kept"]
        for fn, mu in ((pg_kernel.surrogate_grad, muk),
                       (pg_kernel.surrogate_grad_plain, mup)):
            mu_over, g_rel = pg_fp64_errors(ref, mu,
                                            fn(pc, obs, act, adv_kept)[0])
            assert mu_over <= PG_MU_FP64_ATOL and g_rel <= PG_G_KEPT_REL, (
                f"{fn.__name__} against the fp64 evaluation: mu beyond its "
                f"slack {mu_over:.3e}, g on the kept samples {g_rel:.3e}")
        assert float(ref["kept"].double().mean()) > 0.3
    fk, fp = policy.flatten(gk), policy.flatten(gp)
    assert float(torch.linalg.norm(fk - fp) / torch.linalg.norm(fp)) < 1e-4
    if dtype == torch.float32:
        assert float((muk - mup).abs().max()) < 1e-4
    else:
        exact = ref["mu_slack"] == 0
        assert float((muk - mup).abs()[exact].max()) < 1e-4
    again = pg_kernel.surrogate_grad(pc, obs, act, adv)
    assert torch.equal(fk, policy.flatten(again[0]))
    assert torch.equal(muk, again[1]) and torch.equal(lpk, again[2])


@pytest.mark.cuda
@pytest.mark.parametrize("do,e,dtype,T,N", [
    (24, 1, torch.bfloat16, 16, 304),
    (24, 4, torch.bfloat16, 16, 304),
    (27, 8, torch.bfloat16, 16, 304),
    (24, 1, torch.float32, 16, 304),        # fp32 storage: x split too
    (27, 4, torch.bfloat16, 16, 129),       # a last tile of one sample
    (24, 8, torch.bfloat16, 8, 200),        # T' = 1
    (27, 8, torch.bfloat16, 80, 4096),      # several tiles per block
])
def test_fvp_ff_kernel_matches_plain_on_card(cuda, do, e, dtype, T, N):
    """On the time-strided subsample (c3) and on the time- and env-strided
    one (c4, c5), against the plain version and against the statement of
    the kernel's plane products (``gn_fvp_ff_split``)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    pn = policy_params_np(np.random.RandomState(12), do, 7)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(T, do, N * e, generator=g, device=cuda).to(dtype)
    sub = obs[::8, :, ::e]
    v = torch.randn(sum(x.numel() for x in pc.values()), generator=g,
                    device=cuda)
    fk = fvp_ff_kernel.make_gn_fvp_ff(pc, sub, 0.1)(v)
    fp = fvp_ff_kernel.gn_fvp_ff_plain(pc, sub, v, 0.1)
    fs = gn_fvp_ff_split(pc, sub, v, 0.1)
    assert float(torch.linalg.norm(fk - fp) / torch.linalg.norm(fp)) < 1e-5
    assert float(torch.linalg.norm(fk - fs) / torch.linalg.norm(fs)) < 1e-6
    assert torch.equal(fk, fvp_ff_kernel.make_gn_fvp_ff(pc, sub, 0.1)(v))


# ROADMAP B3's policy shapes on the 7-DoF path: the JAX package's own test
# shapes, OpenAI Baselines' (32, 32) and a 3-layer one
SHAPES = [(32,), (32, 32), (48, 40), (33, 57), (64,), (64, 64, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", SHAPES)
@pytest.mark.parametrize("name", ["c3_franka7", "c5_multitask"])
def test_rollout3d_kernel_policy_shapes_match_plain_on_card(cuda, name,
                                                            hidden):
    """K4 at every policy shape, c3's and c5's observation: 0.0 from the
    plain version, bf16 stores its rounding."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=8)
    N = 300
    pn = policy_params_np(np.random.RandomState(21), cfg.obs_dim, 7, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=22)]
    task = torch.tensor(tasks_np(cfg, N, seed=23), device=cuda)
    k_out = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3])
    p_out = rollout3d_kernel.rollout3d_plain(cfg, pc, *ins[:3], task, ins[3])
    _exact(k_out, p_out)
    k16 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3],
                                     store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pg_kernel_policy_shapes_on_card(cuda, dtype, hidden):
    """K5 at every policy shape, both modes: a ragged last tile and
    several tiles per block."""
    _check_pg(cuda, dtype, 16, 27, 4096 + 40, hidden)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden,dtype", [
    (hidden, torch.bfloat16) for hidden in SHAPES] + [
    ((33, 57), torch.float32),
    ((64, 64, 64), torch.float32)])     # tiles of 32, x single-buffered
@pytest.mark.parametrize("e", [1, 8])
def test_fvp_ff_kernel_policy_shapes_match_plain_on_card(cuda, e, hidden,
                                                         dtype):
    """K6 at every policy shape on c3's (e = 1) and c5's (e = 8) kind of
    subsample, against the plain version; fp32 storage at two shapes."""
    g = torch.Generator(device=cuda).manual_seed(4)
    pn = policy_params_np(np.random.RandomState(24), 27, 7, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(80, 27, 1000 * e, generator=g, device=cuda).to(dtype)
    sub = obs[::8, :, ::e]
    v = torch.randn(sum(x.numel() for x in pc.values()), generator=g,
                    device=cuda)
    fk = fvp_ff_kernel.make_gn_fvp_ff(pc, sub, 0.1)(v)
    fp = fvp_ff_kernel.gn_fvp_ff_plain(pc, sub, v, 0.1)
    assert float(torch.linalg.norm(fk - fp) / torch.linalg.norm(fp)) < 1e-6
    assert torch.equal(fk, fvp_ff_kernel.make_gn_fvp_ff(pc, sub, 0.1)(v))


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", [(32, 32, 32, 32), (65,), (64, 65)])
def test_policy_kernels_refuse_shapes_past_b3(cuda, hidden):
    """Four hidden layers or a layer past a kernel's cap raise, naming
    ROADMAP B3, before anything is built or launched: K5 and K6 on the
    7-DoF path at 65 units (their packed widths), K4 on it and K1 and K3
    on the planar one at 129 (the same shape with each 65 made 129: their
    unpacked forms take up to 128)."""
    wide = tuple(129 if w == 65 else w for w in hidden)
    cfg = pconfigs.C3_FRANKA7.replace(horizon=2)
    pn = policy_params_np(np.random.RandomState(25), cfg.obs_dim, 7, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    pnw = policy_params_np(np.random.RandomState(25), cfg.obs_dim, 7, wide)
    pcw = {k: t(v).to(cuda) for k, v in pnw.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, 32, seed=26)]
    task = torch.zeros(32, dtype=torch.int32, device=cuda)
    obs = torch.randn(2, cfg.obs_dim, 64, device=cuda).to(torch.bfloat16)
    act = torch.randn(2, 7, 64, device=cuda).to(torch.bfloat16)
    adv = torch.randn(2, 64, device=cuda)
    c2 = pconfigs.C2_REACHER3.replace(horizon=2)
    pn2 = policy_params_np(np.random.RandomState(27), c2.obs_dim, 3, wide)
    pc2 = {k: t(v).to(cuda) for k, v in pn2.items()}
    ins2 = [t(x).to(cuda) for x in env_inputs_np(c2, 32, seed=28)]
    obs2 = torch.randn(256, c2.obs_dim, device=cuda)
    before = (rollout3d_kernel.rollout3d.launches,
              pg_kernel.surrogate_grad.launches,
              fvp_ff_kernel.gn_fvp_ff.launches,
              rollout_kernel.rollout.launches, fvp_kernel.gn_fvp.launches,
              set(build.LIBS))
    calls = [
        lambda: rollout3d_kernel.rollout3d(cfg, pcw, *ins[:3], task,
                                           eps=ins[3]),
        lambda: pg_kernel.surrogate_grad(pc, obs, act, adv),
        lambda: fvp_ff_kernel.make_gn_fvp_ff(pc, obs, 0.1),
        lambda: rollout_kernel.rollout(c2, pc2, *ins2[:3], eps=ins2[3]),
        lambda: make_gn_fvp(pc2, obs2, 0.1)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="ROADMAP B3"):
            call()
    assert before == (rollout3d_kernel.rollout3d.launches,
                      pg_kernel.surrogate_grad.launches,
                      fvp_ff_kernel.gn_fvp_ff.launches,
                      rollout_kernel.rollout.launches,
                      fvp_kernel.gn_fvp.launches, set(build.LIBS))


# ROADMAP B3's unpacked policy forms (K1, K4, K3 at 65-128 units): one unit
# past the packed limit, JAX's own unpacked test shape, rllab's policy and
# the top of the range
WIDE_SHAPES = [(65,), (96, 96), (100, 50, 25), (128, 128, 128)]
# The planar path's policy shapes (K1, K3): SHAPES and two one-unit
# layers, which the plain version multiplies as two rows
PLANAR_SHAPES = SHAPES + [(1, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", PLANAR_SHAPES)
@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3"])
def test_rollout_kernel_policy_shapes_match_plain_on_card(cuda, name,
                                                          hidden):
    """K1 at every policy shape, at c1's and c2's arm: 0.0 from the plain
    version (N = 300 is not a multiple of the 8-env block), bf16 stores
    its fp32 output rounded once, and TERM in fresh-state mode 0.0 with
    the same done flags."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=10)
    n, N = cfg.arm.n_joints, 300
    pn = policy_params_np(np.random.RandomState(30), cfg.obs_dim, n, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=31)]
    k_out = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3])
    _exact(k_out, rollout_kernel.rollout_plain(cfg, pc, *ins[:3], ins[3]))
    k16 = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3],
                                 store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))
    assert torch.equal(k16[2], k_out[2])
    cfg_t = cfg.replace(horizon=30, done_dist=0.25)
    s, eps, fresh = _term_inputs(cfg_t, N, 32, cuda)
    kt = rollout_kernel.rollout(cfg_t, pc, s.q, s.qd, s.tgt, eps=eps,
                                fresh=fresh)
    pt = rollout_kernel.rollout_plain(cfg_t, pc, s.q, s.qd, s.tgt, eps,
                                      fresh)
    assert float(kt[3].sum()) > 0
    _exact(kt, pt)


@pytest.mark.cuda
def test_rollout_kernel_deep_policy_has_no_spills(cuda):
    """K1 at (64, 64, 64), the third layer's weights in shared memory, at
    8 links (the widest observation and the largest state) compiles with
    no spill store in any of its four instantiations and stays resident."""
    hidden = (64, 64, 64)
    occ = [rollout_kernel.occupancy(8, term, dt, hidden)
           for term in (False, True) for dt in (torch.float32, torch.bfloat16)]
    lib = f"{build.lib_name('rollout', 8, hidden)}: "
    report = "\n".join(ln for ln in build.ptxas_report().splitlines()
                       if ln.startswith(lib))
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", report)]
    assert len(spills) == 4 and not any(spills), report
    assert all(o["blocks_per_sm"] >= 1 for o in occ), occ


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", PLANAR_SHAPES + WIDE_SHAPES)
@pytest.mark.parametrize("B, do, da", [
    (3200, 9, 2),           # c1's Fisher batch
    (1000, 12, 3),          # c2's widths, a ragged last tile
    (300, 27, 7),           # do > 16, da > 4: the other instantiations
])
def test_fvp_kernel_policy_shapes_match_plain_on_card(cuda, B, do, da,
                                                      hidden):
    """K3 at every policy shape: within 1e-6 relative L2 of the plain
    version, repeat calls bit-identical."""
    g = torch.Generator(device=cuda).manual_seed(33)
    pn = policy_params_np(np.random.RandomState(34), do, da, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(B, do, generator=g, device=cuda)
    hs = fvp_kernel.activations(pc, obs)
    scale = torch.exp(-2.0 * pc["logstd"]) / B
    v = torch.randn(sum(x.numel() for x in pc.values()), generator=g,
                    device=cuda)
    fvp = make_gn_fvp(pc, obs, 0.1)
    fk = fvp(v)
    fp = fvp_kernel.gn_fvp_plain(pc, obs, hs, scale, v, 0.1)
    assert float(torch.linalg.norm(fk - fp) / torch.linalg.norm(fp)) < 1e-6
    assert torch.equal(fk, fvp(v))


def _term_inputs(cfg, N, seed, cuda):
    """Initial states, eps and fresh episodes of a terminating config,
    drawn on the card from the reset distributions."""
    from trpo_robot_control_tpu_torch.envs import arm
    gen = torch.Generator(device=cuda).manual_seed(seed)
    s = arm.reset(cfg, gen, N)
    eps = torch.randn(cfg.horizon, N, cfg.arm.n_joints, generator=gen,
                      device=cuda)
    return s, eps, arm.fresh_episodes(cfg, gen, N)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3"])
def test_rollout_kernel_terminating_matches_plain_on_card(cuda, name):
    """K1's TERM instantiation in fresh-state mode: the same done flags as
    the plain version, and the same trajectories through the resets."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=30, done_dist=0.25)
    N = 300
    pn = policy_params_np(np.random.RandomState(19), cfg.obs_dim,
                          cfg.arm.n_joints)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    s, eps, fresh = _term_inputs(cfg, N, 20, cuda)
    k_out = rollout_kernel.rollout(cfg, pc, s.q, s.qd, s.tgt, eps=eps,
                                   fresh=fresh)
    p_out = rollout_kernel.rollout_plain(cfg, pc, s.q, s.qd, s.tgt, eps,
                                         fresh)
    assert torch.equal(k_out[3], p_out[3]) and bool(k_out[3][:-1].any())
    _exact(k_out[:3], p_out[:3], K1_ATOL[(name, "term")])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c3_franka7", "c4_franka7_obstacle",
                                  "c5_multitask"])
def test_rollout3d_kernel_terminating_matches_plain_on_card(cuda, name):
    """K4's TERM instantiation of each (task families, obstacle) pair in
    fresh-state mode, fp32 and bf16 stores: the same done flags as the
    plain version and the same trajectories through the resets (a reset
    redraws c5's task)."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=16, done_dist=0.4)
    if cfg.cost.obstacle_weight > 0.0:
        cfg = cfg.replace(cost=dataclasses.replace(
            cfg.cost, obstacle_center=OBSTACLE_ON_ARM))
    N = 300
    pn = policy_params_np(np.random.RandomState(21), cfg.obs_dim, 7)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    s, eps, fresh = _term_inputs(cfg, N, 22, cuda)
    k_out = rollout3d_kernel.rollout3d(cfg, pc, s.q, s.qd, s.tgt, s.task,
                                       eps=eps, fresh=fresh)
    p_out = rollout3d_kernel.rollout3d_plain(cfg, pc, s.q, s.qd, s.tgt,
                                             s.task, eps, fresh)
    assert torch.equal(k_out[3], p_out[3]) and bool(k_out[3][:-1].any())
    _exact(k_out[:3], p_out[:3])
    k16 = rollout3d_kernel.rollout3d(cfg, pc, s.q, s.qd, s.tgt, s.task,
                                     eps=eps, fresh=fresh,
                                     store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))
    assert torch.equal(k16[3], k_out[3])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c2_reacher3", "c3_franka7",
                                  "c4_franka7_obstacle", "c5_multitask"])
def test_terminating_kernel_without_a_done_is_the_nonterminating_one(
        cuda, name):
    """With done_dist = 1e-9 no env finishes: in Philox mode the TERM
    instantiation gives the non-terminating one's batch bit for bit from
    the same seed (the resets' uniforms use their own Philox counters)."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=12)
    n = cfg.arm.n_joints
    N = 300
    pn = policy_params_np(np.random.RandomState(23), cfg.obs_dim, n)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    s, _, _ = _term_inputs(cfg, N, 24, cuda)
    seed = torch.tensor([11, 12], dtype=torch.int64, device=cuda)
    term = cfg.replace(done_dist=1e-9)
    if n < 7:
        base = rollout_kernel.rollout(cfg, pc, s.q, s.qd, s.tgt, seed=seed)
        out = rollout_kernel.rollout(term, pc, s.q, s.qd, s.tgt, seed=seed)
    else:
        base = rollout3d_kernel.rollout3d(cfg, pc, s.q, s.qd, s.tgt, s.task,
                                          seed=seed)
        out = rollout3d_kernel.rollout3d(term, pc, s.q, s.qd, s.tgt, s.task,
                                         seed=seed)
    assert len(base) == 3 and len(out) == 4
    for a, b in zip(out[:3], base):
        assert torch.equal(a, b)
    assert not bool(out[3].any())


def _exact_or_fmaf(pc, k_out, p_out, eps, atol=1e-5):
    """A rollout kernel's wide form against its plain version on eps (T, N,
    n): 0.0, or, where the plain version's matrix product sums in another
    order (cuBLAS picks its kernel by shape), step 0's actions in the
    kernel's fmaf order (``mean_fmaf``) and the rest within ``atol``:
    chip_smoke.py's bounds, 1e-5 over 8-10 steps (K1_TIGHT_ATOL,
    K4_TIGHT_ATOL) and 1e-2 over longer horizons (K1_FULL_ATOL), where
    the two orders' roundings compound through the dynamics."""
    from test_torch_helpers import mean_fmaf
    errs = [float((k - p).abs().max()) for k, p in zip(k_out, p_out)]
    if max(errs) == 0.0:
        return
    L = sum(1 for k in pc if k.startswith("W"))
    act0 = (mean_fmaf(pc, k_out[0][0]) + pc[f"b{L - 1}"][:, None]) \
        + torch.exp(pc["logstd"])[:, None] * eps[0].T
    assert torch.equal(k_out[1][0], act0)
    assert max(errs) <= atol, errs


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDE_SHAPES)
@pytest.mark.parametrize("name", ["c1_reacher2", "c2_reacher3"])
def test_rollout_kernel_wide_shapes_match_plain_on_card(cuda, name, hidden):
    """K1's wide form at c1's and c2's arm (N = 300): the plain version's
    output or, where that sums in another order, the fmaf order's at step
    0 (``_exact_or_fmaf``), bf16 stores its fp32 output rounded once, and
    TERM in fresh-state mode over 30 steps with the same done flags, held
    the same way within the full-horizon bound."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=10)
    n, N = cfg.arm.n_joints, 300
    pn = policy_params_np(np.random.RandomState(30), cfg.obs_dim, n, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=31)]
    k_out = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3])
    _exact_or_fmaf(pc, k_out, rollout_kernel.rollout_plain(
        cfg, pc, *ins[:3], ins[3]), ins[3])
    k16 = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3],
                                 store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))
    assert torch.equal(k16[2], k_out[2])
    cfg_t = cfg.replace(horizon=30, done_dist=0.25)
    s, eps, fresh = _term_inputs(cfg_t, N, 32, cuda)
    kt = rollout_kernel.rollout(cfg_t, pc, s.q, s.qd, s.tgt, eps=eps,
                                fresh=fresh)
    pt = rollout_kernel.rollout_plain(cfg_t, pc, s.q, s.qd, s.tgt, eps,
                                      fresh)
    assert float(kt[3].sum()) > 0 and torch.equal(kt[3], pt[3])
    _exact_or_fmaf(pc, kt[:3], pt[:3], eps, atol=1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDE_SHAPES)
@pytest.mark.parametrize("name", ["c3_franka7", "c5_multitask"])
def test_rollout3d_kernel_wide_shapes_match_plain_on_card(cuda, name,
                                                          hidden):
    """K4's wide form at c3's and c5's observation: the plain version's
    output or, where that sums in another order, the fmaf order's at step
    0 (``_exact_or_fmaf``); bf16 stores its fp32 output rounded."""
    cfg = pconfigs.CONFIGS[name].replace(horizon=8)
    N = 300
    pn = policy_params_np(np.random.RandomState(35), cfg.obs_dim, 7, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=36)]
    task = torch.tensor(tasks_np(cfg, N, seed=37), device=cuda)
    k_out = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3])
    p_out = rollout3d_kernel.rollout3d_plain(cfg, pc, *ins[:3], task, ins[3])
    _exact_or_fmaf(pc, k_out, p_out, ins[3])
    k16 = rollout3d_kernel.rollout3d(cfg, pc, *ins[:3], task, eps=ins[3],
                                     store_dtype=torch.bfloat16)
    for a, b in zip(k16[:2], k_out[:2]):
        assert torch.equal(a, b.to(torch.bfloat16))


@pytest.mark.cuda
def test_wide_rollouts_have_no_spills(cuda):
    """At the top of the range, (128, 128, 128), with the widest
    observation and the largest state (8 links / joints): K1's four
    instantiations and K4's 24 compile with no spill store and stay
    resident."""
    hidden = (128, 128, 128)
    occ = [rollout_kernel.occupancy(8, term, dt, hidden)
           for term in (False, True) for dt in (torch.float32, torch.bfloat16)]
    cfg = pconfigs.C5_MULTITASK.replace(arm=pconfigs.planar_arm(8))
    occ.append(rollout3d_kernel.occupancy(cfg, torch.bfloat16, hidden))
    for src, count in (("rollout", 4), ("rollout3d", 24)):
        lib = f"{build.lib_name(src, 8, hidden)}: "
        report = "\n".join(ln for ln in build.ptxas_report().splitlines()
                           if ln.startswith(lib))
        spills = [int(x)
                  for x in re.findall(r"(\d+) bytes spill stores", report)]
        assert len(spills) == count and not any(spills), report
    assert all(o["blocks_per_sm"] >= 1 for o in occ), occ


@pytest.mark.cuda
@pytest.mark.parametrize("hidden", WIDE_SHAPES)
@pytest.mark.parametrize("B, do, da", [
    (3200, 9, 2),           # c1's Fisher batch
    (1000, 12, 3),          # c2's widths, a ragged last split and chunk
    (300, 27, 7),           # do > 16, da > 4: the other instantiations
])
def test_fvp_wide_form_matches_its_statement_on_card(cuda, B, do, da,
                                                     hidden):
    """K3's wide form (split-bf16 products on the tensor cores, a chain of
    launches) within 1e-6 relative L2 of the statement of its arithmetic
    (``gn_fvp_wide_split``); repeat calls and a fresh workspace
    bit-identical; its tile is a split of the grad launch."""
    g = torch.Generator(device=cuda).manual_seed(43)
    pn = policy_params_np(np.random.RandomState(44), do, da, hidden)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(B, do, generator=g, device=cuda)
    hs = fvp_kernel.activations(pc, obs)
    v = torch.randn(sum(x.numel() for x in pc.values()), generator=g,
                    device=cuda)
    fk = make_gn_fvp(pc, obs, 0.1)(v)
    fs = gn_fvp_wide_split(pc, obs, hs, v, 0.1)
    assert float(torch.linalg.norm(fk - fs) / torch.linalg.norm(fs)) < 1e-6
    assert torch.equal(fk, make_gn_fvp(pc, obs, 0.1)(v))
    assert fvp_kernel.tile(do, da, hidden) == fvp_kernel.WIDE_SPLIT


@pytest.mark.cuda
def test_fvp_wide_form_has_no_spills(cuda):
    """At the top of the range, (128, 128, 128), with the widest
    observation and head (do 32, da 8), every launch of K3's wide form is
    resident with no local memory, and its library has no spill store."""
    hidden = (128, 128, 128)
    occ = fvp_kernel.occupancy(32, 8, hidden)
    assert all(o["blocks_per_sm"] >= 1 and o["local_bytes"] == 0
               for o in occ["kernels"].values()), occ
    lib = f"{build.lib_name('fvp', None, hidden)}: "
    report = "\n".join(ln for ln in build.ptxas_report().splitlines()
                       if ln.startswith(lib))
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", report)]
    assert spills and not any(spills), report


@pytest.mark.cuda
@pytest.mark.parametrize("name,value", [
    ("fvp_impl", "xla"), ("fvp_impl", "pallas_ff"), ("moments_impl", "xla"),
    ("moments_impl", "triton"), ("rollout_impl", "xla"),
    ("rollout_impl", "scan")])
def test_unhonoured_switch_values_raise_on_card(cuda, name, value):
    """A switch value the port has no counterpart for (the JAX package's
    "xla" forms, or a value it does not have) raises NotImplementedError
    on the card, naming the switch and its value, before anything runs."""
    from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    base = pconfigs.C1_REACHER2.replace(n_envs=64, horizon=10)
    cfg = base.replace(rollout_impl=value) if name == "rollout_impl" else \
        base.replace(trpo=dataclasses.replace(base.trpo, **{name: value}))
    st = init_state(base, device="cuda")
    with pytest.raises(NotImplementedError, match=f"{name}='{value}'"):
        if name == "rollout_impl":
            make_rollout_fn(cfg)(st.params, st.gen)
        else:
            batch = make_rollout_fn(base)(st.params, st.gen)
            trpo_update(cfg, st.params, st.w, batch)


@pytest.mark.cuda
def test_c2_mlp_trains_on_card_through_k1_and_k3(cuda):
    """c2 with the MLP value baseline at full width: the batch-major branch,
    K1 once and K3 ten times an update on the n-major Fisher subsample, no
    K2, K5 or K6, no plain version, every accepted step inside the trust
    region, the stats finite."""
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import train
    cfg = pconfigs.C2_REACHER3.replace(trpo=dataclasses.replace(
        pconfigs.C2_REACHER3.trpo, baseline="mlp"))
    n_iters = 3
    kernels.reset_counts()
    state, hist = train(cfg, n_iters=n_iters, seed=0)
    assert kernels.launch_counts() == {
        "rollout": n_iters, "moments": 0, "fvp": n_iters * cfg.trpo.cg_iters,
        "rollout3d": 0, "pg": 0, "fvp_ff": 0, "fit_normal": 0}
    assert all(c == 0 for c in kernels.plain_calls().values())
    for st in hist:
        assert all(np.isfinite(v) for v in st.values()), st
        assert st["accepted"] < 0 or st["kl"] <= cfg.trpo.delta, st
    assert set(state.w) == {"W0", "b0", "W1", "b1"}


# do -1 gives F = 2 (spd_system_np's F = 2 do + 4), the smallest system;
# 9, 12, 24, 27 are c1's, c2's, c3/c4's and c5's F 22, 28, 52, 58, 32 the
# widest, F 68
@pytest.mark.cuda
@pytest.mark.parametrize("cond", [1e2, 1e6])
@pytest.mark.parametrize("do", [-1, 6, 9, 12, 24, 27, 32])
def test_fit_normal_kernel_matches_statement_on_card(cuda, do, cond):
    """The kernel against the statement of its arithmetic run on the same
    card, bit for bit (the same separately rounded operations in the same
    order): w and the sweep count, at the split the launcher takes for
    this F; bit-identical repeat calls; the
    statement's eigenpairs on the card a decomposition of A_s and w their
    solve (the CPU test's bounds); and the kernel and the eigh solve (the
    plain version) against the fp64-floored solve and against each other
    (prediction space) within ``fit_bound`` (the CPU test's bound, which
    w = 0 fails)."""
    A, b = (t(x).to(cuda) for x in spd_system_np(do, cond, seed=abs(do)))
    w, sweeps = fit_kernel.jacobi_solve(A, b)
    w_s, lam_s, Q_s, sweeps_s = fit_normal_jacobi_statement(A, b)
    assert int(sweeps) == sweeps_s < fit_kernel.MAX_SWEEPS
    assert torch.equal(w, w_s)
    for _ in range(3):
        assert torch.equal(fit_kernel.fit_normal(A, b), w)
    res, solve = fit_pairs_errors(A, b, w, lam_s, Q_s)
    assert res <= FIT_RES_TOL and solve <= FIT_SOLVE_TOL, (res, solve)
    w64, kept_cond = fp64_floored_solve(A, b)
    bound = fit_bound(kept_cond, FIT_CAP_SPD)
    w_p = fit_kernel.fit_normal_plain(A, b)
    assert a_norm_rel(A, w, w64) <= bound
    assert a_norm_rel(A, w_p, w64) <= bound
    assert a_norm_rel(A, w, w_p) <= bound


@pytest.mark.cuda
def test_eigh_refuses_a_graph_capture_on_card(cuda):
    """Why the card solves with the fit_normal kernel: ``torch.linalg.eigh``
    reads its info flag on the host, which invalidates a CUDA graph capture
    (run in a child process, which the failed capture leaves behind)."""
    import subprocess
    import sys
    code = ("import torch\n"
            "A = 2.0 * torch.eye(28, device='cuda') + 0.1\n"
            "torch.linalg.eigh(A)\n"
            "torch.cuda.synchronize()\n"
            "g = torch.cuda.CUDAGraph()\n"
            "with torch.cuda.graph(g):\n"
            "    torch.linalg.eigh(A)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0
    assert "capture" in out.stderr, out.stderr[-2000:]


@pytest.mark.cuda
def test_fit_normal_kernel_zeroes_a_non_finite_system_on_card(cuda):
    nan = torch.full((28, 28), float("nan"), device=cuda)
    ones = torch.ones(28, device=cuda)
    assert torch.equal(fit_kernel.fit_normal(nan, ones), torch.zeros_like(ones))
    assert torch.equal(fit_kernel.fit_normal_plain(nan, ones),
                       torch.zeros_like(ones))
    with pytest.raises(NotImplementedError, match="even F"):
        fit_kernel.fit_normal(torch.eye(70, device=cuda),
                              torch.ones(70, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c2_reacher3", "c3_franka7"])
def test_train_many_graph_equals_eager_steps_on_card(cuda, name):
    """K replays of the captured train step against K eager steps from the
    same state, bit for bit (parameters, baseline weights, every stat), then
    two eager steps after the replays against steps K + 1 and K + 2 of the
    eager run: the graph advanced the generator as eager steps do. The
    capture launched what one eager step launches, and no plain version."""
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                         make_train_many,
                                                         make_train_step)
    horizon = 20 if name == "c2_reacher3" else 16
    cfg = pconfigs.CONFIGS[name].replace(n_envs=64, horizon=horizon)
    K = 4
    step = make_train_step(cfg)
    ref, rows = init_state(cfg, seed=3), []
    kernels.reset_counts()
    for i in range(K + 2):
        ref, st = step(ref)
        rows.append(st)
        if i == 0:
            one_step = kernels.launch_counts()
        if i == K - 1:
            at_k = [x.clone() for x in state_leaves(ref)]
    fn = make_train_many(cfg, K)
    state, stacked = fn(init_state(cfg, seed=3))
    assert fn.graphed().launches == one_step
    assert all(c == 0 for c in fn.graphed().plain_calls.values())
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(state), at_k))
    for k, v in stacked.items():
        assert torch.equal(v, torch.stack([r[k] for r in rows[:K]])), k
    for i in range(2):
        state, st = step(state)
        assert all(torch.equal(st[k], rows[K + i][k]) for k in st)
    assert all(torch.equal(a, b) for a, b in zip(state_leaves(state),
                                                 state_leaves(ref)))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["c2_reacher3", "c3_franka7"])
def test_world_of_one_over_nccl_is_the_unsharded_path_on_card(cuda, name):
    """``make_mesh`` with no group makes a world of one over NCCL: the
    sharded update equals ``trpo_update`` bit for bit with the same kernel
    launches, and ``make_train_many`` over the mesh (eager) equals the
    replayed graph of ``make_train_many`` bit for bit."""
    import torch.distributed as dist
    from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    from trpo_robot_control_tpu_torch.trpo.train import (init_state,
                                                         make_train_many)
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    cfg = pconfigs.CONFIGS[name].replace(n_envs=128, horizon=16)
    mesh = pm.make_mesh()
    try:
        assert dist.get_backend(mesh.group) == "nccl"
        st = init_state(cfg, seed=5)
        batch = make_rollout_fn(cfg)(st.params, st.gen)
        kernels.reset_counts()
        ref = trpo_update(cfg, st.params, st.w, batch)
        want = kernels.launch_counts()
        kernels.reset_counts()
        got = pm.make_sharded_update(cfg, mesh)(st.params, st.w,
                                                pm.shard_batch(mesh, batch))
        assert kernels.launch_counts() == want
        assert torch.equal(policy.flatten(ref[0]), policy.flatten(got[0]))
        assert torch.equal(ref[1], got[1])
        assert all(torch.equal(ref[2][k], got[2][k]) for k in ref[2])
        s1, a = make_train_many(cfg, 2)(init_state(cfg, seed=6))
        s2, b = make_train_many(cfg, 2, mesh)(init_state(cfg, seed=6))
        assert all(torch.equal(x, y) for x, y in zip(state_leaves(s1),
                                                     state_leaves(s2)))
        assert all(torch.equal(a[k], b[k]) for k in a)
    finally:
        dist.destroy_process_group()


def _gloo_rank_on_card(rank, port, path):
    """One of two gloo ranks sharing the card (spawned): its shard of the
    saved batch through the sharded update, written beside ``path``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    pm.init_distributed(timeout_s=60)
    mesh = pm.make_mesh(backend="gloo")
    saved = torch.load(path, weights_only=False)
    params = {k: v.cuda() for k, v in saved["params"].items()}
    kernels.reset_counts()
    new, w, st = pm.make_sharded_update(saved["cfg"], mesh)(
        params, saved["w"].cuda(), pm.shard_batch(mesh, saved["batch"]),
        return_directions=True)
    torch.save(dict(theta=policy.flatten(new).cpu(), w=w.cpu(),
                    stats={k: v.cpu() for k, v in st.items()},
                    launches=kernels.launch_counts()), f"{path}.{rank}")
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two spawned gloo ranks on one card (CUDA tensors staged through the
    host) on their halves of one c2 batch: bit-identical to each other,
    the unsharded update's launches on each, and the unsharded update's
    direction (cosine >= 0.999), beta (1e-3) and accepted exponent."""
    import socket

    import torch.multiprocessing as mp
    from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    from test_torch_helpers import cosine
    cfg = pconfigs.CONFIGS["c2_reacher3"].replace(n_envs=256, horizon=20)
    st = init_state(cfg, seed=7)
    batch = make_rollout_fn(cfg)(st.params, st.gen)
    kernels.reset_counts()
    _, _, ref = trpo_update(cfg, st.params, st.w, batch,
                            return_directions=True)
    want = kernels.launch_counts()
    path = str(tmp_path / "c2.pt")
    torch.save(dict(cfg=cfg, params={k: v.cpu() for k, v in st.params.items()},
                    w=st.w.cpu(), batch={k: v.cpu() for k, v in batch.items()}),
               path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_gloo_rank_on_card, args=(port, path), nprocs=2)
    r0, r1 = (torch.load(f"{path}.{r}", weights_only=False) for r in (0, 1))
    assert torch.equal(r0["theta"], r1["theta"])
    assert torch.equal(r0["w"], r1["w"])
    assert all(torch.equal(r0["stats"][k], r1["stats"][k])
               for k in r0["stats"])
    assert r0["launches"] == r1["launches"] == want
    assert cosine(r0["stats"]["x"].numpy(), ref["x"].cpu().numpy()) >= 0.999
    assert abs(float(r0["stats"]["beta"]) - float(ref["beta"])) \
        <= 1e-3 * float(ref["beta"])
    assert int(r0["stats"]["accepted"]) == int(ref["accepted"])


def _tp_rank_on_card(rank, port, path):
    """One of two gloo ranks sharing the card on a (1, 2) mesh (spawned):
    the tensor-parallel update of the saved batch, written beside
    ``path``."""
    import os
    os.environ.update(RANK=str(rank), WORLD_SIZE="2",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    from trpo_robot_control_tpu_torch.ops import cuda as kernels
    from trpo_robot_control_tpu_torch.parallel import mesh as pm
    pm.init_distributed(timeout_s=60)
    mesh = pm.make_mesh(n_data=1, n_model=2, backend="gloo")
    saved = torch.load(path, weights_only=False)
    params = {k: v.cuda() for k, v in saved["params"].items()}
    kernels.reset_counts()
    new, w, st = pm.make_sharded_update_tp(saved["cfg"], mesh)(
        params, saved["w"].cuda(), pm.shard_batch(mesh, saved["batch"]),
        return_directions=True)
    torch.save(dict(theta=policy.flatten(new).cpu(), w=w.cpu(),
                    stats={k: v.cpu() for k, v in st.items()},
                    launches=kernels.launch_counts()), f"{path}.{rank}")
    torch.distributed.destroy_process_group()


@pytest.mark.cuda
def test_tp_update_on_two_gloo_ranks_sharing_the_card(cuda, tmp_path):
    """The tensor-parallel update (``parallel/tensor.py``) on two spawned
    gloo ranks sharing the card, a (1, 2) mesh, on one c2 batch: the two
    ranks' full parameters, baseline and stats bit-identical, one
    fit_normal launch and no other kernel on each, and against the
    unsharded batch-major update the direction (cosine >= 0.999), beta
    (1e-3), the accepted exponent and theta (rtol 2e-3, atol 2e-4)."""
    import socket

    import torch.multiprocessing as mp
    from trpo_robot_control_tpu_torch.envs.arm import make_rollout_fn
    from trpo_robot_control_tpu_torch.trpo.train import init_state
    from trpo_robot_control_tpu_torch.trpo.update import trpo_update
    from test_torch_helpers import cosine
    cfg = pconfigs.CONFIGS["c2_reacher3"].replace(n_envs=256, horizon=20)
    st = init_state(cfg, seed=8)
    batch = {k: v for k, v in make_rollout_fn(cfg)(st.params, st.gen).items()
             if k in ("obs", "actions", "rewards")}
    new, _, ref = trpo_update(cfg, st.params, st.w, batch,
                              return_directions=True)
    path = str(tmp_path / "c2.pt")
    torch.save(dict(cfg=cfg, params={k: v.cpu() for k, v in st.params.items()},
                    w=st.w.cpu(), batch={k: v.cpu() for k, v in batch.items()}),
               path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    mp.spawn(_tp_rank_on_card, args=(port, path), nprocs=2)
    r0, r1 = (torch.load(f"{path}.{r}", weights_only=False) for r in (0, 1))
    assert torch.equal(r0["theta"], r1["theta"])
    assert torch.equal(r0["w"], r1["w"])
    assert all(torch.equal(r0["stats"][k], r1["stats"][k])
               for k in r0["stats"])
    for r in (r0, r1):
        assert r["launches"] == {k: int(k == "fit_normal")
                                 for k in r["launches"]}
    assert cosine(r0["stats"]["x"].numpy(), ref["x"].cpu().numpy()) >= 0.999
    assert abs(float(r0["stats"]["beta"]) - float(ref["beta"])) \
        <= 1e-3 * float(ref["beta"])
    assert int(r0["stats"]["accepted"]) == int(ref["accepted"])
    theta = policy.flatten(new).cpu()
    assert torch.all((r0["theta"] - theta).abs()
                     <= 2e-4 + 2e-3 * theta.abs())
