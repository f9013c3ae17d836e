"""The port's CUDA kernels against their plain PyTorch versions, on the
card. They skip without one. Run them there with

  python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: the repo's conftest imports JAX, which the GPU machine
need not have; this file imports only numpy, torch and the port)."""
import numpy as np
import pytest
import torch

from test_torch_helpers import env_inputs_np, policy_params_np, t
from trpo_robot_control_tpu_torch import configs as pconfigs
from trpo_robot_control_tpu_torch.ops.cuda import (fvp_kernel,
                                                   moments_kernel,
                                                   rollout_kernel)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rollout_kernel_matches_plain_on_card(cuda):
    cfg = pconfigs.C2_REACHER3.replace(horizon=10)
    N = 256
    pn = policy_params_np(np.random.RandomState(6), cfg.obs_dim, 3)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    ins = [t(x).to(cuda) for x in env_inputs_np(cfg, N, seed=7)]
    k_out = rollout_kernel.rollout(cfg, pc, *ins[:3], eps=ins[3])
    p_out = rollout_kernel.rollout_plain(cfg, pc, *ins[:3], ins[3])
    for a, b in zip(k_out, p_out):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)
    seed = torch.tensor([3, 4], dtype=torch.int64, device=cuda)
    a1 = rollout_kernel.rollout(cfg, pc, *ins[:3], seed=seed)
    a2 = rollout_kernel.rollout(cfg, pc, *ins[:3], seed=seed)
    assert all(torch.equal(x, y) for x, y in zip(a1, a2))


@pytest.mark.cuda
def test_moments_kernel_matches_plain_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    T, do, N = 20, 12, 300
    obs = torch.randn(T, do, N, generator=g, device=cuda)
    y = 5.0 * torch.randn(T, N, generator=g, device=cuda)
    tau = moments_kernel._time_features(T, T, cuda)
    gk = moments_kernel.extended_gram(obs, y, tau)
    gp = moments_kernel.extended_gram_plain(obs, y, tau)
    assert float((gk - gp).abs().max() / gp.abs().max()) < 1e-5
    assert torch.equal(gk, moments_kernel.extended_gram(obs, y, tau))


@pytest.mark.cuda
def test_fvp_kernel_matches_plain_on_card(cuda):
    pn = policy_params_np(np.random.RandomState(8), 12, 3)
    pc = {k: t(v).to(cuda) for k, v in pn.items()}
    obs = torch.randn(1000, 12, device=cuda)
    hs = fvp_kernel.activations(pc, obs)
    scale = torch.exp(-2.0 * pc["logstd"]) / obs.shape[0]
    v = torch.randn(sum(x.numel() for x in pc.values()), device=cuda)
    fk = fvp_kernel.gn_fvp(pc, obs, hs, scale, v, 0.1)
    fp = fvp_kernel.gn_fvp_plain(pc, obs, hs, scale, v, 0.1)
    assert float(torch.linalg.norm(fk - fp) / torch.linalg.norm(fp)) < 1e-5
    assert torch.equal(fk, fvp_kernel.gn_fvp(pc, obs, hs, scale, v, 0.1))
