"""Batched planar arm-reaching environment (port of the planar branch of
``trpo_robot_control_tpu/envs/arm.py``).

``reset`` draws the initial states and targets from the same distributions
as the reference, from a ``torch.Generator``; the random streams differ
from JAX's, so the tests share batches and action noise instead.
``make_rollout_fn`` resolves to the fused rollout kernel's wrapper.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.cuda import rollout_kernel


class EnvState(NamedTuple):
    q: torch.Tensor       # (N, n) joint angles
    qd: torch.Tensor      # (N, n) joint velocities
    tgt: torch.Tensor     # (N, 3) target position (world)


def reset(cfg, gen: torch.Generator, n_envs: int) -> EnvState:
    rollout_kernel.planar_consts(cfg)     # raises for what is not ported
    spec = cfg.arm
    n = spec.n_joints
    dev = gen.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    q = spec.q0_noise * uniform((n_envs, n), -1.0, 1.0)
    qd = spec.qd0_noise * uniform((n_envs, n), -1.0, 1.0)
    r = uniform((n_envs,), spec.target_rmin_frac,
                spec.target_rmax_frac) * spec.reach
    th = uniform((n_envs,), 0.0, 2.0 * math.pi)
    tgt = torch.stack([r * torch.cos(th), r * torch.sin(th),
                       torch.zeros_like(r)], dim=-1)
    return EnvState(q=q, qd=qd, tgt=tgt)


def make_rollout_fn(cfg):
    """Returns fn(params, gen, n_envs=None) -> batch dict with the
    kernel-native obs_ff (T, do, N), actions_ff (T, n, N), rewards_ff
    (T, N) and their batch-major views obs (N, T, do), actions, rewards.

    On the card the kernel draws its action noise from Philox keyed by a
    seed taken from ``gen``; on the CPU the noise is drawn here and the
    wrapper runs the plain version."""
    rollout_kernel.planar_consts(cfg)
    if cfg.trpo.ff_store_dtype != "f32":
        raise NotImplementedError(
            "bf16 storage (ff_store_dtype) comes with slice 2 of the port")

    def fn(params, gen: torch.Generator, n_envs=None):
        N = cfg.n_envs if n_envs is None else n_envs
        dev = gen.device
        s = reset(cfg, gen, N)
        if dev.type == "cuda":
            seed = torch.randint(0, 2 ** 32, (2,), generator=gen, device=dev,
                                 dtype=torch.int64)
            eps = None
        else:
            seed = None
            eps = torch.randn(cfg.horizon, N, cfg.arm.n_joints,
                              generator=gen, device=dev)
        obs_ff, act_ff, rew_ff = rollout_kernel.rollout(
            cfg, params, s.q, s.qd, s.tgt, eps=eps, seed=seed)
        return batch_from_ff(obs_ff, act_ff, rew_ff)

    return fn


def batch_from_ff(obs_ff, act_ff, rew_ff):
    """The batch dict of the JAX rollouts; the batch-major entries are
    views, not copies."""
    return dict(obs=obs_ff.permute(2, 0, 1), actions=act_ff.permute(2, 0, 1),
                rewards=rew_ff.T, obs_ff=obs_ff, actions_ff=act_ff,
                rewards_ff=rew_ff)
