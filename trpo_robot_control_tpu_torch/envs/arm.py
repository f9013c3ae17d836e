"""Batched arm environment (port of ``trpo_robot_control_tpu/envs/arm.py``
without early termination).

Task families (c5): 0 reach (static target), 1 track (the target orbits
world z at ``cost.track_omega``), 2 push (reach, and match the end
effector's velocity to ``push_speed`` towards the target); c4 adds the
obstacle sphere penalty. The 3-D rollout kernel scores all of them.

``reset`` draws the initial states, targets and task families from the
same distributions as the reference, from a ``torch.Generator``; the
random streams differ from JAX's, so the tests share batches and action
noise instead. ``make_rollout_fn`` resolves the fused rollout kernel as
the reference does: planar, gravity-free, single-task arms without the
obstacle term take the planar kernel (K1, fp32 storage), every other arm
the 3-D RNEA kernel (K4, fp32 or bf16 storage).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.cuda import rollout3d_kernel, rollout_kernel
from .rigid_body import ArmConstants


class EnvState(NamedTuple):
    q: torch.Tensor       # (N, n) joint angles
    qd: torch.Tensor      # (N, n) joint velocities
    tgt: torch.Tensor     # (N, 3) target position (world)
    task: torch.Tensor    # (N,) int32 task family


def _planar_route(cfg) -> bool:
    """The planar kernel covers the bare reach task of a planar arm
    without gravity; everything else goes to the 3-D kernel."""
    return (ArmConstants(cfg.arm).planar and abs(cfg.arm.gravity) < 1e-12
            and cfg.n_tasks == 1 and cfg.cost.obstacle_weight == 0.0)


def _check_ported(cfg) -> None:
    if _planar_route(cfg):
        rollout_kernel.planar_consts(cfg)
    else:
        rollout3d_kernel.arm3d_consts(cfg)


def reset(cfg, gen: torch.Generator, n_envs: int) -> EnvState:
    _check_ported(cfg)
    spec = cfg.arm
    n = spec.n_joints
    dev = gen.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    q = spec.q0_noise * uniform((n_envs, n), -1.0, 1.0)
    qd = spec.qd0_noise * uniform((n_envs, n), -1.0, 1.0)
    r = uniform((n_envs,), spec.target_rmin_frac,
                spec.target_rmax_frac) * spec.reach
    if ArmConstants(spec).planar:
        th = uniform((n_envs,), 0.0, 2.0 * math.pi)
        tgt = torch.stack([r * torch.cos(th), r * torch.sin(th),
                           torch.zeros_like(r)], dim=-1)
    else:
        # direction: a normalised 3-normal on the upper hemisphere
        u = torch.randn(n_envs, 3, generator=gen, device=dev)
        u = u / (torch.linalg.norm(u, dim=-1, keepdim=True) + 1e-12)
        u = torch.cat([u[:, :2], u[:, 2:].abs()], dim=-1)
        tgt = r[:, None] * u
    if cfg.n_tasks > 1:       # drawn last, so single-task streams keep theirs
        task = torch.randint(0, cfg.n_tasks, (n_envs,), generator=gen,
                             device=dev, dtype=torch.int32)
    else:
        task = torch.zeros(n_envs, dtype=torch.int32, device=dev)
    return EnvState(q=q, qd=qd, tgt=tgt, task=task)


def make_rollout_fn(cfg):
    """Returns fn(params, gen, n_envs=None) -> batch dict with the
    kernel-native obs_ff (T, do, N), actions_ff (T, n, N) (in
    ``ff_store_dtype``), rewards_ff (T, N) and their batch-major views obs
    (N, T, do), actions, rewards.

    On the card the kernel draws its action noise from Philox keyed by a
    seed taken from ``gen``; on the CPU the noise is drawn here and the
    wrapper runs the plain version."""
    _check_ported(cfg)
    planar = _planar_route(cfg)
    store = {"f32": torch.float32, "bf16": torch.bfloat16}[
        cfg.trpo.ff_store_dtype]
    if planar and store != torch.float32:
        raise NotImplementedError(
            "bf16 storage in the planar rollout kernel comes with a later "
            "slice of the port")

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
        if planar:
            out = rollout_kernel.rollout(cfg, params, s.q, s.qd, s.tgt,
                                         eps=eps, seed=seed)
        else:
            out = rollout3d_kernel.rollout3d(cfg, params, s.q, s.qd, s.tgt,
                                             s.task, eps=eps, seed=seed,
                                             store_dtype=store)
        return batch_from_ff(*out)

    return fn


def batch_from_ff(obs_ff, act_ff, rew_ff):
    """The batch dict of the JAX rollouts; the batch-major entries are
    views, not copies."""
    return dict(obs=obs_ff.permute(2, 0, 1), actions=act_ff.permute(2, 0, 1),
                rewards=rew_ff.T, obs_ff=obs_ff, actions_ff=act_ff,
                rewards_ff=rew_ff)
