"""Batched arm environment (port of ``trpo_robot_control_tpu/envs/arm.py``).

Task families (c5): 0 reach (static target), 1 track (the target orbits
world z at ``cost.track_omega``), 2 push (reach, and match the end
effector's velocity to ``push_speed`` towards the target); c4 adds the
obstacle sphere penalty. The 3-D rollout kernel scores all of them, for
spatial and planar arms alike.

``reset`` draws the initial states, targets and task families from the
same distributions as the reference, from a ``torch.Generator``; the
random streams differ from JAX's, so the tests share batches and action
noise instead. ``make_rollout_fn`` resolves the fused rollout kernel as
the reference does: planar, gravity-free, single-task arms without the
obstacle term take the planar kernel (K1), every other arm, planar ones
with task terms, the obstacle or gravity included, the 3-D RNEA kernel
(K4), as does every arm with ``rollout_impl="pallas3d"``; on the card a
``rollout_impl`` the port has no counterpart for raises. Both store obs
and actions in the config's ``ff_store_dtype`` (fp32 or bf16) and take
1-8 joints.

Early termination (``cfg.done_dist > 0``): an env whose post-step end
effector comes within ``done_dist`` of its target is flagged done and
starts a fresh episode, drawn from ``reset``'s distributions, before the
next step; both kernels do this in their terminating instantiations, and
the batch carries the done flags, with the last step always done.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.cuda import rollout3d_kernel, rollout_kernel
from ..trpo.update import check_switch
from .rigid_body import ArmConstants


class EnvState(NamedTuple):
    q: torch.Tensor       # (N, n) joint angles
    qd: torch.Tensor      # (N, n) joint velocities
    tgt: torch.Tensor     # (N, 3) target position (world)
    task: torch.Tensor    # (N,) int32 task family


def _planar_route(cfg) -> bool:
    """The planar kernel covers the bare reach task of a planar arm
    without gravity; everything else goes to the 3-D kernel, and so does
    every arm where ``rollout_impl`` is "pallas3d" (the JAX package's value
    that forces its 3-D kernel)."""
    return (ArmConstants(cfg.arm).planar and abs(cfg.arm.gravity) < 1e-12
            and cfg.n_tasks == 1 and cfg.cost.obstacle_weight == 0.0
            and cfg.rollout_impl != "pallas3d")


def _check_ported(cfg) -> None:
    if _planar_route(cfg):
        rollout_kernel.planar_consts(cfg)
        rollout_kernel.check_joints(cfg.arm.n_joints,
                                    "planar rollout kernel")
    else:
        rollout3d_kernel.check_instantiated(rollout3d_kernel.arm3d_consts(cfg))


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


def fresh_episodes(cfg, gen: torch.Generator, n_envs: int) -> EnvState:
    """``horizon`` fresh episodes per env, stacked on a leading T axis: row
    t is the episode an env starts when it is done at step t (a ``reset``
    per step, as the JAX package's terminating rollout draws them)."""
    draws = [reset(cfg, gen, n_envs) for _ in range(cfg.horizon)]
    return EnvState(*(torch.stack(x) for x in zip(*draws)))


def make_rollout_fn(cfg):
    """Returns fn(params, gen, n_envs=None) -> batch dict with the
    kernel-native obs_ff (T, do, N), actions_ff (T, n, N) (in
    ``ff_store_dtype``), rewards_ff (T, N) and their batch-major views obs
    (N, T, do), actions, rewards; with ``cfg.done_dist > 0`` also dones_ff
    (T, N), the last row set to 1, and its view dones (N, T).

    On the card the kernel draws its action noise, and a terminating
    config's fresh episodes, from Philox keyed by a seed taken from
    ``gen``; on the CPU they are drawn here and the wrapper runs the plain
    version."""
    _check_ported(cfg)
    planar = _planar_route(cfg)
    store = {"f32": torch.float32, "bf16": torch.bfloat16}[
        cfg.trpo.ff_store_dtype]

    def fn(params, gen: torch.Generator, n_envs=None):
        N = cfg.n_envs if n_envs is None else n_envs
        dev = gen.device
        check_switch("rollout_impl", cfg.rollout_impl, dev)
        s = reset(cfg, gen, N)
        seed = eps = fresh = None
        if dev.type == "cuda":
            seed = torch.randint(0, 2 ** 32, (2,), generator=gen, device=dev,
                                 dtype=torch.int64)
        else:
            eps = torch.randn(cfg.horizon, N, cfg.arm.n_joints,
                              generator=gen, device=dev)
            if cfg.done_dist > 0.0:
                fresh = fresh_episodes(cfg, gen, N)
        if planar:
            out = rollout_kernel.rollout(cfg, params, s.q, s.qd, s.tgt,
                                         eps=eps, seed=seed, fresh=fresh,
                                         store_dtype=store)
        else:
            out = rollout3d_kernel.rollout3d(cfg, params, s.q, s.qd, s.tgt,
                                             s.task, eps=eps, seed=seed,
                                             store_dtype=store, fresh=fresh)
        if len(out) == 4:
            # the final step always ends the episode (fixed buffer end, no
            # bootstrap), as in the JAX package; fill_, which a CUDA graph
            # captures, not an assignment (a host scalar's copy)
            out[3][-1].fill_(1.0)
        return batch_from_ff(*out)

    return fn


def batch_from_ff(obs_ff, act_ff, rew_ff, dones_ff=None):
    """The batch dict of the JAX rollouts; the batch-major entries are
    views, not copies. ``dones_ff`` (T, N), where given, is used as it is:
    its last row is the caller's to set."""
    batch = dict(obs=obs_ff.permute(2, 0, 1),
                 actions=act_ff.permute(2, 0, 1), rewards=rew_ff.T,
                 obs_ff=obs_ff, actions_ff=act_ff, rewards_ff=rew_ff)
    if dones_ff is not None:
        batch.update(dones_ff=dones_ff, dones=dones_ff.T)
    return batch
