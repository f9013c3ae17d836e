"""The five experiment configs, copied from ``trpo_robot_control_tpu.configs``
(the port keeps its own copy; ``tests/test_torch_rules.py`` holds them equal).

c1: 2-link planar reacher, 64 envs, horizon 50   (oracle-parity config)
c2: 3-link reacher, 1024 envs, horizon 100       (single-chip fused FVP/CG)
c3: 7-DoF Franka-like, 4096 envs, horizon 200    (Pallas rollout + FVP, 1 host)
c4: 7-DoF + obstacle cost, 16k envs, 2 hosts     (psum-reduced CG)
c5: multi-task suite, 64k envs                   (full training run)
"""
from __future__ import annotations

import math

from .base import (ArmSpec, CostSpec, ExperimentConfig, JointSpec, LinkSpec,
                   TRPOSpec, planar_arm)

_PI = math.pi


def franka_like_arm(**kw) -> ArmSpec:
    """7-DoF arm with Franka-Panda-like kinematics (URDF-style joint
    origins; masses/inertias are plausible, not identified values).

    All joints revolute about the local z-axis after the fixed transform.
    """
    joints = (
        JointSpec(pos=(0.0, 0.0, 0.333)),
        JointSpec(pos=(0.0, 0.0, 0.0), rpy=(-_PI / 2, 0.0, 0.0)),
        JointSpec(pos=(0.0, -0.316, 0.0), rpy=(_PI / 2, 0.0, 0.0)),
        JointSpec(pos=(0.0825, 0.0, 0.0), rpy=(_PI / 2, 0.0, 0.0)),
        JointSpec(pos=(-0.0825, 0.384, 0.0), rpy=(-_PI / 2, 0.0, 0.0)),
        JointSpec(pos=(0.0, 0.0, 0.0), rpy=(_PI / 2, 0.0, 0.0)),
        JointSpec(pos=(0.088, 0.0, 0.0), rpy=(_PI / 2, 0.0, 0.0)),
    )
    masses = (4.97, 0.647, 3.23, 3.59, 1.23, 1.67, 0.735)
    coms = (
        (0.0, -0.03, -0.08), (0.0, -0.07, 0.03), (0.03, 0.03, -0.07),
        (-0.05, 0.10, 0.0), (0.0, 0.03, -0.10), (0.06, 0.0, 0.0),
        (0.0, 0.0, 0.08),
    )
    links = tuple(
        LinkSpec(mass=m, com=c,
                 inertia_diag=(0.02 * m, 0.02 * m, 0.01 * m))
        for m, c in zip(masses, coms)
    )
    base = dict(joints=joints, links=links, ee_offset=(0.0, 0.0, 0.107),
                gravity=9.81, joint_damping=0.5, dt=0.02, n_substeps=2,
                torque_limit=20.0, q0_noise=0.2, qd0_noise=0.005,
                target_rmin_frac=0.25, target_rmax_frac=0.7)
    base.update(kw)
    return ArmSpec(**base)


C1_REACHER2 = ExperimentConfig(
    name="c1_reacher2",
    arm=planar_arm(2),
    cost=CostSpec(ctrl_weight=0.01),
    trpo=TRPOSpec(),
    n_envs=64, horizon=50, n_iters=100, seed=0,
)

C2_REACHER3 = ExperimentConfig(
    name="c2_reacher3",
    arm=planar_arm(3),
    cost=CostSpec(ctrl_weight=0.01),
    # fvp_subsample=4 adopted from a measured decision (round 3,
    # scripts/measure_c2_stride.py): direction cosine vs exact stride-1
    # min 0.99956 over 3 seeds, and a 40-iter full-scale convergence A/B
    # indistinguishable from exact (final return -26.1 vs -25.7); stride
    # 10 degrades convergence (-31.1). See docs/performance.md.
    trpo=TRPOSpec(fvp_subsample=4),
    n_envs=1024, horizon=100, n_iters=200, seed=0,
)

# c3-c5 run bf16 STORAGE (not compute): the fused kernels emit
# obs_ff/actions_ff in bf16 and the surrogate-gradient pass stores its
# (T, h, N) activations/cotangents bf16 — every contraction still
# accumulates fp32. Adopted from a measured decision (round 3): the
# HBM-bound update passes shrink ~35%, the halved output blocks raise
# the rollout tile to 256 which enables the pair-packed in-kernel MLP,
# and a 40-iter full-scale c4 convergence A/B is indistinguishable from
# fp32 (scripts/ab_bf16.py; docs/performance.md). Gradient/moment error
# bounds: tests/test_ff_baseline.py. fvp_subsample stays 8 — measured
# at the cosine cliff's edge (scripts/measure_c45_stride.py).
# ls_subsample=8 (round 4, scripts/measure_ls_subsample.py): the
# line-search acceptance statistics are estimated on a 1/8 env-strided
# subsample — measured at full scale: accepted-k agreement 139/140
# iterations across c3-c5 (the one miss a near-boundary half-step),
# KL estimate within 2.7%, and a 40-iter full-scale c4 convergence A/B
# indistinguishable from exact (last5 -87.2 vs -88.5). Saves one full
# forward pass over the batch per candidate eval (~8.6 ms at c5).
# fvp_env_subsample (round 5, scripts/measure_fvp_env_stride.py): the
# t-stride cliff is TIME bias, not sample count (c4 t-20 keeps 164k
# samples yet hits 0.986 while c3's clean t-8 subsample is only 102k),
# so c4/c5 shed their surplus Fisher samples over the i.i.d. env axis
# down to the c3-anchored ~100-200k: c4 e=4 (410k -> 102k samples;
# cosine vs exact 0.9984/0.9992 across 2 seeds, vs e=1's own
# 0.9989/0.9994), c5 e=8 (1.64M -> 205k; marginal cosine vs the
# shipped t8 estimator 0.9997 — the exact comparator OOMs at c5 on one
# chip, and c4 pins env-stride-vs-exact). Full-scale 40-iter A/Bs
# indistinguishable both configs (c4 last5 -87.3 vs -86.8; c5 -198.8
# vs -199.8, strided arm ahead i.e. inside noise). CG block cost drops
# ~4x/8x; docs/performance.md "Round 5: env-strided Fisher".
C3_FRANKA7 = ExperimentConfig(
    name="c3_franka7",
    arm=franka_like_arm(),
    cost=CostSpec(ctrl_weight=0.001),
    trpo=TRPOSpec(fvp_subsample=8, ff_store_dtype="bf16",
                  ls_subsample=8),
    n_envs=4096, horizon=200, n_iters=300, seed=0,
)

C4_FRANKA7_OBSTACLE = ExperimentConfig(
    name="c4_franka7_obstacle",
    arm=franka_like_arm(),
    cost=CostSpec(ctrl_weight=0.001, obstacle_weight=1.0,
                  obstacle_radius=0.15),
    trpo=TRPOSpec(fvp_subsample=8, fvp_env_subsample=4,
                  ff_store_dtype="bf16", ls_subsample=8),
    n_envs=16384, horizon=200, n_iters=300, seed=0,
)

C5_MULTITASK = ExperimentConfig(
    name="c5_multitask",
    arm=franka_like_arm(),
    cost=CostSpec(ctrl_weight=0.001),
    trpo=TRPOSpec(fvp_subsample=8, fvp_env_subsample=8,
                  ff_store_dtype="bf16", ls_subsample=8),
    n_envs=65536, horizon=200, n_iters=500, seed=0,
    n_tasks=3,
)

CONFIGS = {c.name: c for c in
           (C1_REACHER2, C2_REACHER3, C3_FRANKA7, C4_FRANKA7_OBSTACLE,
            C5_MULTITASK)}

__all__ = ["ArmSpec", "CostSpec", "ExperimentConfig", "JointSpec",
           "LinkSpec", "TRPOSpec", "planar_arm", "franka_like_arm",
           "C1_REACHER2", "C2_REACHER3", "C3_FRANKA7",
           "C4_FRANKA7_OBSTACLE", "C5_MULTITASK", "CONFIGS"]
