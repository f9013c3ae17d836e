"""Experiment configuration dataclasses for the PyTorch port.

A field-for-field copy of ``trpo_robot_control_tpu/configs/base.py``: the
port imports nothing from the JAX package, so it keeps its own frozen
constants. ``tests/test_torch_rules.py`` holds the two copies equal with
``dataclasses.asdict``. Field comments that name JAX-side implementation
switches (``fvp_impl``, ``moments_impl``, ...) describe the reference; the
port honours the values it has a counterpart for and, on the card, raises
for the others (``trpo/update.py:HONOURED``).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Tuple

Vec3 = Tuple[float, float, float]


@dataclass(frozen=True)
class JointSpec:
    """One revolute joint: a fixed transform from the parent link frame to
    the joint frame, then a variable rotation about the joint frame z-axis.

    ``pos``: translation (in the parent link frame) from the parent joint
    to this joint. ``rpy``: fixed roll/pitch/yaw applied after ``pos``.
    """

    pos: Vec3
    rpy: Vec3 = (0.0, 0.0, 0.0)


@dataclass(frozen=True)
class LinkSpec:
    """Rigid body attached to (and expressed in) its joint frame."""

    mass: float
    com: Vec3                 # centre of mass in the link frame
    inertia_diag: Vec3        # principal inertia about the COM, link frame


@dataclass(frozen=True)
class ArmSpec:
    """A fixed-base serial manipulator plus its simulation parameters."""

    joints: Tuple[JointSpec, ...]
    links: Tuple[LinkSpec, ...]
    ee_offset: Vec3            # end-effector point in the last link frame
    gravity: float = 0.0       # acceleration along world -z (0 => planar/horizontal)
    joint_damping: float = 0.05
    dt: float = 0.05
    n_substeps: int = 1
    torque_limit: float = 2.0
    qd_limit: float = 20.0     # hard clip on joint velocity (stability at fp32)
    # Initial-state distribution
    q0_noise: float = 0.1
    qd0_noise: float = 0.005
    # Target sampling: uniform annulus fractions of total reach
    target_rmin_frac: float = 0.25
    target_rmax_frac: float = 0.85
    # Observation scaling for joint velocities (keeps features bounded)
    qd_obs_scale: float = 0.1

    @property
    def n_joints(self) -> int:
        return len(self.joints)

    @property
    def reach(self) -> float:
        """Total reach: sum of joint offsets + ee offset magnitudes."""
        r = sum(math.sqrt(j.pos[0] ** 2 + j.pos[1] ** 2 + j.pos[2] ** 2)
                for j in self.joints[1:])
        r += math.sqrt(sum(v * v for v in self.ee_offset))
        return r

    @property
    def obs_dim(self) -> int:
        # [cos q, sin q, qd * qd_obs_scale, (p_tgt - p_ee) in 3D]
        return 3 * self.n_joints + 3


@dataclass(frozen=True)
class CostSpec:
    """Quadratic reaching cost: r = -(|p_ee - p_tgt|^2 + w |tau|^2)."""

    ctrl_weight: float = 0.01
    # Obstacle avoidance (config 4): smooth contact-free penalty
    # w_obs * relu(r_obs - d)^2 summed over joint origins + EE, for a
    # sphere at obstacle_center; inactive when obstacle_weight == 0.
    obstacle_weight: float = 0.0
    obstacle_radius: float = 0.15
    obstacle_center: Vec3 = (0.3, 0.0, 0.45)
    # Track task (multi-task family 1): target orbits world z at this rate.
    track_omega: float = 0.5
    # Push task (family 2): EE velocity should match v_push * dir(to tgt).
    push_speed: float = 0.3
    push_weight: float = 0.5


@dataclass(frozen=True)
class TRPOSpec:
    """TRPO hyper-parameters (SURVEY.md section 4 step list)."""

    delta: float = 0.01            # trust region (max mean KL)
    gamma: float = 0.99
    lam: float = 0.97
    cg_damping: float = 0.1
    cg_iters: int = 10
    ls_steps: int = 10             # backtracking exponents k = 0..ls_steps-1
    ls_backtrack: float = 0.5
    hidden: Tuple[int, ...] = (64, 64)
    logstd_init: float = -0.5
    baseline_reg: float = 1e-3     # ridge for the linear value baseline
    # FVP implementation: "auto" -> fused Pallas kernel on TPU (the
    # ff-native kernel when the batch is feature-first, tiles align,
    # and the global subsample clears the measured crossover; the
    # batch-major kernel otherwise), "pallas" forces the kernels
    # (ff-native preferred, no size gate), "pallas_bm" forces the
    # batch-major kernel (the A/B / fallback arm), "xla" = the
    # jax.linearize form, "kl" = jvp(grad(KL)) reference.
    fvp_impl: str = "auto"
    # Baseline normal-equation moments (ff path): "auto" -> fused Pallas
    # moments kernel on TPU when the env tile lane-aligns (one HBM pass
    # over obs_ff instead of the XLA form's concat+Gram+cross, measured
    # 10.5 -> ~1.5 ms at c5; ops/pallas/moments_kernel.py), else the
    # normal_eq_ff twin ("xla"); "pallas" forces the kernel (interpret
    # mode on CPU — tests/golden).
    moments_impl: str = "auto"
    # Surrogate policy gradient (ff path): "auto" -> fused Pallas
    # kernel on TPU when the env tile lane-aligns (reads obs/act/adv
    # ONCE, activations and cotangents never touch HBM — measured
    # 1.6 -> 0.6 ms at c3, 37 -> 12.6 ms at c5 vs the XLA form;
    # ops/pallas/pg_kernel.py), else the surrogate_grad_ff twin
    # ("xla"); "pallas" forces the kernel (interpret mode on CPU).
    surrgrad_impl: str = "auto"
    # Evaluate the Fisher on every k-th sample (classic TRPO
    # subsample_factor). 1 = exact (parity configs); larger values trade
    # a little Fisher estimation noise for proportionally cheaper CG.
    fvp_subsample: int = 1
    # Evaluate the Fisher on every k-th ENV on top of the time stride
    # above (ff path only). The time stride's cosine cliff is a TIME-
    # BIAS effect (c4 at t-stride 20 keeps 164k samples yet degrades to
    # 0.986, while c3's t-stride 8 is clean at 102k samples — the
    # sample COUNT is not the binding constraint near 100k), so large-N
    # configs whose t-stride-8 subsample is still millions of samples
    # can shed the surplus over the i.i.d. env axis instead: any fixed
    # env subset is an unbiased Fisher estimator (same argument as
    # ls_subsample), and with local N % k == 0 the strided env set is
    # sharding-invariant. 1 = exact (parity configs); c5 adopts 8 and
    # c4 adopts 4 from a measured decision (round 5,
    # scripts/measure_fvp_env_stride.py — cosine + full-scale A/B;
    # docs/performance.md).
    fvp_env_subsample: int = 1
    # Evaluate the LINE-SEARCH acceptance tests (surrogate improvement
    # and mean KL <= delta) on every k-th sample. Both are batch
    # expectations, so like fvp_subsample this is an estimator change,
    # not an algorithm change: at the adopted stride the estimates keep
    # >1e6 samples (sigma ~ 1e-3 relative) and the IMPROVEMENT test is
    # paired (surr_old re-estimated on the same subsample), cancelling
    # the sample-selection noise. 1 = exact (parity configs); bounded by
    # tests/test_ls_subsample.py + the full-scale accepted-k agreement
    # A/B in docs/performance.md.
    ls_subsample: int = 1
    # Value baseline (SURVEY.md section 3: "linear time-feature fit or
    # small MLP"): "linear" = ridge normal-equation fit on phi(s, t)
    # (the oracle-parity choice); "mlp" = small tanh MLP on the same
    # features, refit each update with baseline_epochs full-batch Adam
    # steps (warm-started from the previous update's weights).
    baseline: str = "linear"
    baseline_hidden: Tuple[int, ...] = (64,)
    baseline_lr: float = 1e-2
    baseline_epochs: int = 10
    # Storage dtype for the feature-first pipeline's batch-sized
    # intermediates: "f32" (exact) or "bf16". "bf16" gates FOUR sites,
    # each fp32-accumulating (storage rounds, contractions don't):
    #   1. the surrogate-gradient pass's (T, h, N) hidden activations /
    #      cotangents (HBM-bound at c4/c5 scale; bf16 halves that
    #      traffic — tests/test_ff_baseline.py::
    #      test_surrogate_grad_ff_bf16_close bounds the gradient error);
    #   2. KERNEL-side emission of obs_ff/actions_ff (envs/arm.py:
    #      make_rollout_fn passes store_dtype to the fused rollout
    #      kernels), halving the rollout's output writes;
    #   3. auto_block_b's VMEM output accounting (ops/pallas/
    #      rollout_kernel.py) — halved blocks double the env tile to
    #      256, which enables the pair-packed in-kernel MLP (pack2_ok);
    #   4. the baseline normal equations / regression targets
    #      (models/baseline.py:normal_eq_ff) read the storage dtype.
    # Adopted for c3-c5 from a measured decision — see the c3 note in
    # configs/__init__.py and docs/performance.md "Storage dtype".
    ff_store_dtype: str = "f32"


@dataclass(frozen=True)
class ExperimentConfig:
    name: str
    arm: ArmSpec
    cost: CostSpec
    trpo: TRPOSpec
    n_envs: int
    horizon: int
    n_iters: int = 100
    seed: int = 0
    # multi-task (config 5): number of goal families mixed per batch.
    # 1 = reach only; 3 = reach / track / push (see envs/costs.py).
    n_tasks: int = 1
    # Early episode termination (SURVEY.md section 2 L4 "episode
    # reset/termination"): an episode ends as soon as the post-step
    # end-effector is within this distance of the target, and the env
    # auto-resets to a fresh episode at the next step (all buffer slots
    # stay valid; GAE breaks the trajectory at the done flag). 0 disables
    # — episodes are fixed-horizon with termination only at t = T-1.
    done_dist: float = 0.0
    # rollout implementation: "auto" picks the fused Pallas kernel on TPU
    # for planar single-task arms, the XLA scan path otherwise.
    rollout_impl: str = "auto"

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)

    @property
    def obs_dim(self) -> int:
        """Arm observation + task one-hot when multi-task (n_tasks > 1)."""
        return self.arm.obs_dim + (self.n_tasks if self.n_tasks > 1 else 0)


def planar_arm(n_links: int,
               link_length: float = 0.5,
               link_mass: float = 1.0,
               **kw) -> ArmSpec:
    """Planar horizontal n-link arm: all joints rotate about world z.

    Link i is a uniform thin rod of length ``link_length`` along its local
    x-axis; the next joint sits at its far end. Gravity defaults to 0
    (horizontal plane), matching a MuJoCo-style "reacher".
    """
    joints = [JointSpec(pos=(0.0, 0.0, 0.0))]
    joints += [JointSpec(pos=(link_length, 0.0, 0.0)) for _ in range(n_links - 1)]
    izz = link_mass * link_length ** 2 / 12.0
    links = tuple(
        LinkSpec(mass=link_mass,
                 com=(link_length / 2.0, 0.0, 0.0),
                 inertia_diag=(1e-6, izz, izz))
        for _ in range(n_links)
    )
    return ArmSpec(joints=tuple(joints), links=links,
                   ee_offset=(link_length, 0.0, 0.0), **kw)
