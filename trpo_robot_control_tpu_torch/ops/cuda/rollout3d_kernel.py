"""K4: fused rollout of an arm of 1-8 joints (``csrc/rollout3d.cu``).

Replaces ``pallas_rollout3d`` in
``trpo_robot_control_tpu/ops/pallas/rollout3d_kernel.py``: per step FK,
the observation (with the task one-hot when there are several task
families), the tanh-MLP mean, a Gaussian action, the torque clip, the
mass matrix and the gravity/Coriolis bias as one fused sweep of n + 1
world-frame RNEA passes, a regularised Cholesky solve and semi-implicit
Euler substeps, and ``_score_step``'s scoring at the post-step state: the
track task's target rotation, the reach and control cost, the push
task's velocity penalty and the obstacle sphere penalty; and, when
``cfg.done_dist > 0``, the terminating branch: an env whose post-step
end effector is within ``done_dist`` of its (rotated) target is flagged
done and starts a fresh episode (state, target and, with several
families, task) before the next step. It takes any arm, spatial or
planar (a planar arm's fresh targets lie in the z = 0 plane, as
``envs/arm.py:reset`` draws them), with 1, 2 or 3 task families and the
obstacle term on or off, and any tanh policy of 1-3 hidden layers of
1-128 units (over 64, the kernel's wide form: the TPU kernel's unpacked
``_policy_ff``); it is built for ``JOINT_COUNTS`` (one library per count,
and per policy shape other than (64, 64); past them, ROADMAP B3). See the
source for what bounds it on the card and its warp roles: one state warp
does each env's serial work, one column warp per joint runs mass-matrix
passes specialised to what is not structurally zero (``mass_bias_split``
states them in PyTorch) and the policy MLP; ``occupancy`` reports what
the card makes of each instantiation.

``rollout3d`` is the wrapper: on CUDA tensors it launches the kernel (or
raises), on CPU tensors it runs ``rollout3d_plain``, the same component
math on lists of (N,) tensors in the kernel's op order (exact cos/sin
every substep, as ``rollout3d_reference`` in the JAX package). Outputs
keep the (T, d, N) layout; obs and actions are stored in ``store_dtype``
(fp32 or bf16, rounded once at the store: the trajectory stays fp32),
rewards in fp32. Noise: ``eps`` (T, N, n) from the caller, or Philox keyed
by ``seed`` (an int64 pair on the device), on the card only. ``task``
(N,) holds each env's task family (0 reach, 1 track, 2 push); it is read
only when the config has several. Fresh episodes of a terminating config
come as in ``rollout_kernel``: ``fresh`` = (q, qd, tgt, task) with a
leading T axis alongside ``eps``, or drawn in the kernel in Philox mode.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from . import build
from ...envs.rigid_body import ArmConstants
from .rollout_kernel import (JOINT_COUNTS, _policy_mean, check_fresh,
                             check_joints, check_store, done_dist2,
                             fresh_feature_first)

TASK_FAMILIES = (1, 2, 3)   # reach; reach and track; reach, track and push

_SIG = {"trpo_rollout3d_launch":
        [ctypes.c_void_p] + [ctypes.c_int] * 6
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 15
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "trpo_rollout3d_occupancy": [ctypes.c_int] * 5 + [ctypes.c_void_p]}


class Arm3DConsts(NamedTuple):
    n: int
    T_rot: tuple      # n x (3x3 float tuples)
    T_pos: tuple      # n x (3 floats)
    mass: tuple
    com: tuple        # n x (3 floats)
    inertia: tuple    # n x (3x3 float tuples, link frame)
    ee_offset: tuple
    gravity: float
    damping: float
    dt: float
    n_substeps: int
    torque_limit: float
    qd_limit: float
    qd_obs_scale: float
    ctrl_weight: float
    chol_reg: float
    n_tasks: int
    track_cos: float  # cos/sin of track_omega * dt, in fp64 (rounded to
    track_sin: float  # fp32 where they meet fp32 data)
    push_speed: float
    push_weight: float
    obstacle_weight: float
    obstacle_radius: float
    obstacle_center: tuple
    # early termination and the reset distributions, as in PlanarConsts
    # (the target direction is a normalised 3-normal with z >= 0, or for a
    # planar arm an angle in the z = 0 plane)
    done_dist: float = 0.0
    q0_noise: float = 0.0
    qd0_noise: float = 0.0
    rmin: float = 0.0
    rmax: float = 0.0
    planar: bool = False


def arm3d_consts(cfg, chol_reg: float = 1e-6) -> Arm3DConsts:
    """Constants of the arm, its task terms and its episode resets,
    float32-rounded as the JAX package rounds them."""
    spec = cfg.arm
    c = ArmConstants(spec)
    cost = cfg.cost
    w_dt = float(cost.track_omega) * float(spec.dt)
    return Arm3DConsts(
        n=c.n,
        T_rot=tuple(tuple(map(tuple, t)) for t in c.T_rot),
        T_pos=tuple(tuple(t) for t in c.T_pos),
        mass=tuple(c.mass),
        com=tuple(tuple(x) for x in c.com),
        inertia=tuple(tuple(map(tuple, i)) for i in c.inertia),
        ee_offset=tuple(c.ee_offset),
        gravity=float(spec.gravity),
        damping=float(spec.joint_damping), dt=float(spec.dt),
        n_substeps=int(spec.n_substeps),
        torque_limit=float(spec.torque_limit),
        qd_limit=float(spec.qd_limit),
        qd_obs_scale=float(spec.qd_obs_scale),
        ctrl_weight=float(cost.ctrl_weight),
        chol_reg=chol_reg,
        n_tasks=int(cfg.n_tasks),
        track_cos=math.cos(w_dt), track_sin=math.sin(w_dt),
        push_speed=float(cost.push_speed),
        push_weight=float(cost.push_weight),
        obstacle_weight=float(cost.obstacle_weight),
        obstacle_radius=float(cost.obstacle_radius),
        obstacle_center=tuple(float(x) for x in cost.obstacle_center),
        done_dist=float(cfg.done_dist), q0_noise=float(spec.q0_noise),
        qd0_noise=float(spec.qd0_noise),
        rmin=float(spec.target_rmin_frac * spec.reach),
        rmax=float(spec.target_rmax_frac * spec.reach),
        planar=bool(c.planar))


# ------------------------------------------------------- plain version
# Every scalar channel is an (N,) tensor (or (n + 1, N) in the fused
# RNEA sweep); vectors are 3-tuples, rotations row-major 9-tuples. Fixed
# transforms are Python floats and their zero and unit entries fold away,
# as in the JAX package's component math.

def v_add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def v_sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def v_scale(s, a):
    return (s * a[0], s * a[1], s * a[2])


def v_cross(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def v_dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _fold(R, x):
    return R if x == 1.0 else (-R if x == -1.0 else R * x)


def m_vec_const(R, v3):
    out = []
    for r in range(3):
        acc = None
        for col in range(3):
            x = float(v3[col])
            if x != 0.0:
                term = _fold(R[3 * r + col], x)
                acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(R[0]))
    return tuple(out)


def m_vec(R, v):
    return (R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
            R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
            R[6] * v[0] + R[7] * v[1] + R[8] * v[2])


def m_mul_const(R, Tm):
    out = []
    for r in range(3):
        for col in range(3):
            acc = None
            for k in range(3):
                x = float(Tm[k][col])
                if x != 0.0:
                    term = _fold(R[3 * r + k], x)
                    acc = term if acc is None else acc + term
            out.append(acc if acc is not None else torch.zeros_like(R[0]))
    return tuple(out)


def m_rotz(A, cq, sq):
    """A @ Rz(q): columns 0 and 1 mix by cos/sin; column 2 unchanged."""
    return (A[0] * cq + A[1] * sq, -A[0] * sq + A[1] * cq, A[2],
            A[3] * cq + A[4] * sq, -A[3] * sq + A[4] * cq, A[5],
            A[6] * cq + A[7] * sq, -A[6] * sq + A[7] * cq, A[8])


def _fk3(c: Arm3DConsts, cq, sq):
    """FK from per-joint cos/sin lists -> (R[i] 9-tuples, p[i], axis[i],
    ee)."""
    zero = torch.zeros_like(cq[0])
    one = torch.ones_like(cq[0])
    R_par = (one, zero, zero, zero, one, zero, zero, zero, one)
    p_par = (zero, zero, zero)
    R, p, axis = [], [], []
    for i in range(c.n):
        A = m_mul_const(R_par, c.T_rot[i])
        p_i = v_add(p_par, m_vec_const(R_par, c.T_pos[i]))
        R_i = m_rotz(A, cq[i], sq[i])
        axis.append((A[2], A[5], A[8]))
        R.append(R_i)
        p.append(p_i)
        R_par, p_par = R_i, p_i
    ee = v_add(p[-1], m_vec_const(R[-1], c.ee_offset))
    return R, p, axis, ee


def _inertia_vec(Ri, Ic, v):
    """World inertia times v: R (I (R^T v)), I a link-frame 3x3 of
    floats."""
    tv = m_vec((Ri[0], Ri[3], Ri[6], Ri[1], Ri[4], Ri[7], Ri[2], Ri[5], Ri[8]),
               v)
    iv = tuple(tv[0] * float(Ic[r][0]) + tv[1] * float(Ic[r][1])
               + tv[2] * float(Ic[r][2]) for r in range(3))
    return m_vec(Ri, iv)


def _mass_bias_fused(c: Arm3DConsts, R, p, axis, qd):
    """All n mass-matrix columns and the bias as one RNEA sweep on
    (n + 1, N) channels: row j < n is the zero-velocity, unit-qdd_j pass
    (column j of M), row n the real-velocity, gravity, qdd = 0 pass (the
    bias). Returns (M {(i, j): (N,)} for i <= j, bias list of n (N,))."""
    n = c.n
    ref = qd[0]
    rows = n + 1
    zero_r = torch.zeros((rows,) + ref.shape, dtype=ref.dtype,
                         device=ref.device)
    zv = (zero_r, zero_r, zero_r)
    row_ids = torch.arange(rows, device=ref.device)[:, None]

    def col_const(j):
        return (row_ids == j).to(ref.dtype)

    bias_row = col_const(n)
    g_vec = ((zero_r, zero_r, c.gravity * bias_row + zero_r) if c.gravity
             else zv)
    w_par, wd_par, a_par = zv, zv, g_vec
    p_par = (torch.zeros_like(ref),) * 3
    ws, wds, acs, cws = [], [], [], []
    for i in range(n):
        qd_i = bias_row * qd[i]
        qdd_i = col_const(i)
        r = v_sub(p[i], p_par)
        a_i = v_add(a_par, v_add(v_cross(wd_par, r),
                                 v_cross(w_par, v_cross(w_par, r))))
        s = axis[i]
        w_i = v_add(w_par, v_scale(qd_i, s))
        wd_i = v_add(v_add(wd_par, v_scale(qdd_i, s)),
                     v_cross(w_par, v_scale(qd_i, s)))
        d = m_vec_const(R[i], c.com[i])
        ac_i = v_add(a_i, v_add(v_cross(wd_i, d),
                                v_cross(w_i, v_cross(w_i, d))))
        ws.append(w_i)
        wds.append(wd_i)
        acs.append(ac_i)
        cws.append(v_add(p[i], d))
        w_par, wd_par, a_par, p_par = w_i, wd_i, a_i, p[i]

    taus = [None] * n
    f_child, n_child = zv, zv
    p_child = (torch.zeros_like(ref),) * 3
    for i in range(n - 1, -1, -1):
        Ri, Ic = R[i], c.inertia[i]
        F = v_scale(c.mass[i], acs[i])
        N = v_add(_inertia_vec(Ri, Ic, wds[i]),
                  v_cross(ws[i], _inertia_vec(Ri, Ic, ws[i])))
        f = v_add(F, f_child)
        nn = v_add(v_add(N, n_child),
                   v_add(v_cross(v_sub(cws[i], p[i]), F),
                         v_cross(v_sub(p_child, p[i]), f_child)))
        taus[i] = v_dot(axis[i], nn)                 # (rows, N)
        f_child, n_child, p_child = f, nn, p[i]

    M = {(i, j): taus[i][j] for i in range(n) for j in range(i, n)}
    return M, [taus[i][n] for i in range(n)]


# The kernel's specialised passes, stated on (N,) tensors in its operation
# order. Each leaves out of the fused sweep only terms that are exactly
# +-0 there (zero velocities, zero accelerations, no gravity), and
# x + (+-0) = x for every non-zero x, so they give the fused sweep's
# numbers up to the sign of a zero (tests/test_torch_rnea_column.py).

def pass_frames(c: Arm3DConsts, R, p, axis):
    """What every pass reads of joint i, computed once per substep as the
    kernel's state warp does: (R_i, s_i, r_i = p_i - p_{i-1}, d_i = R_i
    com_i, cwd_i = (p_i + d_i) - p_i), p_{-1} = 0; and a joint n whose r,
    the last joint's child offset, is 0."""
    zero = (torch.zeros_like(p[0][0]),) * 3
    out = []
    for i in range(c.n):
        d = m_vec(R[i], tuple(float(x) for x in c.com[i]))
        out.append((R[i], axis[i], v_sub(p[i], p[i - 1] if i else zero), d,
                    v_sub(v_add(p[i], d), p[i])))
    return out + [(None, None, zero, None, None)]


def _backward_step(F, N, cwd, rc, fc, nc):
    """The backward recursion at a joint: the child's force fc and moment
    nc (zero below the last joint, whose child offset rc is 0) become this
    joint's."""
    return v_add(F, fc), v_add(v_add(N, nc),
                               v_add(v_cross(cwd, F), v_cross(rc, fc)))


def column_pass(c: Arm3DConsts, frames, j):
    """Column j of M (qd = 0, qdd = e_j, no gravity): every w is zero and
    wd = s_j from joint j on, so a_i = a_{i-1} + s_j x r_i (a_j = 0),
    ac_i = a_i + s_j x d_i and N_i = I_i(s_j); below joint j only the
    child's moment is carried down. Returns [tau_i for i <= j], the upper
    triangle's column j as ``_mass_bias_fused`` keys it."""
    s = frames[j][1]
    zero = (torch.zeros_like(s[0]),) * 3
    a = {j: zero}
    for i in range(j + 1, c.n):
        a[i] = v_add(a[i - 1], v_cross(s, frames[i][2]))
    fc = nc = zero
    taus = [None] * (j + 1)
    for i in range(c.n - 1, -1, -1):
        Ri, s_i, _, d, cwd = frames[i]
        rc = frames[i + 1][2]
        if i >= j:
            F = v_scale(c.mass[i], v_add(a[i], v_cross(s, d)))
            fc, nc = _backward_step(F, _inertia_vec(Ri, c.inertia[i], s),
                                    cwd, rc, fc, nc)
        else:                                   # F = N = 0 below joint j
            nc = v_add(nc, v_cross(rc, fc))
        if i <= j:
            taus[i] = v_dot(s_i, nc)
    return taus


def bias_pass(c: Arm3DConsts, frames, qd):
    """The bias (real qd, qdd = 0, gravity) without its qdd terms."""
    zero = (torch.zeros_like(qd[0]),) * 3
    w = wd = zero
    a = (zero[0], zero[0], torch.full_like(qd[0], c.gravity))
    F, Nn = [], []
    for i in range(c.n):
        Ri, s, r, d, _ = frames[i]
        Ic = c.inertia[i]
        qs = v_scale(qd[i], s)
        a = v_add(a, v_add(v_cross(wd, r), v_cross(w, v_cross(w, r))))
        w, wd = v_add(w, qs), v_add(wd, v_cross(w, qs))
        ac = v_add(a, v_add(v_cross(wd, d), v_cross(w, v_cross(w, d))))
        F.append(v_scale(c.mass[i], ac))
        Nn.append(v_add(_inertia_vec(Ri, Ic, wd),
                        v_cross(w, _inertia_vec(Ri, Ic, w))))
    fc = nc = zero
    bias = [None] * c.n
    for i in range(c.n - 1, -1, -1):
        fc, nc = _backward_step(F[i], Nn[i], frames[i][4], frames[i + 1][2],
                                fc, nc)
        bias[i] = v_dot(frames[i][1], nc)
    return bias


def mass_bias_split(c: Arm3DConsts, R, p, axis, qd):
    """``_mass_bias_fused``'s (M, bias) from the kernel's specialised
    passes."""
    frames = pass_frames(c, R, p, axis)
    M = {}
    for j in range(c.n):
        for i, tau in enumerate(column_pass(c, frames, j)):
            M[(i, j)] = tau
    return M, bias_pass(c, frames, qd)


def _chol_solve3(c: Arm3DConsts, M, rhs):
    """Unrolled Cholesky of (M + reg I) with one 1/sqrt per pivot."""
    n = c.n
    L, inv_d = {}, [None] * n
    for j in range(n):
        s = M[(j, j)] + c.chol_reg
        for k in range(j):
            s = s - L[(j, k)] * L[(j, k)]
        inv = 1.0 / torch.sqrt(s)
        inv_d[j] = inv
        L[(j, j)] = s * inv
        for i in range(j + 1, n):
            t = M[(j, i)]
            for k in range(j):
                t = t - L[(i, k)] * L[(j, k)]
            L[(i, j)] = t * inv
    y = [None] * n
    for i in range(n):
        s = rhs[i]
        for k in range(i):
            s = s - L[(i, k)] * y[k]
        y[i] = s * inv_d[i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[(k, i)] * x[k]
        x[i] = s * inv_d[i]
    return x


def track_target(c: Arm3DConsts, tgt, task):
    """The track task's target orbits world z by track_omega * dt each
    step, before it is scored; the other tasks keep theirs."""
    if c.n_tasks < 2:
        return tgt
    co, so = c.track_cos, c.track_sin
    track = task == 1
    return (torch.where(track, co * tgt[0] - so * tgt[1], tgt[0]),
            torch.where(track, so * tgt[0] + co * tgt[1], tgt[1]), tgt[2])


def push_penalty(c: Arm3DConsts, qd, fk, d):
    """push_weight |v_ee - push_speed dir(to target)|^2 at the post-step
    state, v_ee = sum_i qd_i axis_i x (ee - p_i), d = ee - target."""
    _, p, axis, ee = fk
    v_ee = (torch.zeros_like(ee[0]),) * 3
    for i in range(c.n):
        v_ee = v_add(v_ee, v_scale(qd[i], v_cross(axis[i], v_sub(ee, p[i]))))
    dn = torch.sqrt(v_dot(d, d)) + 1e-6
    dirn = (-d[0] / dn, -d[1] / dn, -d[2] / dn)
    verr = v_sub(v_ee, v_scale(c.push_speed, dirn))
    return c.push_weight * v_dot(verr, verr)


def obstacle_penalty(c: Arm3DConsts, fk):
    """sum of relu(radius - |pt - centre|)^2 over the joint origins after
    the base and the end effector."""
    _, p, _, ee = fk
    oc = c.obstacle_center
    pen = None
    for pt in p[1:] + [ee]:
        dx = pt[0] - oc[0]
        dy = pt[1] - oc[1]
        dz = pt[2] - oc[2]
        dist = torch.sqrt(dx * dx + dy * dy + dz * dz)
        term = torch.clamp(c.obstacle_radius - dist, min=0.0)
        term = term * term
        pen = term if pen is None else pen + term
    return pen


def _step3(c: Arm3DConsts, params, sigma, q, qd, tgt, task, eps_t, cq, sq,
           fk):
    """One env step from (q, qd) with their cos/sin and FK -> the next
    state, its cos/sin and FK, the (rotated) target, this step's obs
    (do, N), act (n, N), reward (N,) and the squared post-step distance
    to the target (N,). Scores in ``_score_step``'s order: target
    rotation, reach and control cost, push term, obstacle term."""
    n = c.n
    R, p, axis, ee = fk
    rows = (cq + sq + [c.qd_obs_scale * x for x in qd]
            + [tgt[0] - ee[0], tgt[1] - ee[1], tgt[2] - ee[2]])
    if c.n_tasks > 1:
        rows += [(task == k).to(ee[0].dtype) for k in range(c.n_tasks)]
    obs = torch.stack(rows)
    act = _policy_mean(params, obs) + sigma * eps_t
    tau = list(torch.clamp(act, -c.torque_limit, c.torque_limit))
    h = c.dt / c.n_substeps
    for s in range(c.n_substeps):
        if s > 0:
            R, p, axis, ee = _fk3(c, cq, sq)
        M, bias = _mass_bias_fused(c, R, p, axis, qd)
        rhs = [tau[i] - bias[i] - c.damping * qd[i] for i in range(n)]
        qdd = _chol_solve3(c, M, rhs)
        qd = [torch.clamp(qd[i] + h * qdd[i], -c.qd_limit, c.qd_limit)
              for i in range(n)]
        q = [q[i] + h * qd[i] for i in range(n)]
        cq = [torch.cos(x) for x in q]
        sq = [torch.sin(x) for x in q]
    tgt = track_target(c, tgt, task)
    fk = _fk3(c, cq, sq)
    d = v_sub(fk[3], tgt)
    ctrl = None
    for i in range(n):
        t2 = tau[i] * tau[i]
        ctrl = t2 if ctrl is None else ctrl + t2
    dist2 = v_dot(d, d)
    rew = -(dist2 + c.ctrl_weight * ctrl)
    if c.n_tasks > 2:
        pen = push_penalty(c, qd, fk, d)
        rew = rew - torch.where(task == 2, pen, torch.zeros_like(pen))
    if c.obstacle_weight > 0.0:
        rew = rew - c.obstacle_weight * obstacle_penalty(c, fk)
    return q, qd, tgt, cq, sq, fk, obs, act, rew, dist2


def start_fresh(c: Arm3DConsts, done, fresh_t, q, qd, tgt, task):
    """Done envs take the fresh episode ``fresh_t`` = (q (N, n), qd (N, n),
    tgt (N, 3), task (N,)); the cos/sin and FK carried into the next
    observation are recomputed from the new q (for every env: the others'
    values come out the same). Returns (q, qd, tgt, task, cq, sq, fk)."""
    q = [torch.where(done, x, y) for x, y in zip(fresh_t[0].T, q)]
    qd = [torch.where(done, x, y) for x, y in zip(fresh_t[1].T, qd)]
    tgt = tuple(torch.where(done, fresh_t[2][:, i], tgt[i]) for i in range(3))
    task = torch.where(done, fresh_t[3].to(task.dtype), task)
    cq = [torch.cos(x) for x in q]
    sq = [torch.sin(x) for x in q]
    return q, qd, tgt, task, cq, sq, _fk3(c, cq, sq)


def rollout3d_plain(cfg, params, q0, qd0, tgt, task, eps, fresh=None):
    """q0/qd0 (N, n), tgt (N, 3), task (N,) int, eps (T, N, n) -> obs_ff
    (T, do, N), act_ff (T, n, N), rew_ff (T, N), all fp32, and, when
    ``cfg.done_dist > 0``, the done flags (T, N); ``fresh`` (q, qd, tgt,
    task) with a leading T axis holds the episodes that done envs
    start."""
    rollout3d_plain.calls += 1
    c = arm3d_consts(cfg)
    term = c.done_dist > 0.0
    if term and fresh is None:
        raise ValueError("a terminating config needs the fresh episodes")
    sigma = torch.exp(params["logstd"])[:, None]
    q, qd = list(q0.T), list(qd0.T)
    tg = (tgt[:, 0], tgt[:, 1], tgt[:, 2])
    cq = [torch.cos(x) for x in q]
    sq = [torch.sin(x) for x in q]
    fk = _fk3(c, cq, sq)
    if term:
        dd2 = torch.tensor(done_dist2(c), dtype=q0.dtype, device=q0.device)
    obs_t, act_t, rew_t, done_t = [], [], [], []
    for t in range(eps.shape[0]):
        q, qd, tg, cq, sq, fk, obs, act, rew, dist2 = _step3(
            c, params, sigma, q, qd, tg, task, eps[t].T, cq, sq, fk)
        obs_t.append(obs)
        act_t.append(act)
        rew_t.append(rew)
        if term:            # a done env starts the fresh episode of row t
            done = dist2 < dd2
            done_t.append(done.to(q0.dtype))
            q, qd, tg, task, cq, sq, fk = start_fresh(
                c, done, [x[t] for x in fresh], q, qd, tg, task)
    out = (torch.stack(obs_t), torch.stack(act_t), torch.stack(rew_t))
    return out + (torch.stack(done_t),) if term else out


rollout3d_plain.calls = 0


# ------------------------------------------------------------- wrapper

def _consts_array(c: Arm3DConsts):
    vals = []
    for i in range(c.n):
        vals += [x for row in c.T_rot[i] for x in row]
    for i in range(c.n):
        vals += list(c.T_pos[i])
    vals += list(c.mass)
    for i in range(c.n):
        vals += list(c.com[i])
    for i in range(c.n):
        vals += [x for row in c.inertia[i] for x in row]
    vals += list(c.ee_offset)
    vals += [c.gravity, c.damping, c.dt / c.n_substeps, c.torque_limit,
             c.qd_limit, c.qd_obs_scale, c.ctrl_weight, c.chol_reg,
             c.track_cos, c.track_sin, c.push_speed, c.push_weight,
             c.obstacle_weight, c.obstacle_radius, *c.obstacle_center,
             done_dist2(c), c.q0_noise, c.qd0_noise, c.rmin, c.rmax,
             float(c.planar)]
    return (ctypes.c_float * len(vals))(*vals)


def rollout3d(cfg, params, q0, qd0, tgt, task, eps=None, seed=None,
              store_dtype=torch.float32, fresh=None):
    """Fused 3-D rollout: q0/qd0 (N, n), tgt (N, 3), task (N,) int, and
    either eps (T, N, n) (with ``fresh`` when the config terminates) or
    seed (int64 (2,) on the device) -> obs_ff (T, do, N) and act_ff
    (T, n, N) in ``store_dtype``, rew_ff (T, N) fp32 and, when
    ``cfg.done_dist > 0``, dones (T, N) fp32."""
    c = arm3d_consts(cfg)
    term = c.done_dist > 0.0
    check_fresh(term, eps, fresh)
    check_store(store_dtype)
    if not q0.is_cuda:
        if eps is None:
            raise ValueError("Philox noise runs only in the CUDA kernel; "
                             "pass eps on the CPU")
        out = rollout3d_plain(cfg, params, q0, qd0, tgt, task, eps, fresh)
        return (out[0].to(store_dtype), out[1].to(store_dtype)) + out[2:]
    N, n = q0.shape
    T = cfg.horizon
    do = cfg.obs_dim
    dev = q0.device
    hidden = build.hidden_shape(params, "rollout3d")
    if params["W0"].shape[0] != do:
        raise ValueError(f"W0 takes {params['W0'].shape[0]} inputs, the "
                         f"observation has {do}")
    check_instantiated(c)
    if (eps is None) == (seed is None):
        raise ValueError("pass exactly one of eps and seed")
    ins = dict(q0=q0.T, qd0=qd0.T, tgt=tgt.T, **params)
    ins = {k: v.to(torch.float32).contiguous() for k, v in ins.items()}
    ins["task"] = task.to(torch.int32).contiguous()
    if ins["task"].shape != (N,):
        raise ValueError(f"task must be ({N},)")
    for k, v in ins.items():
        if v.device != dev:
            raise ValueError(f"{k} is on {v.device}, the batch on {dev}")
    if eps is not None:
        if eps.shape != (T, N, n) or eps.device != dev:
            raise ValueError(f"eps must be ({T}, {N}, {n}) on {dev}")
        eps_ff = eps.to(torch.float32).permute(0, 2, 1).contiguous()
        eps_p, seed_p = build.ptr(eps_ff), ctypes.c_void_p(None)
    else:
        if (seed.dtype != torch.int64 or seed.numel() != 2
                or seed.device != dev):
            raise ValueError("seed must be an int64 (2,) tensor on the device")
        eps_p, seed_p = ctypes.c_void_p(None), build.ptr(seed)
    fresh_ff = [None] * 4
    if fresh is not None:
        ftask = fresh[3].to(torch.int32).contiguous()
        if ftask.shape != (T, N) or ftask.device != dev:
            raise ValueError(f"fresh task must be ({T}, {N}) on {dev}")
        fresh_ff = fresh_feature_first(fresh, T, N, n, dev, 3) + [ftask]
    obs = torch.empty(T, do, N, device=dev, dtype=store_dtype)
    act = torch.empty(T, n, N, device=dev, dtype=store_dtype)
    rew = torch.empty(T, N, device=dev)
    dones = torch.empty(T, N, device=dev) if term else None
    opt = lambda x: build.ptr(x) if x is not None else ctypes.c_void_p(None)
    lib = build.library(build.lib_name("rollout3d", n, hidden), _SIG)
    hid, n_hid, weights = build.policy_args(ins, hidden)
    err = lib.trpo_rollout3d_launch(
        _consts_array(c), n, c.n_substeps, c.n_tasks,
        int(c.obstacle_weight > 0.0), int(term),
        int(store_dtype == torch.bfloat16), hid, n_hid,
        *(build.ptr(ins[k]) for k in ("q0", "qd0", "tgt", "task")),
        weights, eps_p, seed_p, *(opt(x) for x in fresh_ff), build.ptr(obs),
        build.ptr(act), build.ptr(rew), opt(dones), N, T,
        build.stream_handle(dev))
    build.check(err, "3-D rollout kernel")
    rollout3d.launches += 1
    return (obs, act, rew, dones) if term else (obs, act, rew)


rollout3d.launches = 0


def check_instantiated(c: Arm3DConsts) -> None:
    """Raises NotImplementedError for an arm or task mix the kernel has no
    instantiation for: past ``JOINT_COUNTS`` (ROADMAP B3) or outside
    ``TASK_FAMILIES``."""
    check_joints(c.n, "3-D rollout kernel")
    if c.n_tasks not in TASK_FAMILIES:
        raise NotImplementedError(
            f"the 3-D rollout kernel scores {TASK_FAMILIES} task families, "
            f"not {c.n_tasks}")


def occupancy(cfg, store_dtype=torch.float32, hidden=build.DEFAULT_HIDDEN
              ) -> dict:
    """What the card makes of the kernel instantiation ``cfg``,
    ``store_dtype`` and the policy's ``hidden`` widths launch: resident
    blocks and warps per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
    registers and local (spill) bytes per thread, dynamic and static shared
    bytes per block."""
    c = arm3d_consts(cfg)
    check_instantiated(c)
    check_store(store_dtype)
    hidden = build.check_hidden(hidden, "rollout3d")
    out = (ctypes.c_int * 6)()
    err = build.library(build.lib_name("rollout3d", c.n, hidden),
                        _SIG).trpo_rollout3d_occupancy(
        c.n, c.n_tasks, int(c.obstacle_weight > 0.0), int(c.done_dist > 0.0),
        int(store_dtype == torch.bfloat16), out)
    build.check(err, "3-D rollout kernel occupancy")
    blocks, regs, local, dyn, static, threads = out
    return dict(blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
                registers=regs, local_bytes=local, smem_dynamic=dyn,
                smem_static=static, threads=threads)
