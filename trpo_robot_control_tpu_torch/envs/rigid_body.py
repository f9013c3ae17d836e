"""Rigid-body dynamics for fixed-base serial arms on batched tensors (port
of ``trpo_robot_control_tpu/envs/rigid_body.py``).

World-frame recursive Newton-Euler, written generically over the link
count: forward kinematics, inverse dynamics, the mass matrix by one RNEA
column per joint, the bias, a regularised Cholesky forward-dynamics solve
and the semi-implicit Euler step. Every function takes tensors with any
leading batch dimensions.

This is the generic path that the 7-DoF rollout's component math
(``ops/cuda/rollout3d_kernel.py``) is checked against. The arm constants
are rounded to float32 in numpy exactly as the JAX package rounds them,
so both packages and the kernel see the same literals.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _rpy_matrix(rpy):
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return (Rz @ Ry @ Rx).astype(np.float32)


class ArmConstants:
    """Per-arm constants derived once from an ArmSpec (cached by spec)."""

    _cache: dict = {}

    def __new__(cls, spec):
        if spec not in cls._cache:
            obj = super().__new__(cls)
            obj._init(spec)
            cls._cache[spec] = obj
        return cls._cache[spec]

    def _init(self, spec):
        self.spec = spec
        self.n = spec.n_joints
        self.T_rot = [_rpy_matrix(j.rpy) for j in spec.joints]
        self.T_pos = [np.asarray(j.pos, np.float32) for j in spec.joints]
        self.mass = [float(lk.mass) for lk in spec.links]
        self.com = [np.asarray(lk.com, np.float32) for lk in spec.links]
        self.inertia = [np.diag(lk.inertia_diag).astype(np.float32)
                        for lk in spec.links]
        self.ee_offset = np.asarray(spec.ee_offset, np.float32)
        self.planar = all(np.allclose(j.rpy, 0.0) for j in spec.joints)


def _const(x, like):
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _mv(R, v):
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, v)


def _rot_z(q):
    c, s = torch.cos(q), torch.sin(q)
    z, o = torch.zeros_like(q), torch.ones_like(q)
    return torch.stack([torch.stack([c, -s, z], -1),
                        torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def fk(spec, q):
    """Forward kinematics. q (..., n) -> (R list, p list, ee (..., 3)):
    R[i] (..., 3, 3) is link i's world rotation, p[i] (..., 3) its joint
    origin."""
    c = ArmConstants(spec)
    batch = q.shape[:-1]
    R_par = torch.eye(3, dtype=q.dtype, device=q.device).expand(*batch, 3, 3)
    p_par = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)
    R, p = [], []
    for i in range(c.n):
        p_i = p_par + _mv(R_par, _const(c.T_pos[i], q))
        R_i = R_par @ _const(c.T_rot[i], q) @ _rot_z(q[..., i])
        R.append(R_i)
        p.append(p_i)
        R_par, p_par = R_i, p_i
    ee = p[-1] + _mv(R[-1], _const(c.ee_offset, q))
    return R, p, ee


def rnea(spec, q, qd, qdd, gravity=None, fk_cache=None):
    """Inverse dynamics tau = ID(q, qd, qdd), batched over leading dims.
    ``fk_cache=(R, p)`` shares one FK across several passes."""
    c = ArmConstants(spec)
    g = spec.gravity if gravity is None else gravity
    R, p = fk(spec, q)[:2] if fk_cache is None else fk_cache
    batch = q.shape[:-1]
    z_hat = _const([0.0, 0.0, 1.0], q)
    zeros3 = torch.zeros(*batch, 3, dtype=q.dtype, device=q.device)
    w_par, wd_par = zeros3, zeros3
    a_par = _const([0.0, 0.0, g], q).expand(*batch, 3)
    R_par = torch.eye(3, dtype=q.dtype, device=q.device).expand(*batch, 3, 3)
    cross = torch.linalg.cross

    axis, w, wd, ac, cw, pj = [], [], [], [], [], []
    for i in range(c.n):
        s = _mv(R_par @ _const(c.T_rot[i], q), z_hat.expand(*batch, 3))
        r = _mv(R_par, _const(c.T_pos[i], q).expand(*batch, 3))
        a_i = a_par + cross(wd_par, r) + cross(w_par, cross(w_par, r))
        w_i = w_par + s * qd[..., i:i + 1]
        wd_i = (wd_par + s * qdd[..., i:i + 1]
                + cross(w_par, s * qd[..., i:i + 1]))
        d = _mv(R[i], _const(c.com[i], q).expand(*batch, 3))
        ac_i = a_i + cross(wd_i, d) + cross(w_i, cross(w_i, d))
        axis.append(s)
        w.append(w_i)
        wd.append(wd_i)
        ac.append(ac_i)
        cw.append(p[i] + d)
        pj.append(p[i])
        w_par, wd_par, a_par, R_par = w_i, wd_i, a_i, R[i]

    taus = [None] * c.n
    f_child = n_child = p_child = zeros3
    for i in range(c.n - 1, -1, -1):
        I_w = R[i] @ _const(c.inertia[i], q) @ R[i].transpose(-1, -2)
        F = c.mass[i] * ac[i]
        N = _mv(I_w, wd[i]) + cross(w[i], _mv(I_w, w[i]))
        f = F + f_child
        nn = (N + n_child + cross(cw[i] - pj[i], F)
              + cross(p_child - pj[i], f_child))
        taus[i] = torch.sum(axis[i] * nn, dim=-1)
        f_child, n_child, p_child = f, nn, pj[i]
    return torch.stack(taus, dim=-1)


def mass_matrix(spec, q, fk_cache=None):
    """M(q) by CRBA-via-RNEA: column j = ID(q, 0, e_j, g=0)."""
    n = ArmConstants(spec).n
    zero = torch.zeros_like(q)
    eye = torch.eye(n, dtype=q.dtype, device=q.device)
    if fk_cache is None:
        fk_cache = fk(spec, q)[:2]
    M = torch.stack([rnea(spec, q, zero, eye[j].expand_as(q), gravity=0.0,
                          fk_cache=fk_cache) for j in range(n)], dim=-1)
    return 0.5 * (M + M.transpose(-1, -2))


def bias(spec, q, qd, fk_cache=None):
    """C(q, qd) qd + g(q), without joint damping."""
    return rnea(spec, q, qd, torch.zeros_like(q), fk_cache=fk_cache)


def forward_dynamics(spec, q, qd, tau, chol_reg: float = 1e-6):
    """qdd = M^-1 (tau - bias - damping qd) by a batched Cholesky solve;
    one FK shared by the n + 1 RNEA passes."""
    n = ArmConstants(spec).n
    R, p, _ = fk(spec, q)
    M = mass_matrix(spec, q, fk_cache=(R, p)) \
        + chol_reg * torch.eye(n, dtype=q.dtype, device=q.device)
    b = bias(spec, q, qd, fk_cache=(R, p)) + spec.joint_damping * qd
    L = torch.linalg.cholesky(M)
    return torch.cholesky_solve((tau - b)[..., None], L)[..., 0]


def dynamics_step(spec, q, qd, tau):
    """Semi-implicit Euler over n_substeps with the velocity clip."""
    h = spec.dt / spec.n_substeps
    for _ in range(spec.n_substeps):
        qdd = forward_dynamics(spec, q, qd, tau)
        qd = torch.clamp(qd + h * qdd, -spec.qd_limit, spec.qd_limit)
        q = q + h * qd
    return q, qd
