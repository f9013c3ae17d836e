"""Conjugate gradient (port of ``trpo_robot_control_tpu/ops/cg.py``):
a fixed number of iterations from x0 = 0, no host synchronisation.
"""
from __future__ import annotations

import torch


def conjugate_gradient(fvp, g, iters: int, eps: float = 1e-12):
    """Solve F x = g. Returns (x, final residual r, residual norm^2).

    F x = g - r exactly (CG invariant), so the caller gets the curvature
    x^T F x = x.g - x.r without another FVP call.
    """
    x = torch.zeros_like(g)
    r = g
    p = g
    rdotr = torch.dot(g, g)
    for _ in range(iters):
        z = fvp(p)
        alpha = rdotr / (torch.dot(p, z) + eps)
        x = x + alpha * p
        r = r - alpha * z
        new_rdotr = torch.dot(r, r)
        p = r + (new_rdotr / (rdotr + eps)) * p
        rdotr = new_rdotr
    return x, r, rdotr
