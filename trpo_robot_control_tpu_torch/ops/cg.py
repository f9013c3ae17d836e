"""Conjugate gradient (port of ``trpo_robot_control_tpu/ops/cg.py``):
a fixed number of iterations from x0 = 0, no host synchronisation.

Operands are flat fp32 vectors. On the tensor-parallel path
(``parallel/tensor.py``) each rank's vector is its local shard, the
sharded leaves' slices beside the replicated ones in sorted-key order, and
``vdot`` is the global inner product (a sum over the 'model' group for the
sharded part, as JAX's ``vdot`` argument); the FVP callee does any other
cross-rank reduction itself, so the recurrences run no other collective.
"""
from __future__ import annotations

import torch


def conjugate_gradient(fvp, g, iters: int, eps: float = 1e-12, vdot=None):
    """Solve F x = g. Returns (x, final residual r, residual norm^2).
    ``vdot``: the inner product, ``torch.dot`` when None.

    F x = g - r exactly (CG invariant), so the caller gets the curvature
    x^T F x = x.g - x.r without another FVP call.
    """
    dot = torch.dot if vdot is None else vdot
    x = torch.zeros_like(g)
    r = g
    p = g
    rdotr = dot(g, g)
    for _ in range(iters):
        z = fvp(p)
        alpha = rdotr / (dot(p, z) + eps)
        x = x + alpha * p
        r = r - alpha * z
        new_rdotr = dot(r, r)
        p = r + (new_rdotr / (rdotr + eps)) * p
        rdotr = new_rdotr
    return x, r, rdotr
