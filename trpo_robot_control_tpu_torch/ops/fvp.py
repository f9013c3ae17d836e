"""Fisher-vector products (port of ``trpo_robot_control_tpu/ops/fvp.py``).

``make_gn_fvp``, the Gauss-Newton form: F v = (1/B) sum_b J_b^T M J_b v +
damping v, with J = d(mu, logstd)/dtheta and M = diag(1/sigma^2, 2I): one
forward tangent and one reverse pass per call. The hidden activations, the
bf16 planes of the hidden-to-hidden weights that the kernel reads and its
scratch are made once per update and reused by every CG call. Each call
goes through the FVP kernel's wrapper (``ops/cuda/fvp_kernel.py``), which
launches the CUDA kernel on a GPU tensor and runs the plain PyTorch
version of the same math on a CPU one.

``make_kl_fvp``, the KL-Hessian form, the GN form's twin at theta =
theta_old: the Hessian of the mean KL(old || new) at new = old applied to
v. The JAX package computes it outside any Pallas kernel (``jax.jvp`` of
``jax.grad``), so here it is plain PyTorch on either device, a double
backward; it is a reference form, not a kernel.

Under data parallelism (``axis_name``, the mesh's 'data' process group)
each rank's F v, on its own envs, is averaged over the ranks in every
call, as the JAX package's ``pmean``. The KL form averages before adding
``damping * v``, as JAX; the kernels add it themselves, and every rank's v
is the same, so the mean of (F_r v + d v) is mean(F_r v) + d v and no
kernel changes.
"""
from __future__ import annotations

import torch

from ..models import policy
from ..parallel.collectives import pmean
from .cuda import fvp_kernel


def make_gn_fvp(params, obs, damping: float, axis_name=None):
    """obs: (B, do). Returns fvp(v_flat) -> flat damped Fv."""
    B = obs.shape[0]
    hs = fvp_kernel.activations(params, obs)
    scale = torch.exp(-2.0 * params["logstd"]) / B
    ws = fvp_kernel.workspace(params, obs)

    def fvp(v_flat):
        return pmean(fvp_kernel.gn_fvp(params, obs, hs, scale, v_flat, damping,
                                       ws), axis_name)

    return fvp


def make_kl_fvp(params, obs, damping: float, axis_name=None):
    """obs: (B, do). Returns fvp(v_flat) -> the flat H v + damping v, H the
    Hessian of the mean KL(old || new) over obs at new = old, mu_old and
    logstd_old held fixed; each call counts in ``make_kl_fvp.calls``."""
    keys = sorted(params)
    with torch.enable_grad():
        leaves = [params[k].detach().requires_grad_(True) for k in keys]
        p = dict(zip(keys, leaves))
        mu, logstd = policy.dist(p, obs)
        kl = policy.kl(mu.detach(), logstd.detach(), mu, logstd)
        grad = torch.cat([g.reshape(-1) for g in torch.autograd.grad(
            kl, leaves, create_graph=True)])

    def fvp(v_flat):
        make_kl_fvp.calls += 1
        with torch.enable_grad():
            hv = torch.autograd.grad(grad, leaves, grad_outputs=v_flat,
                                     retain_graph=True)
        return pmean(torch.cat([h.reshape(-1) for h in hv]), axis_name) \
            + damping * v_flat

    return fvp


make_kl_fvp.calls = 0
