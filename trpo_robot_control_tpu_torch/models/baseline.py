"""Value baselines (port of ``trpo_robot_control_tpu/models/baseline.py``).

The linear one: ridge regression on phi(s, t) = [obs, obs^2, t/h, (t/h)^2,
(t/h)^3, 1], solved from the normal equations with a Jacobi-scaled
eigendecomposition. The MLP one: a tanh MLP on the same features, refit
each update by a fixed number of full-batch Adam steps (warm-started, the
moments fresh every refit). Everything is fp32 with TF32 off
(``device.resolve``); none of it is a kernel in the JAX package either
(the card's ridge solve is a kernel of the port's own, ``fit_normal``).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..parallel.collectives import pmean, psum


def n_features(obs_dim: int) -> int:
    return 2 * obs_dim + 4


def features(obs, horizon: int):
    """obs (N, T, do) -> phi (N, T, F)."""
    N, T, do = obs.shape
    tau = _time_features(T, horizon, obs.device).to(obs.dtype)
    return torch.cat([obs, obs ** 2, tau.expand(N, T, 4)], dim=-1)


def _time_features(T, horizon, device):
    """tau (T, 4) = [t, t^2, t^3, 1] in units of t/horizon."""
    t = torch.arange(T, dtype=torch.float32, device=device) / horizon
    return torch.stack([t, t * t, t * t * t, torch.ones_like(t)], dim=1)


def values_ff(w, obs_ff, horizon: int):
    """Baseline values without materialising phi: obs_ff (T, do, N) ->
    (T, N). Only the obs/obs^2 contractions touch the batch.

    A bf16 obs_ff follows the JAX package's rounding points: obs^2 is
    formed in bf16, the weights w_o/w_q are rounded to bf16, the
    contractions accumulate fp32 and the time term stays fp32."""
    T, do, N = obs_ff.shape
    dt = obs_ff.dtype
    w_o, w_q, w_t = w[:do], w[do:2 * do], w[2 * do:]
    return (torch.einsum("tdn,d->tn", obs_ff.float(), w_o.to(dt).float())
            + torch.einsum("tdn,d->tn", (obs_ff * obs_ff).float(),
                           w_q.to(dt).float())
            + (_time_features(T, horizon, obs_ff.device) @ w_t)[:, None])


def data_rows(obs_ff, targets_tn):
    """v = [obs; obs^2; y] (T, 2do+1, N) in fp32, with obs^2 and y rounded
    to the storage dtype of obs_ff (bf16 or fp32) as the JAX package
    rounds them."""
    dt = obs_ff.dtype
    return torch.cat([obs_ff, obs_ff * obs_ff,
                      targets_tn[:, None, :].to(dt)], dim=1).float()


def normal_eq_ff(obs_ff, targets_tn, horizon: int):
    """Normal-equation moments (A (F, F), b (F,)) straight from the kernel
    layout, in the features() order [obs, obs^2, t, t^2, t^3, 1].

    The data blocks come from one Gram of v = [obs, obs^2, y]; the time
    features are constant across envs, so their cross block is one (T, 4)
    contraction and their own block the exact N * tau^T tau, both fp32.
    This is the reference form the moments kernel
    (``ops/cuda/moments_kernel.py``) is held against."""
    T, do, N = obs_ff.shape
    tau = _time_features(T, horizon, obs_ff.device)          # (T, 4)
    v = data_rows(obs_ff, targets_tn)
    G = torch.einsum("tfn,tgn->fg", v, v)
    C = torch.einsum("tfn,tk->fk", v, tau)
    return assemble(G, C, tau, N, do)


def assemble(G, C, tau, N, do):
    """(A, b) from the v-Gram G (2do+1)^2 and the time cross block C
    (2do+1, 4); the A_tt block is the exact fp32 N * tau^T tau."""
    F = 2 * do + 4
    A = torch.empty(F, F, dtype=torch.float32, device=G.device)
    A[:2 * do, :2 * do] = G[:2 * do, :2 * do]
    A[:2 * do, 2 * do:] = C[:2 * do]
    A[2 * do:, :2 * do] = C[:2 * do].T
    A[2 * do:, 2 * do:] = N * (tau.T @ tau)
    b = torch.cat([G[:2 * do, 2 * do], C[2 * do]])
    return A, b


def predict(w, phi):
    return phi @ w


def fit(phi_flat, targets_flat, reg: float, axis_name=None):
    """Solve (phi^T phi + reg I) w = phi^T y (``fit_moments``)."""
    return fit_moments(phi_flat.T @ phi_flat, phi_flat.T @ targets_flat,
                       reg, axis_name)


def fit_moments(A, b, reg: float, axis_name=None):
    """Solve (A + reg I) w = b (``fit_normal``). ``axis_name`` (the mesh's
    'data' process group): A and b are summed over the ranks first, since
    adding the ridge on each rank would add it world-size times."""
    A, b = psum((A, b), axis_name)
    A = A + reg * torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    return fit_normal(A, b)


def fit_normal(A, b, eps: float = 1e-20, rel_floor: float = 1e-6):
    """Solve the ridge-regularised normal equations robustly at fp32.

    Jacobi scaling D^-1/2 A D^-1/2, then an eigendecomposition solve that
    drops directions with lambda < rel_floor * lambda_max. A bare fp32
    Cholesky fails near convergence, where cond(A) reaches ~1e8, and the
    resulting NaN weights freeze training. A non-finite fit degrades to a
    zero baseline for one iteration. On the card the solve is one launch
    of the fit_normal kernel, which reads nothing back to the host (a
    CUDA graph of the train step captures it); on the CPU it is the eigh
    solve, ``ops/cuda/fit_kernel.fit_normal_plain``."""
    # imported here: ops.cuda imports this module (the moments kernel)
    from ..ops.cuda import fit_kernel
    return fit_kernel.fit_normal(A, b, eps, rel_floor)


# ----------------------------------------------------------------- MLP

def init_mlp(gen: torch.Generator, n_in: int, hidden):
    """Weights W_i ~ N(0, 2 / m) (m the layer's fan-in), zero biases, keys
    ``W0..WL, b0..bL``; drawn from ``gen`` on its own device."""
    dev = gen.device
    dims = [n_in] + list(hidden) + [1]
    w = {}
    for i, (m, n) in enumerate(zip(dims[:-1], dims[1:])):
        w[f"W{i}"] = torch.randn(m, n, generator=gen, device=dev) \
            * math.sqrt(2.0 / m)
        w[f"b{i}"] = torch.zeros(n, device=dev)
    return w


def predict_mlp(w, phi):
    """phi (..., F) -> values (...)."""
    L = sum(1 for k in w if k.startswith("W"))
    h = phi
    for i in range(L - 1):
        h = torch.tanh(h @ w[f"W{i}"] + w[f"b{i}"])
    return (h @ w[f"W{L - 1}"] + w[f"b{L - 1}"])[..., 0]


def fit_mlp(w, phi_flat, targets_flat, lr: float, steps: int,
            axis_name=None):
    """``steps`` full-batch Adam steps on the MSE from ``w``, with fresh
    moments. The JAX package's update rule, step t = i + 1:
    p -= lr sqrt(1 - b2^t) / (1 - b1^t) m / (sqrt(v) + eps), its scale
    formed in fp32 as there (``torch.optim.Adam`` adds eps elsewhere). A
    weight whose refit is not finite keeps its old value. ``axis_name``
    (the mesh's 'data' process group): the gradients are averaged over the
    ranks at every step, before the moments, so every rank applies the
    same update and the guard acts on the same values."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    keys = sorted(w)
    old = [w[k].detach() for k in keys]
    p = [x.clone() for x in old]
    m = [torch.zeros_like(x) for x in p]
    v = [torch.zeros_like(x) for x in p]
    f32 = np.float32
    for i in range(steps):
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_(True) for x in p]
            loss = torch.mean((predict_mlp(dict(zip(keys, leaves)), phi_flat)
                               - targets_flat) ** 2)
            g = pmean(torch.autograd.grad(loss, leaves), axis_name)
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, g, alpha=1.0 - b1)
        torch._foreach_mul_(v, b2)
        torch._foreach_addcmul_(v, g, g, value=1.0 - b2)
        t = f32(i + 1)
        scale = np.sqrt(f32(1.0) - f32(b2) ** t) / (f32(1.0) - f32(b1) ** t)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, eps)
        torch._foreach_addcdiv_(p, m, denom, value=-float(f32(lr) * scale))
    return {k: torch.where(torch.isfinite(new), new, o)
            for k, new, o in zip(keys, p, old)}
