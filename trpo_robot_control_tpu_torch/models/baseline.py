"""Linear-feature value baseline (port of the linear path of
``trpo_robot_control_tpu/models/baseline.py``).

Ridge regression on phi(s, t) = [obs, obs^2, t/h, (t/h)^2, (t/h)^3, 1],
solved from the normal equations with a Jacobi-scaled eigendecomposition.
Everything is fp32 with TF32 off (``device.resolve``).
"""
from __future__ import annotations

import torch


def n_features(obs_dim: int) -> int:
    return 2 * obs_dim + 4


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


def fit_normal(A, b, eps: float = 1e-20, rel_floor: float = 1e-6):
    """Solve the ridge-regularised normal equations robustly at fp32.

    Jacobi scaling D^-1/2 A D^-1/2, then an eigendecomposition solve that
    drops directions with lambda < rel_floor * lambda_max. A bare fp32
    Cholesky fails near convergence, where cond(A) reaches ~1e8, and the
    resulting NaN weights freeze training. A non-finite fit degrades to a
    zero baseline for one iteration."""
    d = torch.sqrt(torch.diagonal(A) + eps)
    A_s = A / (d[:, None] * d[None, :])
    lam, Q = torch.linalg.eigh(A_s)
    inv = torch.where(lam > rel_floor * lam[-1], 1.0 / lam,
                      torch.zeros_like(lam))
    w_s = Q @ (inv * (Q.T @ (b / d)))
    w = w_s / d
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))
