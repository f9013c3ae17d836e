"""The TRPO natural-gradient update (port of the feature-first branch of
``trpo_robot_control_tpu/trpo/update.py``, as c1 and c2 run it).

values -> GAE -> whitening -> baseline moments (K2) -> ridge fit ->
closed-form surrogate gradient -> CG on the damped GN-FVP (K3) over the
time-strided Fisher subsample -> step size from the CG invariant ->
KL line search over the full batch. Every step stays on the device; the
only host synchronisation is the caller's read of the stats. Each layer
runs under a ``record_function`` range (``trpo/...``) that
``cli/profile.py`` reads; outside a profiler a range costs about a
microsecond of host time.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models import baseline, policy
from ..ops.cg import conjugate_gradient
from ..ops.cuda.moments_kernel import baseline_moments
from ..ops.fvp import make_gn_fvp
from ..ops.gae import gae
from ..ops.linesearch import line_search


def _check_supported(cfg, batch, axis_name):
    tr = cfg.trpo
    later = [
        (tr.baseline == "mlp", "the MLP baseline comes with slice 3"),
        (tr.fvp_env_subsample > 1,
         "fvp_env_subsample > 1 comes with slice 3 (c4/c5)"),
        (tr.ls_subsample > 1, "ls_subsample > 1 comes with slice 2 (c3)"),
        (tr.ff_store_dtype != "f32", "bf16 storage comes with slice 2 (c3)"),
        (axis_name is not None, "data parallelism comes with slice 4"),
        ("obs_ff" not in batch or "actions_ff" not in batch,
         "the batch-major update path comes with slice 4; pass a batch "
         "from the rollout kernel (obs_ff/actions_ff/rewards_ff)"),
    ]
    for cond, msg in later:
        if cond:
            raise NotImplementedError(msg)


def _eval_candidates(params, thetas, obs_ff, act_ff, adv, mu_old, logp_old,
                     logstd_old):
    """Surrogate and mean KL of K candidate parameter vectors (K, P) in
    one batched forward pass over the (T, d, N) batch -> ((K,), (K,))."""
    p = policy.unflatten(thetas, params)
    L = policy.n_layers(params)
    h = torch.tanh(torch.einsum("kio,tin->kton", p["W0"], obs_ff)
                   + p["b0"][:, None, :, None])
    for i in range(1, L - 1):
        h = torch.tanh(torch.einsum("kio,ktin->kton", p[f"W{i}"], h)
                       + p[f"b{i}"][:, None, :, None])
    mu = torch.einsum("kio,ktin->kton", p[f"W{L - 1}"], h) \
        + p[f"b{L - 1}"][:, None, :, None]                  # (K, T, da, N)
    logstd = p["logstd"]                                     # (K, da)
    da = logstd.shape[1]
    z = (act_ff[None] - mu) * torch.exp(-logstd)[:, None, :, None]
    logp = -0.5 * (torch.sum(z ** 2, dim=2)
                   + 2.0 * torch.sum(logstd, dim=1)[:, None, None]
                   + da * policy.LOG2PI)                     # (K, T, N)
    surr = torch.mean(torch.exp(logp - logp_old[None]) * adv[None],
                      dim=(1, 2))
    var_old = torch.exp(2.0 * logstd_old)
    var_new = torch.exp(2.0 * logstd)
    quad = torch.mean(torch.sum((mu_old[None] - mu) ** 2
                                / (2.0 * var_new)[:, None, :, None], dim=2),
                      dim=(1, 2))
    const = torch.sum(logstd - logstd_old + var_old / (2.0 * var_new) - 0.5,
                      dim=1)
    return surr, quad + const


def trpo_update(cfg, params, w, batch, axis_name=None,
                return_directions: bool = False):
    """One TRPO update on a batch from the rollout kernel (obs_ff
    (T, do, N), actions_ff (T, da, N), rewards_ff (T, N) and the batch-major
    obs (N, T, do)). Returns (new_params, new_w, stats)."""
    _check_supported(cfg, batch, axis_name)
    tr = cfg.trpo
    obs_ff, act_ff = batch["obs_ff"], batch["actions_ff"]
    rewards_tn = batch["rewards_ff"]
    T, do, N = obs_ff.shape

    # ---- 1) values (old baseline) -> GAE -> whiten -> targets -> refit
    with record_function("trpo/values_gae"):
        values = baseline.values_ff(w, obs_ff, cfg.horizon)         # (T, N)
        adv_raw = gae(rewards_tn, values, tr.gamma, tr.lam,
                      dones=batch.get("dones_ff"), time_axis=0)
        m1 = torch.mean(adv_raw)
        m2 = torch.mean(adv_raw ** 2)
        std = torch.sqrt(torch.clamp(m2 - m1 ** 2, min=0.0))
        adv = (adv_raw - m1) / (std + 1e-8)
        targets = adv_raw + values
    with record_function("trpo/baseline_fit"):
        A, b_vec = baseline_moments(obs_ff, targets, cfg.horizon)
        A = A + tr.baseline_reg * torch.eye(A.shape[0], device=A.device)
        w_new = baseline.fit_normal(A, b_vec)

    # ---- 2) closed-form surrogate gradient at theta_old
    with record_function("trpo/surrogate_grad"):
        g_tree, mu_old_ff, logp_old_ff = policy.surrogate_grad_ff(
            params, obs_ff, act_ff, adv)
        theta_old = policy.flatten(params)
        g = policy.flatten(g_tree)
        surr_old = torch.mean(adv)                             # ratio == 1

    # ---- 3) CG on the damped GN-FVP over the Fisher subsample. The time
    # stride over (T, do, N) selects the same samples as obs_f[::k] when
    # T % k == 0; only the subsample is relaid to (B / k, do).
    k = tr.fvp_subsample
    if k > 1:
        if T % k:
            raise ValueError("the feature-first fvp_subsample matches "
                             "obs_f[::k] only when horizon % fvp_subsample "
                             f"== 0; got T={T}, k={k}")
        obs_fvp = obs_ff[::k].permute(0, 2, 1).reshape(-1, do)
    else:
        obs_fvp = batch["obs"].reshape(-1, do)
    with record_function("trpo/cg_fvp"):
        fvp = make_gn_fvp(params, obs_fvp, tr.cg_damping)
        x, r_final, cg_residual = conjugate_gradient(fvp, g, tr.cg_iters)
        # ---- 4) step size: F x = g - r (CG invariant): x^T F x = x.g - x.r
        xhx = torch.dot(x, g) - torch.dot(x, r_final)
        beta = torch.sqrt(2.0 * tr.delta / (xhx + 1e-12))

    # ---- 5) KL line search on the full batch
    def eval_fn(thetas):
        return _eval_candidates(params, thetas, obs_ff, act_ff, adv,
                                mu_old_ff, logp_old_ff, params["logstd"])

    with record_function("trpo/line_search"):
        theta_new, accepted, kl_new, surr_new = line_search(
            eval_fn, theta_old, beta * x, surr_old, tr.delta, tr.ls_steps,
            tr.ls_backtrack)
    new_params = policy.unflatten(theta_new, params)

    stats = dict(
        beta=beta, accepted=accepted, kl=kl_new, surr=surr_new,
        surr_old=surr_old, g_norm=torch.linalg.norm(g),
        step_norm=torch.linalg.norm(theta_new - theta_old),
        cg_residual=cg_residual, xhx=xhx,
        entropy=policy.entropy(params["logstd"]),
        mean_return=torch.mean(torch.sum(rewards_tn, dim=0)),
        adv_std=std,
    )
    if return_directions:
        stats["g"] = g
        stats["x"] = x
    return new_params, w_new, stats
