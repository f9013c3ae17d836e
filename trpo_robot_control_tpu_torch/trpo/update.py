"""The TRPO natural-gradient update (port of the feature-first branch of
``trpo_robot_control_tpu/trpo/update.py``, as c1-c5 run it).

values -> GAE -> whitening -> baseline moments (K2) -> ridge fit ->
closed-form surrogate gradient (K5 at B >= 400k samples, else the plain
form) -> CG on the damped GN-FVP over the Fisher subsample, every k-th time
step of every e-th env (K6 on the feature-first subsample at B' >= 64k
samples, else K3 on its batch-major relayout; a policy wider than 64 takes
the plain form and K3, as in JAX: ``kernel_routes``; ``fvp_form="kl"`` or
``fvp_impl="kl"``, the KL-Hessian form on the relayout) -> step size from the CG
invariant -> KL line search over the full batch or an env-strided
subsample of it. The kernel gates are the JAX package's, on the global
batch, and the CPU takes the same route through the plain versions. With
bf16 storage (c3-c5) obs and actions arrive in bf16 and every consumer
rounds where the JAX package does.
Every step stays on the device; the only host synchronisation is the
caller's read of the stats. Each layer runs under a ``record_function``
range (``trpo/...``) that ``cli/profile.py`` reads; outside a profiler a
range costs about a
microsecond of host time.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models import baseline, policy
from ..ops.cg import conjugate_gradient
from ..ops.cuda import fvp_ff_kernel, pg_kernel
from ..ops.cuda.moments_kernel import baseline_moments
from ..ops.fvp import make_gn_fvp, make_kl_fvp
from ..ops.gae import gae
from ..ops.linesearch import line_search


def _check_supported(cfg, batch, axis_name):
    tr = cfg.trpo
    later = [
        (tr.baseline == "mlp", "the MLP baseline comes with a later slice"),
        (axis_name is not None, "data parallelism comes with slice 4"),
        ("obs_ff" not in batch or "actions_ff" not in batch,
         "the batch-major update path comes with slice 4; pass a batch "
         "from the rollout kernel (obs_ff/actions_ff/rewards_ff)"),
    ]
    for cond, msg in later:
        if cond:
            raise NotImplementedError(msg)


# The kernels' gates, on the global batch (the JAX package's measured
# crossovers, trpo/update.py there): below them the plain forms win. The
# config keeps the JAX package's switch values: "pallas" forces the CUDA
# kernel, "xla" the plain form.
SURRGRAD_MIN_B = 400_000
FVP_FF_MIN_B = 64_000
# The JAX package's width rule for its packed kernels (the half of
# ``pg_kernel.tiles_ok`` there that is not TPU tile layout): the
# observation, the action and every hidden layer at most this wide, else
# the plain surrogate gradient and the batch-major FVP, even when the
# config forces the kernels.
PACKED_MAX_WIDTH = 64


# The implementation switches' values the port runs on the card. The
# plain forms of the FVP, the moments and the rollout serve the tests on
# the CPU, so the JAX package's "xla" values, and any value it does not
# have, raise there (``check_switch``).
HONOURED = {"fvp_impl": ("auto", "pallas", "pallas_bm", "kl"),
            "moments_impl": ("auto", "pallas"),
            "rollout_impl": ("auto", "pallas", "pallas3d")}


def check_switch(name: str, value: str, device) -> None:
    """NotImplementedError, naming the switch and its value, where the port
    would not run what the JAX package runs for it on ``device``."""
    if torch.device(device).type == "cuda" and value not in HONOURED[name]:
        raise NotImplementedError(
            f"{name}={value!r}: the port runs {', '.join(HONOURED[name])} "
            "on the card, not this one")


def packed_ok(params) -> bool:
    """Whether every width of the policy fits the packed kernels (K5, K6)."""
    L = policy.n_layers(params) - 1
    widths = [params["W0"].shape[0], params[f"W{L}"].shape[1]] \
        + [params[f"W{l}"].shape[1] for l in range(L)]
    return max(widths) <= PACKED_MAX_WIDTH


def kernel_routes(tr, params, T, N, sub_T, sub_N, fvp_form: str = "gn"):
    """The update's routes for a (T, ., N) batch and its (sub_T, ., sub_N)
    Fisher subsample, decided as the JAX package's resolver decides them
    (its trpo/update.py), with the port's gates: ``surrgrad`` "pallas" (K5)
    or "xla" (``policy.surrogate_grad_ff``), ``fvp`` "ff" (K6 on the
    feature-first subsample), "bm" (K3 on its batch-major relayout) or
    "kl" (``make_kl_fvp`` on the same relayout, for ``fvp_form="kl"`` or
    ``fvp_impl="kl"``)."""
    sg = tr.surrgrad_impl
    if sg == "auto":
        sg = "pallas" if T * N >= SURRGRAD_MIN_B else "xla"
    if sg == "pallas" and not packed_ok(params):
        sg = "xla"
    impl = tr.fvp_impl if fvp_form == "gn" else "kl"
    ff = (tr.fvp_subsample > 1 and impl not in ("xla", "pallas_bm", "kl")
          and packed_ok(params)
          and (impl == "pallas" or sub_T * sub_N >= FVP_FF_MIN_B))
    return dict(surrgrad=sg,
                fvp="kl" if impl == "kl" else "ff" if ff else "bm")


def _eval_candidates(params, thetas, obs_ff, act_ff, adv, mu_old, logp_old,
                     logstd_old, store_dtype=None):
    """Surrogate and mean KL of K candidate parameter vectors (K, P) in
    one batched forward pass over the (T, d, N) batch -> ((K,), (K,)).
    Hidden activations round to ``store_dtype`` as ``hidden_ff`` does."""
    p = policy.unflatten(thetas, params)
    L = policy.n_layers(params)
    h = obs_ff.float()
    for i in range(L - 1):
        eq = "kio,tin->kton" if i == 0 else "kio,ktin->kton"
        h = policy.store_round(
            torch.tanh(torch.einsum(eq, p[f"W{i}"], h)
                       + p[f"b{i}"][:, None, :, None]), store_dtype)
    act_ff = act_ff.float()
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
                fvp_form: str = "gn", return_directions: bool = False):
    """One TRPO update on a batch from the rollout kernel (obs_ff
    (T, do, N), actions_ff (T, da, N), rewards_ff (T, N) and the batch-major
    obs (N, T, do)). ``fvp_form``: "gn" (the GN-FVP that ``fvp_impl``
    selects) or "kl" (the KL-Hessian form), as in the JAX package. Returns
    (new_params, new_w, stats)."""
    _check_supported(cfg, batch, axis_name)
    if fvp_form not in ("gn", "kl"):
        raise ValueError(f"fvp_form is 'gn' or 'kl', not {fvp_form!r}")
    tr = cfg.trpo
    obs_ff, act_ff = batch["obs_ff"], batch["actions_ff"]
    for name in ("fvp_impl", "moments_impl"):
        check_switch(name, getattr(tr, name), obs_ff.device)
    rewards_tn = batch["rewards_ff"]
    T, do, N = obs_ff.shape
    store = torch.bfloat16 if obs_ff.dtype == torch.bfloat16 else None

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
    k, e = tr.fvp_subsample, tr.fvp_env_subsample
    routes = kernel_routes(tr, params, T, N, -(-T // k), -(-N // e),
                           fvp_form)
    with record_function("trpo/surrogate_grad"):
        if routes["surrgrad"] == "pallas":
            g_tree, mu_old_ff, logp_old_ff = pg_kernel.surrogate_grad(
                params, obs_ff, act_ff, adv)
        else:
            g_tree, mu_old_ff, logp_old_ff = policy.surrogate_grad_ff(
                params, obs_ff, act_ff, adv, store_dtype=store)
        theta_old = policy.flatten(params)
        g = policy.flatten(g_tree)
        surr_old = torch.mean(adv)                             # ratio == 1

    # ---- 3) CG on the damped GN-FVP over the Fisher subsample. The time
    # stride over (T, do, N) selects the same samples as obs_f[::k] when
    # T % k == 0; the env stride e (envs are i.i.d.) comes on top of it.
    # K6 reads that strided view in place; K3 (and the KL form) take it
    # relaid to (B / (k e), do) fp32.
    if k > 1 and T % k:
        raise ValueError("the feature-first fvp_subsample matches "
                         "obs_f[::k] only when horizon % fvp_subsample "
                         f"== 0; got T={T}, k={k}")
    if e > 1 and N % e:
        raise ValueError("fvp_env_subsample needs (local) n_envs % k == 0 so "
                         f"the strided env set is sharding-invariant; got "
                         f"N={N}, k={e}")
    sub = obs_ff[::k, :, ::e]
    with record_function("trpo/cg_fvp"):
        if routes["fvp"] == "ff":
            fvp = fvp_ff_kernel.make_gn_fvp_ff(params, sub, tr.cg_damping)
        else:
            obs_fvp = (sub.permute(0, 2, 1) if k > 1
                       else batch["obs"][::e]).reshape(-1, do).float()
            make_fvp = make_kl_fvp if routes["fvp"] == "kl" else make_gn_fvp
            fvp = make_fvp(params, obs_fvp, tr.cg_damping)
        x, r_final, cg_residual = conjugate_gradient(fvp, g, tr.cg_iters)
        # ---- 4) step size: F x = g - r (CG invariant): x^T F x = x.g - x.r
        xhx = torch.dot(x, g) - torch.dot(x, r_final)
        beta = torch.sqrt(2.0 * tr.delta / (xhx + 1e-12))

    # ---- 5) KL line search on the full batch, or on every k-th env
    # (whole trajectories: envs are i.i.d., time steps are not), with
    # surr_old re-estimated on the same envs
    k_ls = tr.ls_subsample
    if k_ls > 1:
        if N % k_ls:
            raise ValueError("ls_subsample needs n_envs % ls_subsample == 0; "
                             f"got N={N}, k={k_ls}")
        ls = (obs_ff[..., ::k_ls], act_ff[..., ::k_ls], adv[:, ::k_ls],
              mu_old_ff[..., ::k_ls], logp_old_ff[:, ::k_ls])
        surr_old_ls = torch.mean(ls[2])
    else:
        ls = (obs_ff, act_ff, adv, mu_old_ff, logp_old_ff)
        surr_old_ls = surr_old

    def eval_fn(thetas):
        return _eval_candidates(params, thetas, *ls, params["logstd"],
                                store_dtype=store)

    with record_function("trpo/line_search"):
        theta_new, accepted, kl_new, surr_new = line_search(
            eval_fn, theta_old, beta * x, surr_old_ls, tr.delta,
            tr.ls_steps, tr.ls_backtrack)
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
