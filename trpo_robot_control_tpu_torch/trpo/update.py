"""The TRPO natural-gradient update (port of
``trpo_robot_control_tpu/trpo/update.py``, both of its branches).

The feature-first branch, as c1-c5 run it on a batch from the rollout
kernel (obs_ff/actions_ff): values -> GAE -> whitening -> baseline moments
(K2) -> ridge fit -> closed-form surrogate gradient (K5 at B >= 400k
samples, else the plain form) -> CG on the damped GN-FVP over the Fisher
subsample, every k-th time step of every e-th env (K6 on the feature-first
subsample at B' >= 64k samples, else K3 on its batch-major relayout; a
policy wider than 64 takes the plain form and K3, as in JAX:
``kernel_routes``; ``fvp_form="kl"`` or ``fvp_impl="kl"``, the KL-Hessian
form on the relayout) -> step size from the CG invariant -> KL line search
over the full batch or an env-strided subsample of it. The kernel gates
are the JAX package's, on the global batch, and the CPU takes the same
route through the plain versions. With bf16 storage (c3-c5) obs and
actions arrive in bf16 and every consumer rounds where the JAX package
does.

The batch-major branch, taken with the MLP baseline (which ignores obs_ff,
as in JAX) or on a batch without the feature-first keys: values and GAE on
(N, T), the MLP's Adam refit or the ridge fit on phi (B, F), the surrogate
gradient by autograd, CG on the GN-FVP (K3) or the KL-Hessian form over the
n-major subsample ``obs[::e].reshape(-1, do)[::k]``, and the line search on
every ``ls_subsample``-th env, all in fp32 (a bf16 batch is read as the
fp32 copy the JAX rollouts hand this branch). A batch with obs_ff but no
actions_ff takes the feature-first baseline pipeline and then this
branch's policy math, with the (T, N) advantages transposed.

Under data parallelism (``axis_name``, the mesh's 'data' process group,
``parallel/mesh.py``) each rank holds its own envs and the update inserts
an all-reduce wherever a batch reduction already exists, as the JAX
package inserts ``pmean``/``psum``: the whitening moments, the baseline's
normal equations (summed before the ridge), the MLP refit's gradients, g
and surr_old, Fv in every CG call, the line-search estimates and the mean
return (``parallel/collectives.py``); the kernel gates read the global
batch. Without a group none of this runs.

Every step stays on the device; the only host synchronisation is the
caller's read of the stats. On the card none is left inside the update
(the ridge solve is the ``fit_normal`` kernel, not eigh), so a CUDA graph
captures it whole (``trpo/train.py:make_train_many``). Each layer runs
under a ``record_function`` range (``trpo/...``) that ``cli/profile.py``
reads; outside a profiler a range costs about a microsecond of host time.
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
from ..parallel.collectives import group_size, pmean, psum


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


def kernel_routes(tr, params, T, N, sub_T, sub_N, fvp_form: str = "gn",
                  ff: bool = True, n_data: int = 1):
    """The update's routes for a (T, ., N) batch and its (sub_T, ., sub_N)
    Fisher subsample, decided as the JAX package's resolver decides them
    (its trpo/update.py), with the port's gates: ``surrgrad`` "pallas" (K5)
    or "xla" (``policy.surrogate_grad_ff``), ``fvp`` "ff" (K6 on the
    feature-first subsample), "bm" (K3 on its batch-major relayout) or
    "kl" (``make_kl_fvp`` on the same relayout, for ``fvp_form="kl"`` or
    ``fvp_impl="kl"``). ``ff=False``, the batch-major branch: ``surrgrad``
    "autograd" and ``fvp`` "bm" (K3) or "kl", on the n-major subsample;
    K5 and K6 never run there, as in JAX. ``n_data``: the ranks of the
    'data' axis, each holding such a shard; the gates read the global
    batch, ``n_data`` times the local one, so a config takes the same
    routes sharded and unsharded."""
    impl = tr.fvp_impl if fvp_form == "gn" else "kl"
    if not ff:
        return dict(surrgrad="autograd", fvp="kl" if impl == "kl" else "bm")
    sg = tr.surrgrad_impl
    if sg == "auto":
        sg = "pallas" if T * N * n_data >= SURRGRAD_MIN_B else "xla"
    if sg == "pallas" and not packed_ok(params):
        sg = "xla"
    on_ff = (tr.fvp_subsample > 1 and impl not in ("xla", "pallas_bm", "kl")
             and packed_ok(params)
             and (impl == "pallas" or sub_T * sub_N * n_data >= FVP_FF_MIN_B))
    return dict(surrgrad=sg,
                fvp="kl" if impl == "kl" else "ff" if on_ff else "bm")


def _eval_candidates(params, thetas, obs_ff, act_ff, adv, mu_old, logp_old,
                     logstd_old, store_dtype=None, model_group=None):
    """Surrogate and mean KL of K candidate parameter vectors (K, P) in
    one batched forward pass over the (T, d, N) batch (the batch-major
    branch passes (1, d, B) views) -> ((K,), (K,)). Hidden activations
    round to ``store_dtype`` as ``hidden_ff`` does. ``model_group``: the
    candidates are tensor-parallel shards (``parallel/tensor.py``), and
    layer 1's products are summed over the group, one all-reduce for all
    K."""
    p = policy.unflatten(thetas, params)
    L = policy.n_layers(params)
    h = obs_ff.float()
    for i in range(L - 1):
        eq = "kio,tin->kton" if i == 0 else "kio,ktin->kton"
        z = torch.einsum(eq, p[f"W{i}"], h)
        if i == 1:
            z = psum(z, model_group)
        h = policy.store_round(
            torch.tanh(z + p[f"b{i}"][:, None, :, None]), store_dtype)
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


def _check_env_stride(name, N, k):
    """ValueError unless the env stride k divides N: the strided env set
    is then sharding-invariant, as the JAX package requires."""
    if k > 1 and N % k:
        raise ValueError(f"{name} needs (local) n_envs % {name} == 0 so the "
                         f"strided env set is sharding-invariant; got N={N}, "
                         f"k={k}")


def _whiten(adv_raw, axis_name):
    """(adv_raw - mean) / (std + 1e-8) and std, over the whole (global)
    batch."""
    m1 = torch.mean(adv_raw)
    m2 = torch.mean(adv_raw ** 2)
    m1, m2 = pmean((m1, m2), axis_name)
    std = torch.sqrt(torch.clamp(m2 - m1 ** 2, min=0.0))
    return (adv_raw - m1) / (std + 1e-8), std


def _fp32(x):
    """x in fp32, contiguous (one copy at most; none for a contiguous fp32
    tensor: ``to`` returns an fp32 input as it is, whatever its strides)."""
    return x.to(torch.float32,
                memory_format=torch.contiguous_format).contiguous()


def _baseline_ff(cfg, w, obs_ff, rewards_tn, dones_tn, axis_name):
    """Step 1 in the kernel layout: values from the old linear baseline,
    GAE on (T, N), whitening, and the ridge refit from K2's moments.
    Returns (adv (T, N), std, w_new)."""
    tr = cfg.trpo
    with record_function("trpo/values_gae"):
        values = baseline.values_ff(w, obs_ff, cfg.horizon)         # (T, N)
        adv_raw = gae(rewards_tn, values, tr.gamma, tr.lam,
                      dones=dones_tn, time_axis=0)
        adv, std = _whiten(adv_raw, axis_name)
        targets = adv_raw + values
    with record_function("trpo/baseline_fit"):
        w_new = baseline.fit_moments(
            *baseline_moments(obs_ff, targets, cfg.horizon),
            tr.baseline_reg, axis_name)
    return adv, std, w_new


def _baseline_bm(cfg, w, obs, rewards, dones, axis_name):
    """Step 1 batch-major: phi (N, T, F), values from the old baseline
    (linear or MLP), GAE on (N, T), whitening, and the refit on
    phi (B, F): the MLP's Adam steps or the ridge normal equations.
    Returns (adv (N, T), std, w_new)."""
    tr = cfg.trpo
    mlp = tr.baseline == "mlp"
    with record_function("trpo/values_gae"):
        phi = baseline.features(obs, cfg.horizon)
        values = baseline.predict_mlp(w, phi) if mlp \
            else baseline.predict(w, phi)
        adv_raw = gae(rewards, values, tr.gamma, tr.lam, dones=dones,
                      time_axis=1)
        adv, std = _whiten(adv_raw, axis_name)
        targets = adv_raw + values
    with record_function("trpo/baseline_fit"):
        phi_f = phi.reshape(-1, phi.shape[-1])
        y = targets.reshape(-1)
        w_new = baseline.fit_mlp(w, phi_f, y, tr.baseline_lr,
                                 tr.baseline_epochs, axis_name=axis_name) \
            if mlp else baseline.fit(phi_f, y, tr.baseline_reg, axis_name)
    return adv, std, w_new


def _policy_ff(cfg, params, obs_ff, act_ff, adv, obs, fvp_form, axis_name):
    """Steps 2-5 in the kernel layout on adv (T, N). Returns the update's
    results (``_line_search_step``)."""
    tr = cfg.trpo
    T, do, N = obs_ff.shape
    store = torch.bfloat16 if obs_ff.dtype == torch.bfloat16 else None

    # ---- 2) closed-form surrogate gradient at theta_old
    k, e = tr.fvp_subsample, tr.fvp_env_subsample
    routes = kernel_routes(tr, params, T, N, -(-T // k), -(-N // e),
                           fvp_form, n_data=group_size(axis_name))
    with record_function("trpo/surrogate_grad"):
        if routes["surrgrad"] == "pallas":
            g_tree, mu_old_ff, logp_old_ff = pg_kernel.surrogate_grad(
                params, obs_ff, act_ff, adv)
        else:
            g_tree, mu_old_ff, logp_old_ff = policy.surrogate_grad_ff(
                params, obs_ff, act_ff, adv, store_dtype=store)
        g = policy.flatten(g_tree)
        surr_old = torch.mean(adv)                             # ratio == 1
        g, surr_old = pmean((g, surr_old), axis_name)

    # ---- 3) CG on the damped GN-FVP over the Fisher subsample. The time
    # stride over (T, do, N) selects the same samples as obs_f[::k] when
    # T % k == 0; the env stride e (envs are i.i.d.) comes on top of it.
    # K6 reads that strided view in place; K3 (and the KL form) take it
    # relaid to (B / (k e), do) fp32.
    if k > 1 and T % k:
        raise ValueError("the feature-first fvp_subsample matches "
                         "obs_f[::k] only when horizon % fvp_subsample "
                         f"== 0; got T={T}, k={k}")
    _check_env_stride("fvp_env_subsample", N, e)
    sub = obs_ff[::k, :, ::e]
    with record_function("trpo/cg_fvp"):
        if routes["fvp"] == "ff":
            fvp = fvp_ff_kernel.make_gn_fvp_ff(params, sub, tr.cg_damping,
                                               axis_name=axis_name)
        else:
            obs_fvp = (sub.permute(0, 2, 1) if k > 1
                       else obs[::e]).reshape(-1, do).float()
            make_fvp = make_kl_fvp if routes["fvp"] == "kl" else make_gn_fvp
            fvp = make_fvp(params, obs_fvp, tr.cg_damping,
                           axis_name=axis_name)
        out = _cg_step(tr, fvp, g)

    # ---- 5) KL line search on the full batch, or on every k-th env
    # (whole trajectories: envs are i.i.d., time steps are not), with
    # surr_old re-estimated on the same envs
    k_ls = tr.ls_subsample
    _check_env_stride("ls_subsample", N, k_ls)
    if k_ls > 1:
        ls = (obs_ff[..., ::k_ls], act_ff[..., ::k_ls], adv[:, ::k_ls],
              mu_old_ff[..., ::k_ls], logp_old_ff[:, ::k_ls])
        surr_old_ls = pmean(torch.mean(ls[2]), axis_name)
    else:
        ls = (obs_ff, act_ff, adv, mu_old_ff, logp_old_ff)
        surr_old_ls = surr_old

    def eval_fn(thetas):
        return pmean(_eval_candidates(params, thetas, *ls, params["logstd"],
                                      store_dtype=store), axis_name)

    return _line_search_step(tr, params, eval_fn, g, surr_old, surr_old_ls,
                             out)


def _policy_bm(cfg, params, obs, actions, adv, fvp_form, axis_name):
    """Steps 2-5 batch-major on obs (N, T, do), actions (N, T, da) fp32
    and adv (N, T). Returns the update's results."""
    tr = cfg.trpo
    N, T, do = obs.shape
    da = actions.shape[-1]
    B = N * T
    obs_f, act_f, adv_f = obs.reshape(B, do), actions.reshape(B, da), \
        adv.reshape(B)
    routes = kernel_routes(tr, params, T, N, T, N, fvp_form, ff=False)

    # ---- 2) surrogate gradient at theta_old by autograd; mu_old and
    # logp_old are the same forward pass, detached
    with record_function("trpo/surrogate_grad"):
        keys = sorted(params)
        with torch.enable_grad():
            leaves = [params[k].detach().requires_grad_(True) for k in keys]
            mu, logstd = policy.dist(dict(zip(keys, leaves)), obs_f)
            logp = policy.log_prob(mu, logstd, act_f)
            mu_old, logp_old = mu.detach(), logp.detach()
            surr = torch.mean(torch.exp(logp - logp_old) * adv_f)
            g = torch.cat([x.reshape(-1) for x in
                           torch.autograd.grad(surr, leaves)])
        surr_old = torch.mean(adv_f)                           # ratio == 1
        g, surr_old = pmean((g, surr_old), axis_name)

    # ---- 3) CG over the n-major Fisher subsample: every e-th env, then
    # every k-th sample of the flattened (env, time) order, as JAX takes
    # it (no T % k condition here), copied contiguous fp32 for K3
    k, e = tr.fvp_subsample, tr.fvp_env_subsample
    _check_env_stride("fvp_env_subsample", N, e)
    src = obs[::e].reshape(-1, do) if e > 1 else obs_f
    sub = src[::k] if k > 1 else src
    with record_function("trpo/cg_fvp"):
        obs_fvp = sub.clone(memory_format=torch.contiguous_format)
        make_fvp = make_kl_fvp if routes["fvp"] == "kl" else make_gn_fvp
        fvp = make_fvp(params, obs_fvp, tr.cg_damping, axis_name=axis_name)
        out = _cg_step(tr, fvp, g)

    # ---- 5) the line search on every k_ls-th env (n-major: envs sliced
    # before flattening), surr_old re-estimated on the same envs
    k_ls = tr.ls_subsample
    _check_env_stride("ls_subsample", N, k_ls)
    if k_ls > 1:
        ls = (obs[::k_ls].reshape(-1, do), actions[::k_ls].reshape(-1, da),
              adv[::k_ls].reshape(-1),
              mu_old.reshape(N, T, da)[::k_ls].reshape(-1, da),
              logp_old.reshape(N, T)[::k_ls].reshape(-1))
        surr_old_ls = pmean(torch.mean(ls[2]), axis_name)
    else:
        ls = (obs_f, act_f, adv_f, mu_old, logp_old)
        surr_old_ls = surr_old

    # the candidates' pass of the feature-first layout on (1, d, B) views
    ls = (ls[0].T[None], ls[1].T[None], ls[2][None], ls[3].T[None],
          ls[4][None])

    def eval_fn(thetas):
        return pmean(_eval_candidates(params, thetas, *ls, params["logstd"]),
                     axis_name)

    return _line_search_step(tr, params, eval_fn, g, surr_old, surr_old_ls,
                             out)


def _cg_step(tr, fvp, g):
    """Step 3's CG and step 4's step size from the CG invariant,
    F x = g - r: x^T F x = x.g - x.r."""
    x, r_final, cg_residual = conjugate_gradient(fvp, g, tr.cg_iters)
    xhx = torch.dot(x, g) - torch.dot(x, r_final)
    beta = torch.sqrt(2.0 * tr.delta / (xhx + 1e-12))
    return dict(x=x, xhx=xhx, beta=beta, cg_residual=cg_residual)


def _line_search_step(tr, params, eval_fn, g, surr_old, surr_old_ls, out):
    """Step 5 from the step ``beta x``; returns ``out`` with g, the old and
    new flat params and the line search's results added."""
    theta_old = policy.flatten(params)
    with record_function("trpo/line_search"):
        theta_new, accepted, kl_new, surr_new = line_search(
            eval_fn, theta_old, out["beta"] * out["x"], surr_old_ls,
            tr.delta, tr.ls_steps, tr.ls_backtrack)
    out.update(g=g, theta_old=theta_old, theta_new=theta_new,
               accepted=accepted, kl=kl_new, surr=surr_new,
               surr_old=surr_old)
    return out


def trpo_update(cfg, params, w, batch, axis_name=None,
                fvp_form: str = "gn", return_directions: bool = False):
    """One TRPO update. ``batch``: obs (N, T, do), actions (N, T, da),
    rewards (N, T) [, dones (N, T)], and from the rollout kernel the
    feature-first obs_ff (T, do, N), actions_ff (T, da, N), rewards_ff
    [, dones_ff] (T, N). The feature-first branch runs when obs_ff and
    actions_ff are there and the baseline is linear, the batch-major one
    otherwise (the module's docstring). ``w``: the linear baseline's
    weights, or the MLP's dict. ``fvp_form``: "gn" (the GN-FVP that
    ``fvp_impl`` selects) or "kl" (the KL-Hessian form), as in the JAX
    package. ``axis_name``: the mesh's 'data' process group, with
    ``batch`` this rank's shard (``parallel/mesh.py``); None outside a mesh.
    Returns (new_params, new_w, stats)."""
    if fvp_form not in ("gn", "kl"):
        raise ValueError(f"fvp_form is 'gn' or 'kl', not {fvp_form!r}")
    tr = cfg.trpo
    obs_ff = batch.get("obs_ff") if tr.baseline != "mlp" else None
    ff = obs_ff is not None and "actions_ff" in batch
    dev = (obs_ff if obs_ff is not None else batch["obs"]).device
    check_switch("fvp_impl", tr.fvp_impl, dev)
    obs = None if ff else _fp32(batch["obs"])

    # ---- 1) values (old baseline) -> GAE -> whiten -> targets -> refit
    if obs_ff is not None:
        check_switch("moments_impl", tr.moments_impl, dev)
        rewards_tn = batch["rewards_ff"] if "rewards_ff" in batch \
            else batch["rewards"].T
        dones_tn = batch.get("dones_ff")
        if dones_tn is None and "dones" in batch:
            dones_tn = batch["dones"].T
        adv, std, w_new = _baseline_ff(cfg, w, obs_ff, rewards_tn, dones_tn,
                                       axis_name)
        mean_return = torch.mean(torch.sum(rewards_tn, dim=0))
    else:
        adv, std, w_new = _baseline_bm(cfg, w, obs, batch["rewards"],
                                       batch.get("dones"), axis_name)
        mean_return = torch.mean(torch.sum(batch["rewards"], dim=1))
    mean_return = pmean(mean_return, axis_name)

    # ---- 2-5) surrogate gradient, CG, step size, line search
    if ff:
        out = _policy_ff(cfg, params, obs_ff, batch["actions_ff"], adv,
                         batch.get("obs"), fvp_form, axis_name)
    else:
        out = _policy_bm(cfg, params, obs, _fp32(batch["actions"]),
                         adv.T if obs_ff is not None else adv, fvp_form,
                         axis_name)
    new_params = policy.unflatten(out["theta_new"], params)

    g, x = out["g"], out["x"]
    stats = dict(
        beta=out["beta"], accepted=out["accepted"], kl=out["kl"],
        surr=out["surr"], surr_old=out["surr_old"], g_norm=torch.linalg.norm(g),
        step_norm=torch.linalg.norm(out["theta_new"] - out["theta_old"]),
        cg_residual=out["cg_residual"], xhx=out["xhx"],
        entropy=policy.entropy(params["logstd"]),
        mean_return=mean_return, adv_std=std,
    )
    if return_directions:
        stats["g"] = g
        stats["x"] = x
    return new_params, w_new, stats
