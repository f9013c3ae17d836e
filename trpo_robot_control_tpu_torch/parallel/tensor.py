"""Tensor parallelism over the mesh's 'model' axis (port of
``trpo_robot_control_tpu/parallel/tensor.py``).

Layout, Megatron's pairing on the first two layers of the tanh MLP:

- W0 (do, H) column-sharded (do, H/m) and b0 (H,) sharded (H/m,): each
  model rank holds whole columns of h0, tanh local;
- W1 (H, H') row-sharded (H/m, H'): partial products,
  z1 = sum over 'model'(h0_local @ W1_local) + b1, one all-reduce a forward
  (``collectives.model_sum``, whose backward is the identity);
- b1, the later layers and logstd replicated.

The train state keeps the full parameters: the rollout runs on them through
the same kernels as the unsharded path, and only the update is sharded
(``parallel/mesh.py:make_sharded_update_tp`` shards, updates and gathers
back). The update is plain PyTorch, as JAX's is plain XLA (no Pallas kernel
there): values, GAE and the baseline refit batch-major, replicated over
'model' and reduced over 'data'; the surrogate gradient by autograd through
the sharded forward, which gives each rank its shards of the global
gradient; CG on flat local vectors (sorted-key order, as every flat vector
of the port) with ``make_vdot``; the GN-FVP's forward tangent and reverse
pass written out, the tangent through the same one all-reduce; the line
search the port's batched one, all candidates' forwards sharing one
all-reduce. As in JAX the Fisher subsample is ``obs_f[::fvp_subsample]``
and the line search reads the whole batch (``fvp_env_subsample`` and
``ls_subsample`` are the data-parallel branches' estimators, not read
here). Over 'data' every reduction is a local mean ``pmean``ed over the
data group, the data-parallel path's rule (JAX's factors of n_d make up for
its ``shard_map``'s own psum of cotangents, which has no counterpart here).

A 64-wide MLP gains nothing from this on a real mesh; it makes the
parallelism surface whole, as in JAX, and lets wider policies slot in.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..models import policy
from ..ops.cg import conjugate_gradient
from ..ops.linesearch import line_search
from ..trpo.update import _baseline_bm, _eval_candidates, _fp32
from .collectives import model_sum, pmean, psum

SHARDED_KEYS = ("W0", "b0", "W1")


def check_tp(params, n_model: int) -> None:
    """ValueError unless the policy has at least two hidden layers and its
    first hidden width splits evenly over ``n_model`` ranks (JAX's
    asserts)."""
    if policy.n_layers(params) < 3:
        raise ValueError("tensor parallelism needs >= 2 hidden layers; the "
                         f"policy has {policy.n_layers(params) - 1}")
    H = params["W0"].shape[1]
    if H % n_model:
        raise ValueError(f"hidden width {H} does not split over n_model="
                         f"{n_model} ranks")


def shard_policy_params(params, n_model: int, idx: int) -> dict:
    """Full parameters -> model rank ``idx``'s shard (W0's and b0's
    columns, W1's rows idx * H/m .. (idx + 1) * H/m); the rest as it is."""
    check_tp(params, n_model)
    k = params["W0"].shape[1] // n_model
    cols = slice(idx * k, (idx + 1) * k)
    local = dict(params)
    local["W0"] = params["W0"][:, cols].contiguous()
    local["b0"] = params["b0"][cols].contiguous()
    local["W1"] = params["W1"][cols].contiguous()
    return local


def unshard_policy_params(local, n_model: int, idx: int, group) -> dict:
    """A shard -> the full parameters on every model rank: each sharded
    leaf zero-padded to its full shape and summed over ``group`` (JAX's
    form; one all-reduce for the three, exact: each entry is one rank's
    value plus zeros, and every rank receives the same bits)."""
    k = local["b0"].shape[0]
    cols = slice(idx * k, (idx + 1) * k)
    pads = []
    for key, axis in (("W0", 1), ("b0", 0), ("W1", 0)):
        shape = list(local[key].shape)
        shape[axis] = k * n_model
        full = local[key].new_zeros(shape)
        full[(slice(None),) * axis + (cols,)] = local[key]
        pads.append(full)
    full = dict(local)
    full["W0"], full["b0"], full["W1"] = psum(pads, group)
    return full


def activations_tp(local, obs, group):
    """The sharded tanh MLP's hidden activations [h0 (B, H/m), h1 (B, H'),
    ...], one sum over ``group`` (``model_sum``). ValueError under two
    hidden layers."""
    check_tp(local, 1)
    hs = [torch.tanh(obs @ local["W0"] + local["b0"])]
    hs.append(torch.tanh(model_sum(hs[0] @ local["W1"], group)
                         + local["b1"]))
    for i in range(2, policy.n_layers(local) - 1):
        hs.append(torch.tanh(hs[-1] @ local[f"W{i}"] + local[f"b{i}"]))
    return hs


def mean_net_tp(local, obs, group):
    """The sharded tanh MLP's mean, (B, do) -> (B, da): one sum over
    ``group`` a forward."""
    L = policy.n_layers(local)
    return activations_tp(local, obs, group)[-1] @ local[f"W{L - 1}"] \
        + local[f"b{L - 1}"]


def dist_tp(local, obs, group):
    return mean_net_tp(local, obs, group), local["logstd"]


def _segments(like):
    """[(slice, sharded)] of a flat local vector, sorted-key order."""
    out, off = [], 0
    for k in sorted(like):
        n = like[k].numel()
        out.append((slice(off, off + n), k in SHARDED_KEYS))
        off += n
    return out


def make_vdot(like, group):
    """``vdot(u, v)``: the global inner product of two flat local vectors
    of ``like``'s layout: the sharded leaves' part summed over ``group``,
    the replicated part local."""
    segs = _segments(like)
    sharded = [s for s, sh in segs if sh]
    replicated = [s for s, sh in segs if not sh]

    def vdot(u, v):
        sh = sum(torch.dot(u[s], v[s]) for s in sharded)
        return psum(sh, group) + sum(torch.dot(u[s], v[s])
                                     for s in replicated)
    return vdot


def make_gn_fvp_tp(local, obs, damping: float, data_group, model_group):
    """The damped GN-FVP on flat local vectors over (B, do) samples:
    J^T M J v written out as the port's plain FVP
    (``ops/cuda/fvp_kernel.gn_fvp_math``), the forward tangent's layer 1
    summed over ``model_group`` (dz1 = sum(dh0 W1 + h0 dW1) + db1); each
    rank's product is on its own samples, averaged over ``data_group``,
    then ``damping * v`` added."""
    B = obs.shape[0]
    hs = activations_tp(local, obs, model_group)
    scale = torch.exp(-2.0 * local["logstd"]) / B
    L = len(hs)

    def fvp(v):
        t = policy.unflatten(v, local)
        dh = (1.0 - hs[0] * hs[0]) * (obs @ t["W0"] + t["b0"])
        for l in range(1, L + 1):
            a = dh @ local[f"W{l}"] + hs[l - 1] @ t[f"W{l}"]
            if l == 1:
                a = psum(a, model_group)
            a = a + t[f"b{l}"]
            if l < L:
                dh = (1.0 - hs[l] * hs[l]) * a
        g = a * scale
        out = {"logstd": 2.0 * t["logstd"]}
        for l in range(L, 0, -1):
            out[f"W{l}"] = hs[l - 1].T @ g
            out[f"b{l}"] = g.sum(0)
            g = (g @ local[f"W{l}"].T) * (1.0 - hs[l - 1] * hs[l - 1])
        out["W0"] = obs.T @ g
        out["b0"] = g.sum(0)
        return pmean(policy.flatten(out), data_group) + damping * v

    return fvp


def _unshard_flat(flat, local, n_model, idx, group):
    """A flat local vector -> the flat full vector (sorted-key order)."""
    full = unshard_policy_params(policy.unflatten(flat, local), n_model, idx,
                                 group)
    return policy.flatten(full)


def trpo_update_tp(cfg, local, w, batch, data_group, model_group,
                   n_model: int, model_rank: int,
                   return_directions: bool = False):
    """One TRPO update on this rank's shard ``local`` of the policy and its
    data shard ``batch`` (obs (N, T, do), actions (N, T, da), rewards
    (N, T) [, dones]; the same on every model rank), step for step as
    JAX's ``trpo_update_tp``. ``w``: the linear baseline's weights or the
    MLP's dict, replicated. Returns (new local shard, new w, stats); with
    ``return_directions`` stats also hold the full g and x (gathered)."""
    tr = cfg.trpo
    obs, actions = _fp32(batch["obs"]), _fp32(batch["actions"])
    rewards = batch["rewards"]
    N, T, do = obs.shape
    da = actions.shape[-1]
    B = N * T

    # ---- 1) values -> GAE -> whiten -> targets -> refit, batch space:
    # replicated over 'model', reduced over 'data'
    adv, std, w_new = _baseline_bm(cfg, w, obs, rewards, batch.get("dones"),
                                   data_group)
    mean_return = pmean(torch.mean(torch.sum(rewards, dim=1)), data_group)
    obs_f, act_f, adv_f = obs.reshape(B, do), actions.reshape(B, da), \
        adv.reshape(B)

    # ---- 2) the surrogate gradient at theta_old by autograd through the
    # sharded forward: each rank's shards of the global gradient
    with record_function("trpo/surrogate_grad"):
        keys = sorted(local)
        with torch.enable_grad():
            leaves = [local[k].detach().requires_grad_(True) for k in keys]
            mu, logstd = dist_tp(dict(zip(keys, leaves)), obs_f, model_group)
            logp = policy.log_prob(mu, logstd, act_f)
            mu_old, logp_old = mu.detach(), logp.detach()
            surr = torch.mean(torch.exp(logp - logp_old) * adv_f)
            g = torch.cat([x.reshape(-1) for x in
                           torch.autograd.grad(surr, leaves)])
        surr_old = torch.mean(adv_f)                           # ratio == 1
        g, surr_old = pmean((g, surr_old), data_group)

    # ---- 3) CG on the damped sharded GN-FVP over obs_f[::k]
    k = tr.fvp_subsample
    vdot = make_vdot(local, model_group)
    with record_function("trpo/cg_fvp"):
        obs_fvp = (obs_f[::k] if k > 1 else obs_f).clone(
            memory_format=torch.contiguous_format)
        fvp = make_gn_fvp_tp(local, obs_fvp, tr.cg_damping, data_group,
                             model_group)
        x, r_final, cg_residual = conjugate_gradient(fvp, g, tr.cg_iters,
                                                     vdot=vdot)
        # ---- 4) step size from the CG invariant
        xhx = vdot(x, g) - vdot(x, r_final)
        beta = torch.sqrt(2.0 * tr.delta / (xhx + 1e-12))

    # ---- 5) the batched line search over the whole batch
    theta_old = policy.flatten(local)

    # the candidates' pass of the feature-first layout on (1, d, B) views
    ls = (obs_f.T[None], act_f.T[None], adv_f[None], mu_old.T[None],
          logp_old[None])

    def eval_fn(thetas):
        return pmean(_eval_candidates(local, thetas, *ls, local["logstd"],
                                      model_group=model_group), data_group)

    with record_function("trpo/line_search"):
        theta_new, accepted, kl_new, surr_new = line_search(
            eval_fn, theta_old, beta * x, surr_old, tr.delta, tr.ls_steps,
            tr.ls_backtrack)
    step = theta_new - theta_old
    stats = dict(
        beta=beta, accepted=accepted, kl=kl_new, surr=surr_new,
        surr_old=surr_old, g_norm=torch.sqrt(vdot(g, g)),
        step_norm=torch.sqrt(vdot(step, step)), cg_residual=cg_residual,
        xhx=xhx, entropy=policy.entropy(local["logstd"]),
        mean_return=mean_return, adv_std=std)
    if return_directions:
        stats["g"] = _unshard_flat(g, local, n_model, model_rank, model_group)
        stats["x"] = _unshard_flat(x, local, n_model, model_rank, model_group)
    return policy.unflatten(theta_new, local), w_new, stats
