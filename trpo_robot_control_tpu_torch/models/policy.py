"""Gaussian tanh-MLP policy (port of ``trpo_robot_control_tpu/models/policy.py``).

Parameters are a flat dict ``{W0, b0, ..., WL, bL, logstd}`` with the same
keys as the JAX package and the fp64 oracle. ``flatten`` concatenates the
leaves in sorted-key order (``W0, W1, W2, b0, b1, b2, logstd``), which is
the order ``jax.flatten_util.ravel_pytree`` uses, so flat ``g``/``x``
vectors compare directly with the reference's.

The ``*_ff`` forms consume the rollout kernel's feature-first (T, d, N)
layout: the surrogate gradient at theta_old is written out by hand (the
importance ratio is 1 there, so its output cotangent is closed-form).
"""
from __future__ import annotations

import math

import torch

LOG2PI = math.log(2.0 * math.pi)


def init_params(gen: torch.Generator, obs_dim, act_dim, hidden, logstd_init):
    """Scaled Gaussian weights (small final layer), zero biases. Draws from
    ``gen`` on its own device."""
    assert len(hidden) < 9, "sorted-key flattening assumes < 10 layers"
    dev = gen.device
    sizes = [obs_dim] + list(hidden) + [act_dim]
    n = len(sizes) - 1
    params = {}
    for i in range(n):
        scale = 1.0 / math.sqrt(sizes[i])
        if i == n - 1:
            scale *= 0.01
        params[f"W{i}"] = scale * torch.randn(
            sizes[i], sizes[i + 1], generator=gen, device=dev)
        params[f"b{i}"] = torch.zeros(sizes[i + 1], device=dev)
    params["logstd"] = torch.full((act_dim,), float(logstd_init), device=dev)
    return params


def n_layers(params):
    return sum(1 for k in params if k.startswith("W"))


def flatten(params) -> torch.Tensor:
    """Leaves in sorted-key order, each row-major (``ravel_pytree``)."""
    return torch.cat([params[k].reshape(-1) for k in sorted(params)])


def unflatten(flat: torch.Tensor, like) -> dict:
    """Inverse of ``flatten`` with the shapes of ``like``; leading dims of
    ``flat`` (a batch of vectors) are kept in front of each leaf."""
    out, off = {}, 0
    lead = flat.shape[:-1]
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[..., off:off + n].reshape(*lead, *like[k].shape)
        off += n
    return out


def mean_net(params, obs):
    """obs (..., do) -> mu (..., da). tanh MLP, linear head."""
    h = obs
    L = n_layers(params)
    for i in range(L - 1):
        h = torch.tanh(h @ params[f"W{i}"] + params[f"b{i}"])
    return h @ params[f"W{L - 1}"] + params[f"b{L - 1}"]


def dist(params, obs):
    return mean_net(params, obs), params["logstd"]


def log_prob(mu, logstd, actions):
    z = (actions - mu) * torch.exp(-logstd)
    return -0.5 * torch.sum(z ** 2 + 2.0 * logstd + LOG2PI, dim=-1)


def kl(mu_old, logstd_old, mu_new, logstd_new):
    """Mean over the batch of KL(old || new), diagonal Gaussians."""
    var_old = torch.exp(2.0 * logstd_old)
    var_new = torch.exp(2.0 * logstd_new)
    per_dim = (logstd_new - logstd_old
               + (var_old + (mu_old - mu_new) ** 2) / (2.0 * var_new) - 0.5)
    return torch.mean(torch.sum(per_dim, dim=-1))


def entropy(logstd):
    return torch.sum(logstd + 0.5 * (1.0 + LOG2PI))


# --------------------------------------------------------- feature-first

def store_round(x, store_dtype):
    """Round to the storage dtype and hold the result in fp32. A bf16 x
    bf16 -> fp32 contraction is emulated by contracting the upcast
    operands in fp32: their products are exact there."""
    return x if store_dtype is None else x.to(store_dtype).float()


def hidden_ff(params, obs_ff, store_dtype=None):
    """obs_ff (T, do, N) -> all hidden activations [(T, h, N), ...], fp32.

    With ``store_dtype=torch.bfloat16`` each tanh output is rounded to
    bf16 (the JAX package stores them so); every contraction still
    accumulates fp32 against the fp32 weights."""
    hs = []
    h = obs_ff.float()
    for i in range(n_layers(params) - 1):
        h = store_round(torch.tanh(
            torch.einsum("io,tin->ton", params[f"W{i}"], h)
            + params[f"b{i}"][None, :, None]), store_dtype)
        hs.append(h)
    return hs


def dist_ff(params, obs_ff, hs=None):
    """-> (mu_ff (T, da, N), logstd)."""
    L = n_layers(params)
    h = (hs or hidden_ff(params, obs_ff))[-1]
    mu = torch.einsum("io,tin->ton", params[f"W{L - 1}"], h) \
        + params[f"b{L - 1}"][None, :, None]
    return mu, params["logstd"]


def log_prob_ff(mu_ff, logstd, act_ff):
    """(T, da, N) operands -> per-sample logp (T, N)."""
    z = (act_ff - mu_ff) * torch.exp(-logstd)[None, :, None]
    da = mu_ff.shape[1]
    return -0.5 * (torch.sum(z ** 2, dim=1)
                   + 2.0 * torch.sum(logstd) + da * LOG2PI)


def kl_ff(mu_old_ff, logstd_old, mu_new_ff, logstd_new):
    """Mean over the batch of KL(old || new) on (T, da, N) means."""
    var_old = torch.exp(2.0 * logstd_old)
    var_new = torch.exp(2.0 * logstd_new)
    quad = torch.mean(torch.sum((mu_old_ff - mu_new_ff) ** 2
                                / (2.0 * var_new)[None, :, None], dim=1))
    const = torch.sum(logstd_new - logstd_old
                      + var_old / (2.0 * var_new) - 0.5)
    return quad + const


def surrogate_grad_ff(params, obs_ff, act_ff, adv_ff, hs=None,
                      store_dtype=None):
    """Closed-form gradient of the surrogate at theta_old in (T, d, N)
    layout. Returns (g_tree, mu_ff, logp_old (T, N)), all fp32.

    With ``store_dtype=torch.bfloat16`` it rounds where the JAX package
    does: the hidden activations after tanh and each back-propagated
    cotangent after ``* (1 - h^2)``; the output cotangent u stays fp32 and
    every contraction accumulates fp32 against fp32 weights."""
    L = n_layers(params)
    T, do, N = obs_ff.shape
    B = T * N
    obs_ff, act_ff = obs_ff.float(), act_ff.float()
    hs = hs or hidden_ff(params, obs_ff, store_dtype)
    mu, logstd = dist_ff(params, obs_ff, hs=hs)
    inv_var = torch.exp(-2.0 * logstd)
    z = (act_ff - mu) * torch.exp(-logstd)[None, :, None]
    logp_old = -0.5 * (torch.sum(z ** 2, dim=1)
                       + 2.0 * torch.sum(logstd) + mu.shape[1] * LOG2PI)

    # output cotangent: ratio == 1 at theta_old
    u = adv_ff[:, None, :] * (act_ff - mu) * inv_var[None, :, None] / B
    g = {"logstd": torch.mean(adv_ff[:, None, :] * (z * z - 1.0),
                              dim=(0, 2))}
    ct = u
    for l in range(L - 1, 0, -1):
        h_in = hs[l - 1]
        g[f"W{l}"] = torch.einsum("tin,ton->io", h_in, ct)
        g[f"b{l}"] = torch.sum(ct, dim=(0, 2))
        ct = store_round(torch.einsum("io,ton->tin", params[f"W{l}"], ct)
                         * (1.0 - h_in * h_in), store_dtype)
    g["W0"] = torch.einsum("tin,ton->io", obs_ff, ct)
    g["b0"] = torch.sum(ct, dim=(0, 2))
    return g, mu, logp_old
