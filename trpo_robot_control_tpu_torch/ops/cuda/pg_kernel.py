"""K5: surrogate-gradient pass at theta_old (``csrc/pg.cu``).

Replaces ``pallas_surrogate_grad_ff`` in
``trpo_robot_control_tpu/ops/pallas/pg_kernel.py``: one pass over the
feature-first (T, d, N) batch as the rollout stores it (bf16 or fp32 obs
and actions, fp32 advantages) gives the closed-form gradient of the
surrogate at theta_old, the old means mu (T, da, N) and log-likelihoods
logp (T, N). The TPU kernel's lane-pair packing, block-diagonal weights,
ones-row bias fold and accumulator rotation are matrix-unit tricks and are
not carried over.

It takes any tanh policy of 1-3 hidden layers of 1-64 units (one library
per policy shape other than (64, 64); past them, ROADMAP B3). In bf16 mode
(c3-c5) the products run on the tensor cores and stay exact
against the fp32 weights: the kernel's prologue splits each weight into
three bf16 planes as ``split3`` does, so a bf16 activation times the three
planes is the fp32 product (the TPU kernel rounds its weights to bf16
instead). The fp32 mode runs on the CUDA cores.

``surrogate_grad`` is the wrapper: the CUDA kernel on CUDA tensors (or it
raises), ``surrogate_grad_plain`` on CPU tensors, which is
``models/policy.surrogate_grad_ff`` with the storage dtype's rounding.
Both return (g_tree, mu_ff, logp_old), like the JAX kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ...models import policy

# fixed, so the reduction order does not depend on the card: two blocks on
# each of an H100's 132 SMs
MAX_BLOCKS = 264
TILE = 64           # samples per tile, both modes (csrc/pg.cu: S, TS)

_SIG = {"trpo_pg_launch": [ctypes.c_void_p] * 4 + [ctypes.c_int]
        + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]}


def split3(w):
    """fp32 w -> bf16 planes (hi, mid, lo) with hi + mid + lo == w exactly
    (for |w| above about 2^-100: three 8-bit significands hold fp32's 24,
    and bf16 has fp32's exponent range). The bf16 kernel's prologue splits
    W0 and W1 so."""
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def surrogate_grad_plain(params, obs_ff, act_ff, adv_ff):
    """The kernel's math in plain PyTorch: the closed-form surrogate
    gradient with the rounding points of ``obs_ff``'s storage dtype."""
    surrogate_grad_plain.calls += 1
    store = torch.bfloat16 if obs_ff.dtype == torch.bfloat16 else None
    return policy.surrogate_grad_ff(params, obs_ff, act_ff, adv_ff,
                                    store_dtype=store)


surrogate_grad_plain.calls = 0


def surrogate_grad(params, obs_ff, act_ff, adv_ff):
    """obs_ff (T, do, N), act_ff (T, da, N) (both fp32 or both bf16),
    adv_ff (T, N) fp32 -> (g_tree, mu_ff (T, da, N), logp_old (T, N))."""
    if not obs_ff.is_cuda:
        return surrogate_grad_plain(params, obs_ff, act_ff, adv_ff)
    T, do, N = obs_ff.shape
    da = act_ff.shape[1]
    hidden = build.hidden_shape(params, "pg")
    if do > 32 or da > 8:
        raise NotImplementedError("the surrogate-gradient kernel takes "
                                  "obs_dim <= 32, act_dim <= 8")
    dt = obs_ff.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError("obs_ff must be fp32 or bf16")
    dev = obs_ff.device
    checks = [("obs_ff", obs_ff, dt, (T, do, N)),
              ("act_ff", act_ff, dt, (T, da, N)),
              ("adv_ff", adv_ff, torch.float32, (T, N))] + [
        (k, params[k], torch.float32, tuple(params[k].shape))
        for k in sorted(params)]
    for name, x, want, shape in checks:
        if (x.dtype != want or x.device != dev or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {want} {shape} "
                             f"tensor on {dev}")
    P = sum(params[k].numel() for k in params)
    n_blocks = min(T * -(-N // TILE), MAX_BLOCKS)
    partial = torch.empty(n_blocks * P, device=dev)
    g = torch.empty(P, device=dev)
    mu = torch.empty(T, da, N, device=dev)
    logp = torch.empty(T, N, device=dev)
    lib = build.library(build.lib_name("pg", hidden=hidden), _SIG)
    err = lib.trpo_pg_launch(
        *(build.ptr(x) for x in (obs_ff, act_ff, adv_ff)),
        *build.policy_args(params, hidden),
        *(build.ptr(x) for x in (mu, logp, partial, g)),
        T, do, da, N, n_blocks, int(dt == torch.bfloat16),
        build.stream_handle(dev))
    build.check(err, "surrogate-gradient kernel")
    surrogate_grad.launches += 1
    return policy.unflatten(g, params), mu, logp


surrogate_grad.launches = 0
