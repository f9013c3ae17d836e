"""K3: Gauss-Newton Fisher-vector product (``csrc/fvp.cu``).

Replaces ``make_pallas_gn_fvp`` in
``trpo_robot_control_tpu/ops/pallas/fvp_kernel.py``: per CG call, one pass
over batch-major samples (forward tangent through the tanh MLP,
u = dmu * inv_var / B, reverse accumulation of J^T u), with the hidden
activations computed once per update by ``activations``. The TPU kernel's
sample-pair packing is a matrix-unit trick and is not carried over.

``gn_fvp`` is the wrapper: the CUDA kernel on CUDA tensors (or it raises),
``gn_fvp_plain`` on CPU tensors. Both return the damped product
J^T M J v + damping v as one flat vector in sorted-key order, with the
logstd block 2 v analytic.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ...models import policy

HIDDEN = 64
MAX_BLOCKS = 256    # fixed, so the reduction order does not depend on the card
TILE = 64           # samples per tile (csrc/fvp.cu: S)

_SIG = {"trpo_fvp_launch": [ctypes.c_void_p] * 9
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p]}


def activations(params, obs):
    """Hidden activations [h_0, ..., h_{L-1}], each (B, h): computed once
    per update, constant across the CG calls."""
    hs, h = [], obs
    for l in range(policy.n_layers(params) - 1):
        h = torch.tanh(h @ params[f"W{l}"] + params[f"b{l}"])
        hs.append(h)
    return hs


def gn_fvp_plain(params, obs, hs, scale, v, damping: float):
    """The kernel's math in plain PyTorch. scale = exp(-2 logstd) / B."""
    gn_fvp_plain.calls += 1
    return gn_fvp_math(params, obs, hs, scale, v, damping)


def gn_fvp_math(params, obs, hs, scale, v, damping: float):
    """J^T M J v + damping v on batch-major fp32 samples (shared by the
    plain versions of this kernel and of the feature-first one)."""
    L = len(hs)
    t = policy.unflatten(v, params)
    a = obs @ t["W0"] + t["b0"]
    dh = (1.0 - hs[0] * hs[0]) * a
    for l in range(1, L + 1):
        a = dh @ params[f"W{l}"] + hs[l - 1] @ t[f"W{l}"] + t[f"b{l}"]
        if l < L:
            dh = (1.0 - hs[l] * hs[l]) * a
    g = a * scale
    out = {"logstd": 2.0 * t["logstd"]}
    for l in range(L, 0, -1):
        out[f"W{l}"] = hs[l - 1].T @ g
        out[f"b{l}"] = g.sum(0)
        g = (g @ params[f"W{l}"].T) * (1.0 - hs[l - 1] * hs[l - 1])
    out["W0"] = obs.T @ g
    out["b0"] = g.sum(0)
    return policy.flatten(out) + damping * v


gn_fvp_plain.calls = 0


def gn_fvp(params, obs, hs, scale, v, damping: float):
    if not obs.is_cuda:
        return gn_fvp_plain(params, obs, hs, scale, v, damping)
    B, do = obs.shape
    da = params["logstd"].shape[0]
    if len(hs) != 2 or any(h.shape != (B, HIDDEN) for h in hs):
        raise NotImplementedError("the FVP kernel takes a (64, 64) tanh policy")
    if do > 32 or da > 8:
        raise NotImplementedError("the FVP kernel takes obs_dim <= 32, "
                                  "act_dim <= 8")
    P = v.shape[0]
    Pg = P - da
    if P != do * HIDDEN + HIDDEN * HIDDEN + HIDDEN * da + 2 * HIDDEN + 2 * da:
        raise ValueError(f"v has {P} entries, not the policy's parameter count")
    ins = (obs, hs[0], hs[1], params["W1"], params["W2"], scale, v)
    for x in ins:
        if x.dtype != torch.float32 or x.device != obs.device \
                or not x.is_contiguous():
            raise ValueError("FVP kernel inputs must be contiguous fp32 "
                             f"tensors on {obs.device}")
    n_blocks = min(-(-B // TILE), MAX_BLOCKS)
    partial = torch.empty(n_blocks * Pg, device=obs.device)
    out = torch.empty_like(v)
    lib = build.library("fvp", _SIG)
    err = lib.trpo_fvp_launch(*(build.ptr(x) for x in ins),
                              build.ptr(partial), build.ptr(out), B, do, da,
                              float(damping), n_blocks,
                              build.stream_handle(obs.device))
    build.check(err, "FVP kernel")
    gn_fvp.launches += 1
    return out


gn_fvp.launches = 0
