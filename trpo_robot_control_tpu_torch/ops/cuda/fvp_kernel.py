"""K3: Gauss-Newton Fisher-vector product (``csrc/fvp.cu``).

Replaces ``make_pallas_gn_fvp`` in
``trpo_robot_control_tpu/ops/pallas/fvp_kernel.py``: per CG call, one pass
over batch-major samples (forward tangent through the tanh MLP,
u = dmu * inv_var / B, reverse accumulation of J^T u), with the hidden
activations computed once per update by ``activations``. The TPU kernel's
sample-pair packing is a matrix-unit trick and is not carried over. The
64-wide products run on the tensor cores and stay exact to fp32: every
fp32 operand is split into three bf16 planes as ``pg_kernel.split3`` does
and the six plane products that hold fp32's 24 bits are summed, as in the
feature-first kernel. W1's planes are split once per update, with the
scratch every call reuses (``workspace``); v's W0 and W1 blocks once per
call ahead of the kernel.

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
# fixed, so the reduction order does not depend on the card: one block (8
# warps, ~206 KB of shared memory) on each of an H100's 132 SMs
MAX_BLOCKS = 132
TILE = 128          # samples per tile, 16 a warp (csrc/fvp.cu: TS)

_SIG = {"trpo_fvp_launch": [ctypes.c_void_p] * 10
        + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                ctypes.c_void_p],
        "trpo_fvp_split_launch": [ctypes.c_void_p] * 3,
        "trpo_fvp_occupancy": [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}


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


def workspace(params, obs):
    """The device buffers every CG call of an update shares: W1's three
    bf16 planes (3, 64, 64), split here once for every launch, and the
    scratch for v's planes and the per-block partials; None for CPU tensors
    (the plain version needs none)."""
    W1 = params["W1"]
    if not obs.is_cuda:
        return None
    if W1.shape != (HIDDEN, HIDDEN) or W1.dtype != torch.float32 \
            or not W1.is_contiguous() or W1.device != obs.device:
        raise NotImplementedError("the FVP kernel takes a (64, 64) tanh "
                                  "policy with contiguous fp32 weights "
                                  "(other shapes: ROADMAP B3)")
    B, do = obs.shape
    da = params["logstd"].shape[0]
    Pg = do * HIDDEN + HIDDEN * HIDDEN + HIDDEN * da + 2 * HIDDEN + da
    w1p = torch.empty(3, HIDDEN, HIDDEN, dtype=torch.bfloat16,
                      device=W1.device)
    err = build.library("fvp", _SIG).trpo_fvp_split_launch(
        build.ptr(W1), build.ptr(w1p), build.stream_handle(W1.device))
    build.check(err, "FVP kernel's weight split")
    vplanes = torch.empty(3 * (do + HIDDEN) * HIDDEN, dtype=torch.bfloat16,
                          device=obs.device)
    partial = torch.empty(min(-(-B // TILE), MAX_BLOCKS) * Pg,
                          device=obs.device)
    return w1p, vplanes, partial


def gn_fvp(params, obs, hs, scale, v, damping: float, ws):
    """The damped Fv for a flat v; ``ws``: ``workspace(params, obs)``."""
    if not obs.is_cuda:
        return gn_fvp_plain(params, obs, hs, scale, v, damping)
    B, do = obs.shape
    da = params["logstd"].shape[0]
    if len(hs) != 2 or any(h.shape != (B, HIDDEN) for h in hs):
        raise NotImplementedError("the FVP kernel takes a (64, 64) tanh "
                                  "policy (other shapes: ROADMAP B3)")
    if do > 32 or da > 8:
        raise NotImplementedError("the FVP kernel takes obs_dim <= 32, "
                                  "act_dim <= 8")
    P = v.shape[0]
    Pg = P - da
    if P != do * HIDDEN + HIDDEN * HIDDEN + HIDDEN * da + 2 * HIDDEN + 2 * da:
        raise ValueError(f"v has {P} entries, not the policy's parameter count")
    for x in (obs, hs[0], hs[1], params["W2"], scale, v):
        if x.dtype != torch.float32 or x.device != obs.device \
                or not x.is_contiguous():
            raise ValueError("FVP kernel inputs must be contiguous fp32 "
                             f"tensors on {obs.device}")
    # the kernel copies x and h0 16 bytes at a time and reads h1 by pairs
    if any(x.data_ptr() % 16 for x in (obs, hs[0], hs[1])):
        raise ValueError("FVP kernel inputs x, h0, h1 must start on a "
                         "16-byte boundary")
    n_blocks = min(-(-B // TILE), MAX_BLOCKS)
    w1p, vplanes, partial = ws
    if vplanes.numel() != 3 * (do + HIDDEN) * HIDDEN \
            or partial.numel() != n_blocks * Pg:
        raise ValueError("the FVP workspace was made for another shape")
    out = torch.empty_like(v)
    lib = build.library("fvp", _SIG)
    err = lib.trpo_fvp_launch(
        *(build.ptr(x) for x in (obs, hs[0], hs[1], w1p, params["W2"], scale,
                                 v, vplanes, partial, out)),
        B, do, da, float(damping), n_blocks, build.stream_handle(obs.device))
    build.check(err, "FVP kernel")
    gn_fvp.launches += 1
    return out


gn_fvp.launches = 0


def occupancy(do: int, da: int) -> dict:
    """What the card makes of the kernel's instantiation for obs_dim ``do``
    and act_dim ``da``: resident blocks and warps per SM, registers and
    local (spill) bytes per thread, dynamic and static shared bytes per
    block."""
    out = (ctypes.c_int * 6)()
    err = build.library("fvp", _SIG).trpo_fvp_occupancy(do, da, out)
    build.check(err, "FVP kernel occupancy")
    blocks, regs, local, dyn, static, threads = out
    return dict(blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
                registers=regs, local_bytes=local, smem_dynamic=dyn,
                smem_static=static, threads=threads)
