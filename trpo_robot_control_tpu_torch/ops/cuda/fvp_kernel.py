"""K3: Gauss-Newton Fisher-vector product (``csrc/fvp.cu``).

Replaces ``make_pallas_gn_fvp`` in
``trpo_robot_control_tpu/ops/pallas/fvp_kernel.py``: per CG call, one pass
over batch-major samples (forward tangent through the tanh MLP,
u = dmu * inv_var / B, reverse accumulation of J^T u), with the hidden
activations computed once per update by ``activations``. It takes any
tanh policy of 1-3 hidden layers of 1-128 units (``build.hidden_shape``;
a policy other than the default (64, 64) builds a library of its own,
past those it raises NotImplementedError, naming ROADMAP B3). The TPU
kernel's sample-pair packing is a matrix-unit trick and is not carried
over. Up to 64 units the hidden layers' products run on the tensor
cores and stay exact to fp32: every fp32 operand is split into three
bf16 planes as ``pg_kernel.split3`` does and the six plane products that hold fp32's 24
bits are summed, as in the feature-first kernel. The hidden-to-hidden
weights' planes are split once per update, with the scratch every call
reuses (``workspace``); v's hidden-layer blocks once per call ahead of
the kernel. A layer over 64 units selects the kernel's wide form, as the
TPU kernel's widths select its unpacked ``_fvp_kernel``: the same
split-bf16 arithmetic on the tensor cores, run as a chain of launches
that each hold one layer's planes in shared memory (the forward tangent
layer by layer, the head, the reverse chain, then the weight gradients
over ``WIDE_SPLIT``-sample splits of the batch), with the per-sample
buffers between them in the workspace's scratch.

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

# fixed, so the reduction order does not depend on the card: one block on
# each of an H100's 132 SMs
MAX_BLOCKS = 132
# samples a tile at (64, 64): 16 a warp, 8 warps (csrc/fvp.cu: Pick; a
# policy whose layout does not fit 8 warps' takes 4, ``tile``)
TILE = 128
# the wide form's weight-gradient launch: samples a split (the grid's unit,
# ``tile``) and a chunk summed at a time (csrc/fvp.cu: wide::SPLIT, KC)
WIDE_SPLIT = 512
WIDE_CHUNK = 32

_SIG = {"trpo_fvp_launch": [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
        "trpo_fvp_split_launch": [ctypes.c_void_p, ctypes.c_int]
        + [ctypes.c_void_p] * 3,
        "trpo_fvp_tile": [ctypes.c_int, ctypes.c_int],
        "trpo_fvp_partial_floats": [ctypes.c_int] * 4,
        "trpo_fvp_occupancy": [ctypes.c_int] * 3 + [ctypes.c_void_p]}


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


def _pad(w: int) -> int:
    return -(-w // 16) * 16


def plane_sizes(hidden: tuple, do: int) -> tuple:
    """bf16 elements of the hidden-to-hidden weights' planes (each W_l's
    three, zero-padded to multiples of 16) and of v's per-call planes
    (dW0 (do, pad(w_0)) and each dW_l). The wide form (a layer over 64
    units) keeps each W_l's planes twice, as W_l and as W_l^T, and dW0's
    rows padded to 16 too."""
    p = [_pad(w) for w in hidden]
    inner = sum(a * b for a, b in zip(p, p[1:]))
    if max(hidden) > 64:
        return 6 * inner, 3 * (_pad(do) * p[0] + inner)
    return 3 * inner, 3 * (do * p[0] + inner)


def _library(hidden):
    return build.library(build.lib_name("fvp", None, hidden), _SIG)


def tile(do: int, da: int, hidden: tuple = build.DEFAULT_HIDDEN) -> int:
    """Samples a tile of the kernel for (do, da) and a policy of ``hidden``
    widths: the unit of the grid, whose reduction order it fixes."""
    ts = _library(hidden).trpo_fvp_tile(do, da)
    if ts <= 0:
        raise NotImplementedError("the FVP kernel takes obs_dim <= 32, "
                                  "act_dim <= 8")
    return ts


def partial_floats(hidden: tuple, B: int, do: int, da: int,
                   n_blocks: int) -> int:
    """Floats of the launch's scratch: the n_blocks per-block partials of
    the weight gradient and, in the wide form, the per-sample buffers
    (B x pad(w_l) each and u)."""
    n = _library(hidden).trpo_fvp_partial_floats(B, do, da, n_blocks)
    if n < 0:
        raise NotImplementedError("the FVP kernel takes obs_dim <= 32, "
                                  "act_dim <= 8")
    return n


def workspace(params, obs):
    """The device buffers every CG call of an update shares: the
    hidden-to-hidden weights' three bf16 planes each, split here once for
    every launch, and the scratch for v's planes, the per-block partials
    and the wide form's per-sample buffers; None for CPU tensors (the
    plain version needs none). Raises
    NotImplementedError, naming ROADMAP B3, for a policy the kernel does
    not take, before it builds anything."""
    if not obs.is_cuda:
        return None
    hidden = build.hidden_shape(params, "fvp")
    B, do = obs.shape
    da = params["logstd"].shape[0]
    for k, w in params.items():
        if w.dtype != torch.float32 or not w.is_contiguous() \
                or w.device != obs.device:
            raise ValueError(f"the FVP kernel takes contiguous fp32 weights "
                             f"on {obs.device}, not {k} {w.dtype} on "
                             f"{w.device}")
    ts = tile(do, da, hidden)
    n_w, n_v = plane_sizes(hidden, do)
    wplanes = torch.empty(max(n_w, 1), dtype=torch.bfloat16,
                          device=obs.device)
    err = _library(hidden).trpo_fvp_split_launch(
        *build.policy_args(params, hidden), build.ptr(wplanes),
        build.stream_handle(obs.device))
    build.check(err, "FVP kernel's weight split")
    vplanes = torch.empty(n_v, dtype=torch.bfloat16, device=obs.device)
    partial = torch.empty(partial_floats(hidden, B, do, da,
                                         min(-(-B // ts), MAX_BLOCKS)),
                          device=obs.device)
    return hidden, ts, wplanes, vplanes, partial


def gn_fvp(params, obs, hs, scale, v, damping: float, ws):
    """The damped Fv for a flat v; ``ws``: ``workspace(params, obs)``."""
    if not obs.is_cuda:
        return gn_fvp_plain(params, obs, hs, scale, v, damping)
    hidden = build.hidden_shape(params, "fvp")
    B, do = obs.shape
    da = params["logstd"].shape[0]
    if len(hs) != len(hidden) or any(h.shape != (B, w)
                                     for h, w in zip(hs, hidden)):
        raise ValueError(f"hs must be the ({B}, w) activations of the "
                         f"{hidden} policy")
    if do > 32 or da > 8:
        raise NotImplementedError("the FVP kernel takes obs_dim <= 32, "
                                  "act_dim <= 8")
    P = v.shape[0]
    if P != sum(w.numel() for w in params.values()):
        raise ValueError(f"v has {P} entries, not the policy's parameter count")
    for x in (obs, *hs, *params.values(), scale, v):
        if x.dtype != torch.float32 or x.device != obs.device \
                or not x.is_contiguous():
            raise ValueError("FVP kernel inputs must be contiguous fp32 "
                             f"tensors on {obs.device}")
    # the kernel copies x and h_0 .. h_{L-2} 16 bytes at a time and reads
    # h_{L-1} by pairs
    if any(x.data_ptr() % 16 for x in (obs, *hs)):
        raise ValueError("FVP kernel inputs x, h must start on a 16-byte "
                         "boundary")
    ws_hidden, ts, wplanes, vplanes, partial = ws
    n_blocks = min(-(-B // ts), MAX_BLOCKS)
    if ws_hidden != hidden or vplanes.numel() != plane_sizes(hidden, do)[1] \
            or partial.numel() != partial_floats(hidden, B, do, da, n_blocks):
        raise ValueError("the FVP workspace was made for another shape")
    out = torch.empty_like(v)
    hid, n_hid, weights = build.policy_args(params, hidden)
    hs_ptrs = (ctypes.c_void_p * len(hs))(*(h.data_ptr() for h in hs))
    err = _library(hidden).trpo_fvp_launch(
        hid, n_hid, weights, build.ptr(obs), hs_ptrs, build.ptr(wplanes),
        *(build.ptr(x) for x in (scale, v, vplanes, partial, out)),
        B, do, da, float(damping), n_blocks, build.stream_handle(obs.device))
    build.check(err, "FVP kernel")
    gn_fvp.launches += 1
    return out


gn_fvp.launches = 0


def occupancy(do: int, da: int, hidden: tuple = build.DEFAULT_HIDDEN
              ) -> dict:
    """What the card makes of the kernel's instantiation for obs_dim
    ``do``, act_dim ``da`` and a policy of ``hidden`` widths: resident
    blocks and warps per SM, registers and local (spill) bytes per thread,
    dynamic and static shared bytes per block, threads and samples a unit
    of work. The wide form's launches each under ``kernels``
    (``_kernel_name``), the figures of the one with the fewest resident
    warps at the top level."""
    hidden = build.check_hidden(hidden, "fvp")
    lib = _library(hidden)
    kernels = {}
    k = count = 0
    while k == 0 or k < count:
        out = (ctypes.c_int * 11)()
        build.check(lib.trpo_fvp_occupancy(do, da, k, out),
                    "FVP kernel occupancy")
        blocks, regs, local, dyn, static, threads, ts, count = out[:8]
        kernels[_kernel_name(*out[8:])] = dict(
            blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
            registers=regs, local_bytes=local, smem_dynamic=dyn,
            smem_static=static, threads=threads, tile=ts)
        k += 1
    if count == 1:
        return next(iter(kernels.values()))
    least = min(kernels.values(), key=lambda o: o["warps_per_sm"])
    return dict(least, kernels=kernels)


def _kernel_name(kind: int, layer: int, flags: int) -> str:
    """The wide form's launches: fwd<l> ("fwd0+1" where fwd<1> takes layer
    0 in, "+head" on the last), rev<l>, grad; "fvp" the tensor-core
    form's one kernel."""
    if kind == 1:
        return ("fwd0+1" if flags & 1 else f"fwd{layer}") \
            + ("+head" if flags & 2 else "")
    return {0: "fvp", 2: f"rev{layer}", 3: "grad"}[kind]
