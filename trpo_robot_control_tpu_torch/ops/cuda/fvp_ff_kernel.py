"""K6: Gauss-Newton FVP on the feature-first Fisher subsample
(``csrc/fvp_ff.cu``).

Replaces ``make_pallas_gn_fvp_ff`` in
``trpo_robot_control_tpu/ops/pallas/fvp_ff_kernel.py``: each CG call reads
the strided subsample obs_ff[::k, :, ::e] (T', do, N') in place, through
its time and env strides and in its storage dtype, recomputes the two
hidden activations, and runs the forward tangent and the reverse
accumulation. The logstd block 2 v and the damping are added in the
kernel's reduce pass. It takes any tanh policy of 1-3 hidden layers of
1-64 units (one library per policy shape other than (64, 64); past them,
ROADMAP B3). The hidden layers' products run on the tensor cores and
stay exact to fp32: the kernel splits every fp32 operand (weights, v,
activations, fp32-stored obs) into three bf16 planes as
``pg_kernel.split3`` does and sums the six plane products that hold
fp32's 24 bits (the TPU kernel rounds to bf16 instead).

``make_gn_fvp_ff`` returns ``fvp(v)``: the CUDA kernel on a CUDA
subsample (or it raises), ``gn_fvp_ff_plain`` on a CPU one. The plain
version is the batch-major GN-FVP math (``fvp_kernel.gn_fvp_math``) on the
subsample flattened to (B', do) and cast to fp32, which is the JAX
package's own route on the CPU.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .fvp_kernel import activations, gn_fvp_math
from ...models import policy
from ...parallel.collectives import pmean

# fixed, so the reduction order does not depend on the card: one block (188
# KB of shared memory at (64, 64)) on each of an H100's 132 SMs
MAX_BLOCKS = 132
TILE = 64           # samples per tile (csrc/fvp_ff.cu: TS; 32 where the
                    # policy's planes leave no room for 64, ``occupancy``)

_SIG = {"trpo_fvp_ff_launch": [ctypes.c_void_p] + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
        "trpo_fvp_ff_occupancy": [ctypes.c_int, ctypes.c_void_p]}


def gn_fvp_ff_plain(params, obs_sub_ff, v, damping: float):
    """The kernel's function in plain PyTorch: the damped GN-FVP on the
    subsample flattened to (B', do) in fp32."""
    gn_fvp_ff_plain.calls += 1
    Ts, do, N = obs_sub_ff.shape
    obs = obs_sub_ff.permute(0, 2, 1).reshape(-1, do).float()
    scale = torch.exp(-2.0 * params["logstd"]) / obs.shape[0]
    return gn_fvp_math(params, obs, activations(params, obs), scale, v,
                       damping)


gn_fvp_ff_plain.calls = 0


def _check(params, obs_sub_ff):
    Ts, do, N = obs_sub_ff.shape
    da = params["logstd"].shape[0]
    build.hidden_shape(params, "fvp_ff")
    if do > 32 or da > 8:
        raise NotImplementedError("the FVP kernel takes obs_dim <= 32, "
                                  "act_dim <= 8")
    if obs_sub_ff.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("the Fisher subsample must be fp32 or bf16")
    if min(obs_sub_ff.stride()) < 1:
        raise ValueError("the Fisher subsample must be a strided view with "
                         "positive strides")
    dev = obs_sub_ff.device
    for k in sorted(params):
        x = params[k]
        if x.dtype != torch.float32 or x.device != dev \
                or not x.is_contiguous():
            raise ValueError(f"{k}: need a contiguous fp32 tensor on {dev}")


def gn_fvp_ff(params, obs_sub_ff, scale, v, damping: float):
    """One kernel launch: the damped Fv for a flat v (P,)."""
    Ts, do, N = obs_sub_ff.shape
    da = params["logstd"].shape[0]
    dev = obs_sub_ff.device
    P = v.shape[0]
    if P != sum(params[k].numel() for k in params) or v.device != dev \
            or v.dtype != torch.float32 or not v.is_contiguous():
        raise ValueError("v must be a contiguous fp32 vector of the policy's "
                         f"parameter count on {dev}")
    hidden = build.hidden_shape(params, "fvp_ff")
    n_blocks = min(Ts * -(-N // TILE), MAX_BLOCKS)
    partial = torch.empty(n_blocks * (P - da), device=dev)
    out = torch.empty_like(v)
    lib = build.library(build.lib_name("fvp_ff", hidden=hidden), _SIG)
    err = lib.trpo_fvp_ff_launch(
        build.ptr(obs_sub_ff), *obs_sub_ff.stride(),
        *build.policy_args(params, hidden),
        *(build.ptr(x) for x in (scale, v, partial, out)),
        Ts, do, da, N, float(damping), n_blocks,
        int(obs_sub_ff.dtype == torch.bfloat16), build.stream_handle(dev))
    build.check(err, "feature-first FVP kernel")
    gn_fvp_ff.launches += 1
    return out


gn_fvp_ff.launches = 0


def make_gn_fvp_ff(params, obs_sub_ff, damping: float, axis_name=None):
    """obs_sub_ff: the (T', do, N') Fisher subsample, a time- and
    env-strided view of the stored batch. Returns fvp(v_flat) -> flat
    damped Fv, averaged over the ranks of ``axis_name`` (the mesh's 'data'
    process group; ``ops/fvp.py`` says why after the damping)."""
    if not obs_sub_ff.is_cuda:
        return lambda v: pmean(gn_fvp_ff_plain(params, obs_sub_ff, v,
                                               damping), axis_name)
    _check(params, obs_sub_ff)
    B = obs_sub_ff.shape[0] * obs_sub_ff.shape[2]
    scale = torch.exp(-2.0 * params["logstd"]) / B
    return lambda v: pmean(gn_fvp_ff(params, obs_sub_ff, scale, v, damping),
                           axis_name)


def occupancy(store_dtype=torch.bfloat16, hidden=build.DEFAULT_HIDDEN
              ) -> dict:
    """What the card makes of the kernel for a subsample stored in
    ``store_dtype`` and a policy of ``hidden`` widths: resident blocks and
    warps per SM, registers and local (spill) bytes per thread, dynamic
    and static shared bytes per block, samples a tile."""
    hidden = build.check_hidden(hidden, "fvp_ff")
    out = (ctypes.c_int * 7)()
    err = build.library(build.lib_name("fvp_ff", hidden=hidden),
                        _SIG).trpo_fvp_ff_occupancy(
        int(store_dtype == torch.bfloat16), out)
    build.check(err, "feature-first FVP kernel occupancy")
    blocks, regs, local, dyn, static, threads, tile = out
    return dict(blocks_per_sm=blocks, warps_per_sm=blocks * threads // 32,
                registers=regs, local_bytes=local, smem_dynamic=dyn,
                smem_static=static, threads=threads, tile=tile)
