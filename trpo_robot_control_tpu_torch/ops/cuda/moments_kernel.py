"""K2: baseline normal-equation moments (``csrc/moments.cu``).

Replaces ``pallas_baseline_moments`` in
``trpo_robot_control_tpu/ops/pallas/moments_kernel.py``: one read of
obs_ff (T, do, N) and the targets (T, N) gives the extended Gram of
v_ext = [obs; obs^2; y; tau_t] (2do+5 rows), whose blocks are every moment
of the ridge fit. (A, b) is assembled outside with the exact fp32
A_tt = N tau^T tau, as the TPU wrapper does. obs_ff may be fp32 or bf16
(c3's storage); in bf16 mode obs^2 and y are rounded to bf16 and tau
stays fp32, as ``models/baseline.normal_eq_ff`` rounds them, and the
products run on the tensor cores (``mma.sync``, exact bf16 products summed
in fp32), with a second launch summing the blocks' partials. fp32 mode is
one launch: register-blocked fp32 FMA over tiles of the flattened (t, n)
axis, and the cross-block sum in a fixed order behind two levels of
tickets (``fp32_grid``, ``fp32_scratch``; the tickets are the library's
own device array, so two fp32 calls on one device must not overlap).

``extended_gram`` is the wrapper: the CUDA kernel on CUDA tensors (or it
raises), ``extended_gram_plain`` on CPU tensors. ``baseline_moments`` is
the drop-in for ``models/baseline.normal_eq_ff``. The kernel is held
against ``extended_gram_plain``, which sums the same products in fp64:
the exact Gram of its inputs, not the fp32 sums of the JAX route.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from ...models.baseline import _time_features, assemble, data_rows

# fp32 mode (csrc/moments.cu: F32_S, F32_GRID, F32_GROUP): samples of the
# flattened (t, n) axis a tile; the most blocks, fixed, so the sum's order
# does not depend on the card; blocks a first-level sum
TILE = 128
F32_GRID = 132
F32_GROUP = 8
BF16_TILE = 256     # bf16 mode's envs of one step a tile (csrc/moments.cu: ST)
MAX_BLOCKS = 256    # bf16 mode's most blocks, fixed as F32_GRID is
MAX_OBS_DIM = 32

_SIG = {"trpo_moments_launch": [ctypes.c_void_p] * 5
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]}


def fp32_grid(T: int, N: int) -> int:
    """fp32 mode's blocks: the fewest that give every block the same most
    tiles, ceil(tiles / ceil(tiles / F32_GRID)); block b sums tiles b,
    b + grid, ..."""
    tiles = -(-T * N // TILE)
    return -(-tiles // -(-tiles // F32_GRID))


def fp32_scratch(grid: int, do: int) -> int:
    """fp32 mode's scratch floats: each block's partial, then each group's
    sum, E = R (R + 1) / 2 entries each."""
    R = 2 * do + 5
    return (grid + -(-grid // F32_GROUP)) * (R * (R + 1) // 2)


def extended_gram_plain(obs_ff, y, tau):
    """obs_ff (T, do, N) fp32 or bf16, y (T, N), tau (T, 4) -> the
    (2do+5, 2do+5) fp32 Gram; obs^2 and y are rounded to the storage
    dtype of obs_ff, tau stays fp32. The products are summed in fp64 and
    rounded to fp32 once, so the kernel's fp32 sums are held against the
    exact Gram of its inputs: an fp32 matrix product over c5's 13.1M
    samples drifts by ~2e-5 relative."""
    extended_gram_plain.calls += 1
    T, do, N = obs_ff.shape
    v = torch.cat([data_rows(obs_ff, y), tau[:, :, None].expand(T, 4, N)],
                  dim=1).double()
    return torch.einsum("tan,tbn->ab", v, v).float()


extended_gram_plain.calls = 0


def extended_gram(obs_ff, y, tau):
    """The (2do+5, 2do+5) Gram of ``extended_gram_plain``. In fp32 mode the
    kernel's cross-block tickets are one array a device, so calls on one
    device must not run at the same time (on two streams, or two graphs
    replayed at once)."""
    if not obs_ff.is_cuda:
        return extended_gram_plain(obs_ff, y, tau)
    T, do, N = obs_ff.shape
    if do > MAX_OBS_DIM:
        raise NotImplementedError(f"moments kernel takes obs_dim <= {MAX_OBS_DIM}")
    if obs_ff.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("obs_ff must be fp32 or bf16")
    bf16 = obs_ff.dtype == torch.bfloat16
    for name, x, shape in (("obs_ff", obs_ff, (T, do, N)), ("y", y, (T, N)),
                           ("tau", tau, (T, 4))):
        if (x.dtype != (obs_ff.dtype if x is obs_ff else torch.float32)
                or x.device != obs_ff.device
                or tuple(x.shape) != shape or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous {shape} tensor on "
                             f"{obs_ff.device} (fp32, obs_ff fp32 or bf16)")
    R = 2 * do + 5
    dev = obs_ff.device
    if bf16:
        n_blocks = min(T * -(-N // BF16_TILE), MAX_BLOCKS)
        partial = torch.empty(n_blocks * (R * (R + 1) // 2), device=dev)
    else:
        n_blocks = fp32_grid(T, N)
        partial = torch.empty(fp32_scratch(n_blocks, do), device=dev)
    gram = torch.empty(R, R, device=dev)
    lib = build.library("moments", _SIG)
    err = lib.trpo_moments_launch(
        build.ptr(obs_ff), build.ptr(y), build.ptr(tau), build.ptr(partial),
        build.ptr(gram), T, do, N, n_blocks, int(bf16),
        build.stream_handle(dev))
    build.check(err, "moments kernel")
    extended_gram.launches += 1
    return gram


extended_gram.launches = 0


def baseline_moments(obs_ff, targets_tn, horizon: int):
    """(A (F, F), b (F,)) for the ridge fit, in the features() order."""
    T, do, N = obs_ff.shape
    tau = _time_features(T, horizon, obs_ff.device)
    gram = extended_gram(obs_ff, targets_tn.contiguous(), tau)
    F2 = 2 * do + 1
    return assemble(gram[:F2, :F2], gram[:F2, F2:], tau, N, do)
