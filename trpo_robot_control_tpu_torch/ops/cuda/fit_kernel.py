"""The linear baseline's ridge solve (``csrc/fit_normal.cu``).

Replaces no Pallas kernel: the JAX package solves the normal equations
with XLA's ``jnp.linalg.eigh`` (``trpo_robot_control_tpu/models/
baseline.py:155``, ``fit_normal``). On the card ``torch.linalg.eigh``
checks its ``info`` on the host, a device synchronisation that a CUDA
graph cannot capture, so the card solves with this kernel instead: one
block of 7-24 warps, one launch a fit, no host read.

It computes what ``fit_normal_plain`` computes: Jacobi scaling
``d = sqrt(diag A + eps)``, ``A_s = A / (d d^T)``; a symmetric
eigendecomposition of A_s; every direction with
``lambda < rel_floor * lambda_max`` dropped; ``w = Q diag(1/lambda) Q^T
(b/d) / d``; a non-finite w made zero. The eigendecomposition is cyclic
two-sided Jacobi in round-robin (Brent-Luk) order: each round rotates
F/2 disjoint index pairs at once, with Rutishauser's angle formulas, and
a sweep is F - 1 rounds; the sweeps stop when the off-diagonal squares
sum to at most ``(TOL ||A_s||_F)^2``, at most ``MAX_SWEEPS`` of them.
Jacobi on the Jacobi-scaled matrix keeps the small eigenvalues' relative
accuracy that the ``rel_floor`` cut needs. The result depends only on the
kept spectral projector, not on the eigenvectors' order or signs, so it
agrees with the eigh solve to the rounding of fp32.

``fit_normal`` is the wrapper: the CUDA kernel on CUDA tensors (or it
raises), ``fit_normal_plain`` on CPU tensors. ``tests/test_torch_helpers
.fit_normal_jacobi_statement`` states the kernel's arithmetic in plain
PyTorch, op for op.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# csrc/fit_normal.cu: F_MAX, the largest system (2 * 32 + 4: obs_dim <= 32)
MAX_F = 68
# the stop rule: off-diagonal squares <= (TOL * ||A_s||_F)^2, and the cap
TOL = 1e-7
MAX_SWEEPS = 15

_SIG = {"trpo_fit_normal_launch": [ctypes.c_void_p] * 4
        + [ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_float,
           ctypes.c_int, ctypes.c_void_p]}


def fit_normal_plain(A, b, eps: float = 1e-20, rel_floor: float = 1e-6):
    """The eigh solve of JAX's ``fit_normal``, on any device; a non-finite
    system gives w = 0, as there."""
    fit_normal_plain.calls += 1
    d = torch.sqrt(torch.diagonal(A) + eps)
    A_s = A / (d[:, None] * d[None, :])
    # eigh refuses a non-finite matrix, where JAX's returns NaNs and the
    # guard below a zero w: a zero A_s gives that w
    A_s = torch.where(torch.isfinite(A_s).all(), A_s, torch.zeros_like(A_s))
    lam, Q = torch.linalg.eigh(A_s)
    inv = torch.where(lam > rel_floor * lam[-1], 1.0 / lam,
                      torch.zeros_like(lam))
    w_s = Q @ (inv * (Q.T @ (b / d)))
    w = w_s / d
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w))


fit_normal_plain.calls = 0


def jacobi_solve(A, b, eps: float = 1e-20, rel_floor: float = 1e-6):
    """The kernel's solve with the sweeps it ran: (w (F,), sweeps (1,)
    int32) on CUDA tensors, for the checks against its statement."""
    return _launch(A, b, eps, rel_floor, detail=True)


def fit_normal(A, b, eps: float = 1e-20, rel_floor: float = 1e-6):
    """w (F,) solving the ridge normal equations A w = b as
    ``fit_normal_plain`` does; A (F, F) symmetric, b (F,), fp32."""
    if not A.is_cuda:
        return fit_normal_plain(A, b, eps, rel_floor)
    return _launch(A, b, eps, rel_floor, detail=False)


fit_normal.launches = 0


def _launch(A, b, eps, rel_floor, detail):
    F = A.shape[0]
    if A.shape != (F, F) or F % 2 or not 2 <= F <= MAX_F:
        raise NotImplementedError(
            f"the fit_normal kernel takes an even F <= {MAX_F} (obs_dim "
            f"<= 32), not A of shape {tuple(A.shape)}")
    for name, x, shape in (("A", A, (F, F)), ("b", b, (F,))):
        if (x.dtype != torch.float32 or not x.is_cuda
                or x.device != A.device or tuple(x.shape) != shape
                or not x.is_contiguous()):
            raise ValueError(f"{name}: need a contiguous fp32 {shape} "
                             f"tensor on {A.device}")
    dev = A.device
    w = torch.empty(F, device=dev)
    sweeps = torch.empty(1, dtype=torch.int32, device=dev) if detail \
        else None
    lib = build.library("fit_normal", _SIG)
    err = lib.trpo_fit_normal_launch(
        build.ptr(A), build.ptr(b), build.ptr(w),
        build.ptr(sweeps) if detail else ctypes.c_void_p(None), F,
        float(eps), float(rel_floor), TOL * TOL, MAX_SWEEPS,
        build.stream_handle(dev))
    build.check(err, "fit_normal kernel")
    fit_normal.launches += 1
    return (w, sweeps) if detail else w
