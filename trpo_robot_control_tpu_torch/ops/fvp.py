"""Gauss-Newton Fisher-vector product (port of ``make_gn_fvp`` in
``trpo_robot_control_tpu/ops/fvp.py``).

F v = (1/B) sum_b J_b^T M J_b v + damping v, with J = d(mu, logstd)/dtheta
and M = diag(1/sigma^2, 2I): one forward tangent and one reverse pass per
call. The hidden activations, the bf16 planes of the hidden-to-hidden
weights that the kernel reads and its scratch are made once per update
and reused by every CG call. Each call goes through the FVP kernel's wrapper
(``ops/cuda/fvp_kernel.py``), which launches the CUDA kernel on a GPU
tensor and runs the plain PyTorch version of the same math on a CPU one.
"""
from __future__ import annotations

import torch

from .cuda import fvp_kernel


def make_gn_fvp(params, obs, damping: float):
    """obs: (B, do). Returns fvp(v_flat) -> flat damped Fv."""
    B = obs.shape[0]
    hs = fvp_kernel.activations(params, obs)
    scale = torch.exp(-2.0 * params["logstd"]) / B
    ws = fvp_kernel.workspace(params, obs)

    def fvp(v_flat):
        return fvp_kernel.gn_fvp(params, obs, hs, scale, v_flat, damping, ws)

    return fvp
