"""Generalised Advantage Estimation (port of
``trpo_robot_control_tpu/ops/gae.py``).

a_t = delta_t + (gamma * lam) * nonterm_t * a_{t+1}, evaluated as a reverse
loop over time: one fused multiply-add launch per step. ``dones`` marks
steps whose post-step state ended the episode; without it, episodes end
only at t = T-1.
"""
from __future__ import annotations

import torch


def _nonterm(rewards, dones, time_axis: int):
    if dones is None:
        T = rewards.shape[time_axis]
        ones = torch.ones(T, dtype=rewards.dtype, device=rewards.device)
        # fill_, not an assignment, which copies a host scalar (a CUDA
        # graph capture refuses that copy)
        ones[-1].fill_(0.0)
        shape = [1, 1]
        shape[time_axis] = T
        return ones.reshape(shape).expand(rewards.shape)
    return 1.0 - dones.to(rewards.dtype)


def gae(rewards, values, gamma: float, lam: float, dones=None,
        time_axis: int = 1):
    """rewards/values (N, T) [, dones (N, T)] -> raw advantages (N, T);
    time_axis=0 takes and returns (T, N), the rollout kernel's layout."""
    nonterm = _nonterm(rewards, dones, time_axis)
    if time_axis == 1:
        rewards, values, nonterm = rewards.T, values.T, nonterm.T
    next_v = torch.cat([values[1:], torch.zeros_like(values[:1])], dim=0)
    delta = rewards + gamma * next_v * nonterm - values
    coeff = (gamma * lam) * nonterm
    adv = torch.empty_like(delta)
    T = delta.shape[0]
    adv[T - 1] = delta[T - 1]
    for t in range(T - 2, -1, -1):
        torch.addcmul(delta[t], coeff[t], adv[t + 1], out=adv[t])
    return adv if time_axis == 0 else adv.T
