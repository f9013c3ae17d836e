"""KL-constrained backtracking line search (port of
``trpo_robot_control_tpu/ops/linesearch.py``).

Accept the first exponent k with surrogate improvement AND mean KL <= delta;
if none accepts, keep theta_old (accepted = -1, kl = 0, surr = surr_old).
All ``steps`` candidates are evaluated in one batched call and the first
accepted one is picked with tensor ops: fixed shapes and no host sync per
candidate, the same result as the reference's early-exit loop.
"""
from __future__ import annotations

import torch


def line_search(eval_fn, theta_old, full_step, surr_old, delta: float,
                steps: int, backtrack: float):
    """eval_fn(thetas (K, P)) -> (surrogate (K,), kl (K,)).

    Returns (theta_new, accepted_k, kl_at_accept, surr_at_accept)."""
    k = torch.arange(steps, dtype=torch.float32, device=theta_old.device)
    coef = torch.full_like(k, backtrack) ** k
    cands = theta_old[None, :] + coef[:, None] * full_step[None, :]
    surr, kl = eval_fn(cands)
    ok = (surr > surr_old) & (kl <= delta)
    any_ok = ok.any()
    first = torch.argmax(ok.to(torch.int32))
    accepted = torch.where(any_ok, first, torch.full_like(first, -1))
    # index_select, not cands[first]: indexing with a 0-dim tensor reads
    # it on the host (.item()), a device synchronisation
    pick = first.reshape(1)
    kl_f = kl.index_select(0, pick)[0]
    theta = torch.where(any_ok, cands.index_select(0, pick)[0], theta_old)
    kl_a = torch.where(any_ok, kl_f, torch.zeros_like(kl_f))
    surr_a = torch.where(any_ok, surr.index_select(0, pick)[0], surr_old)
    return theta, accepted, kl_a, surr_a
