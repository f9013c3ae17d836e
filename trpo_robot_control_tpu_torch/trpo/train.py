"""Training loop (port of ``trpo_robot_control_tpu/trpo/train.py``): one
rollout and one update per iteration, all on the device; the host reads
the scalar stats once per iteration.
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..device import resolve
from ..envs import arm
from ..models import baseline, policy
from .update import trpo_update


class TrainState(NamedTuple):
    params: dict
    w: object                 # baseline weights: a tensor, or the MLP's dict
    gen: torch.Generator      # parameter init, resets and rollout noise
    iteration: int


def init_state(cfg, seed: Optional[int] = None, device=None) -> TrainState:
    """The policy's weights, then (MLP baseline) the baseline's, drawn from
    one generator seeded with ``seed`` (default ``cfg.seed``); a linear
    baseline starts at zero."""
    dev = resolve(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(cfg.seed if seed is None else seed)
    params = policy.init_params(gen, cfg.obs_dim, cfg.arm.n_joints,
                                cfg.trpo.hidden, cfg.trpo.logstd_init)
    n_in = baseline.n_features(cfg.obs_dim)
    if cfg.trpo.baseline == "mlp":
        w = baseline.init_mlp(gen, n_in, cfg.trpo.baseline_hidden)
    else:
        w = torch.zeros(n_in, device=dev)
    return TrainState(params=params, w=w, gen=gen, iteration=0)


def make_train_step(cfg):
    """Returns ``train_step(state) -> (state, stats)``; stats are device
    tensors. A terminating config adds ``early_dones``, the number of
    env-steps before the last that ended an episode."""
    rollout_fn = arm.make_rollout_fn(cfg)

    def train_step(state: TrainState):
        with record_function("trpo/rollout"):
            batch = rollout_fn(state.params, state.gen)
        params, w, stats = trpo_update(cfg, state.params, state.w, batch)
        if "dones_ff" in batch:
            # episodes ended before the buffer's end, counted on the device
            stats["early_dones"] = torch.sum(batch["dones_ff"][:-1])
        return TrainState(params=params, w=w, gen=state.gen,
                          iteration=state.iteration + 1), stats

    return train_step


def stats_to_host(stats) -> dict:
    """All scalar stats in one device-to-host copy."""
    keys = list(stats)
    vals = torch.stack([stats[k].to(torch.float64) for k in keys]).tolist()
    return dict(zip(keys, vals))


def train(cfg, n_iters: Optional[int] = None, seed: Optional[int] = None,
          log_fn=None, state: Optional[TrainState] = None, device=None,
          checkpoint_every: int = 0, checkpoint_dir: Optional[str] = None):
    """Run training; returns (final_state, history list of stat dicts).
    With ``checkpoint_every`` and ``checkpoint_dir`` a checkpoint is saved
    after every ``checkpoint_every``-th iteration of this call."""
    n_iters = cfg.n_iters if n_iters is None else n_iters
    if state is None:
        state = init_state(cfg, seed, device)
    else:
        resolve(state.gen.device)
    step = make_train_step(cfg)
    history = []
    for it in range(n_iters):
        t0 = time.perf_counter()
        state, stats = step(state)
        stats = stats_to_host(stats)
        stats["accepted"] = int(stats["accepted"])
        stats["iter"] = state.iteration
        stats["wall_s"] = time.perf_counter() - t0
        history.append(stats)
        if log_fn is not None:
            log_fn(stats)
        if checkpoint_every and checkpoint_dir and \
                (it + 1) % checkpoint_every == 0:
            from ..utils.checkpoint import save_checkpoint
            save_checkpoint(checkpoint_dir, cfg, state)
    return state, history
