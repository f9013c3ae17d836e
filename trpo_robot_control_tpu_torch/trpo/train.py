"""Training loop (port of ``trpo_robot_control_tpu/trpo/train.py``): one
rollout and one update per iteration, all on the device; the host reads
the scalar stats once per iteration (``train``), or once per K iterations
(``make_train_many``, which on the card replays one captured CUDA graph of
the train step K times).
"""
from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
from torch.profiler import record_function

from ..device import resolve
from ..envs import arm
from ..models import baseline, policy
from ..ops import cuda as kernels
from .update import trpo_update

# eager steps on a side stream before a capture (kernel libraries built,
# cuBLAS and autograd initialised), on a copy of the state
WARMUP_STEPS = 3


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


def make_train_many(cfg, n_steps: int, mesh=None):
    """Returns ``fn(state) -> (state, stacked_stats)``: ``n_steps`` train
    steps with no host read between them (JAX's ``make_train_many``, a jit
    of ``lax.scan``). ``stacked_stats`` holds each stat of
    ``make_train_step`` as a device tensor of shape (n_steps,) in its own
    dtype; the returned state has ``iteration + n_steps``. As under JAX's
    ``donate_argnums=0`` the input state is consumed: the caller passes it
    on and does not use it again (its generator advances; its tensors may
    be written in place).

    On the CPU ``fn`` runs ``make_train_step`` n times and stacks the stats
    on the device. On the card it replays a CUDA graph of one train step n
    times (``GraphedStep``), each replay's stats copied into row i of the
    stacked buffer: no host synchronisation and no per-op Python between
    updates. The graph is captured at the first call and re-used while the
    state's tensors have the captured shapes and its generator is the
    registered one (the state is then copied into the graph's static
    tensors); any other state is captured anew. A capture that fails
    raises: there is no eager fallback. ``mesh`` (data parallelism) raises
    NotImplementedError: ROADMAP A5."""
    if mesh is not None:
        raise NotImplementedError(
            "make_train_many over a mesh (data parallelism) is not ported "
            "yet: ROADMAP A5")
    step = make_train_step(cfg)
    graphed = [None]

    def fn(state: TrainState):
        resolve(state.gen.device)
        if state.gen.device.type != "cuda":
            rows = []
            for _ in range(n_steps):
                state, stats = step(state)
                rows.append(stats)
            return state, {k: torch.stack([r[k] for r in rows])
                           for k in rows[0]}
        if graphed[0] is None or not graphed[0].fits(state):
            graphed[0] = None          # frees the old graph's pool first
            graphed[0] = GraphedStep(step, state)
        return graphed[0].run(state, n_steps)

    fn.graphed = lambda: graphed[0]
    return fn


def _leaves(w) -> dict:
    """The baseline weights as a dict of tensors (a linear baseline's one
    tensor under "w")."""
    return w if isinstance(w, dict) else {"w": w}


def _clone(w):
    """A copy of a tensor or of a dict of tensors."""
    return ({k: v.clone() for k, v in w.items()} if isinstance(w, dict)
            else w.clone())


def _copy_state(params, w, state) -> None:
    for dst, src in ((params, state.params), (_leaves(w), _leaves(state.w))):
        for k, x in dst.items():
            if src[k] is not x:
                x.copy_(src[k])


class GraphedStep:
    """One train step of ``step`` (``make_train_step``) captured as a CUDA
    graph from ``state``: it reads the static parameter and baseline
    tensors, copies the next ones back into them, and writes its stats,
    in fp64 (exact for every stat: fp32 values, an int64 exponent), into
    one static vector. The state's ``torch.Generator`` is registered with
    the graph, so each replay draws the rollout's Philox seed and resets
    from it and advances it exactly as an eager step does.

    Before the capture ``WARMUP_STEPS`` eager steps run on a side stream on
    a copy of the state (cloned tensors, a generator set to the state's
    generator state), leaving the caller's state as it was. ``launches``
    and ``plain_calls`` are the kernel counters' increments during the
    capture, which a replay does not move; ``warmup_s`` and ``capture_s``
    the host seconds of each part."""

    def __init__(self, step, state: TrainState):
        dev = state.gen.device
        self.gen = state.gen
        t0 = time.perf_counter()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            gen = torch.Generator(device=dev)
            gen.set_state(state.gen.get_state())
            warm = TrainState(_clone(state.params), _clone(state.w), gen, 0)
            for _ in range(WARMUP_STEPS):
                warm, _ = step(warm)
        torch.cuda.current_stream(dev).wait_stream(side)
        del warm
        self.params, self.w = _clone(state.params), _clone(state.w)
        t1 = time.perf_counter()
        self.warmup_s = t1 - t0
        before = kernels.launch_counts(), kernels.plain_calls()
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(self.gen)
        with torch.cuda.graph(self.graph):
            new, stats = step(TrainState(self.params, self.w, self.gen, 0))
            _copy_state(self.params, self.w, new)
            self.keys = list(stats)
            self.dtypes = [stats[k].dtype for k in self.keys]
            self.packed = torch.stack([stats[k].to(torch.float64)
                                       for k in self.keys])
        self.capture_s = time.perf_counter() - t1
        self.launches = {k: v - before[0][k]
                         for k, v in kernels.launch_counts().items()}
        self.plain_calls = {k: v - before[1][k]
                            for k, v in kernels.plain_calls().items()}

    def fits(self, state: TrainState) -> bool:
        """Whether ``state`` can run on this graph: the registered generator,
        and tensors of the captured shapes and dtypes."""
        def same(a, b):
            return a.keys() == b.keys() and all(
                a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                for k in a)
        return (state.gen is self.gen and same(self.params, state.params)
                and same(_leaves(self.w), _leaves(state.w)))

    def run(self, state: TrainState, n_steps: int):
        """``n_steps`` replays from ``state``; returns (state, stacked)."""
        _copy_state(self.params, self.w, state)
        rows = torch.empty(n_steps, len(self.keys), dtype=torch.float64,
                           device=self.packed.device)
        for i in range(n_steps):
            self.graph.replay()
            rows[i].copy_(self.packed)
        out = TrainState(params=_clone(self.params), w=_clone(self.w),
                         gen=self.gen, iteration=state.iteration + n_steps)
        return out, {k: rows[:, i].to(dt)
                     for i, (k, dt) in enumerate(zip(self.keys, self.dtypes))}


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
