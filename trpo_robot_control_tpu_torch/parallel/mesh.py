"""The ('data', 'model') mesh over ``torch.distributed``: data parallelism,
and the tensor-parallel update's mesh (port of
``trpo_robot_control_tpu/parallel/mesh.py``).

Design: SPMD data parallelism, one process per rank in the place of JAX's
``shard_map`` over devices. Envs are sharded over the mesh's 'data' axis,
parameters replicated: every rank rolls out its own ``n_envs / n_data``
envs and runs ``trpo_update`` on them with ``axis_name`` set to the
'data' process group, which all-reduces wherever a batch reduction
already exists (``trpo/update.py``, ``parallel/collectives.py``). Every
rank receives the same bits from each all-reduce and computes the rest
from them, so the parameters and baseline weights stay bit for bit the
same on every rank. The rollout, K2, K3/K6 and K5 run per rank on local
data through the same kernels as the unsharded path; the kernel gates read
the global batch.

Rank streams. The state's ``torch.Generator`` is the same on every rank.
Over a world of one the step draws its rollout from it, exactly as the
unsharded train step does, so a world of one replays that step bit for
bit. Over ``n_data > 1`` ranks, each step every rank seeds its rollout
generator from SHA-256 of (the state's generator state, its data index)
and reseeds the state's generator from SHA-256 of (that state, "next"),
the same on every rank: JAX's ``fold_in`` of the rollout key by the axis
index. Each rank draws a stream of its own; the streams are deterministic
for a fixed seed and world size; a checkpoint (rank 0's state, which every
rank holds) resumes them exactly. Reading a generator's state and seeding
one are host operations: no device synchronisation.

Tensor parallelism (``parallel/tensor.py``) over the mesh's 'model' axis:
rank r is (d, m) = (r // n_model, r % n_model), as JAX's
``devices.reshape(n_data, n_model)``. The ranks with the same m form a data
group, those with the same d a model group; every rank makes every group,
in the same order. The model ranks of one data index hold the same envs
(the rank stream folds the data index) and the same full parameters; the
update shards the policy's first two layers over them
(``make_sharded_update_tp``) and hands back the full parameters. An axis
of size one has no group (None): no collective runs over it.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import os
import threading
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve
from ..trpo.train import TrainState, init_state, make_train_step, run_steps
from ..trpo.update import trpo_update

DATA_AXIS = "data"
MODEL_AXIS = "model"
# the rendezvous timeout's environment variable, as JAX_DIST_INIT_TIMEOUT
TIMEOUT_ENV, DEFAULT_TIMEOUT_S = "TRPO_DIST_INIT_TIMEOUT", 120
# the feature-first keys: (T, d, N) and (T, N), envs on the last axis
FF_KEYS = ("obs_ff", "actions_ff", "rewards_ff", "dones_ff")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The mesh over the world: ``group``, the 'data' axis's process group
    (None over one data index, where n_model > 1); ``shape``, {"data":
    n_data, "model": n_model}; ``rank``, this process's index on 'data';
    ``device``, its device; ``model_group`` and ``model_rank``, the 'model'
    axis's group (None where n_model = 1) and this process's index on it."""
    group: object
    shape: dict
    rank: int
    device: torch.device
    model_group: object = None
    model_rank: int = 0


def init_distributed(timeout_s: Optional[int] = None):
    """Multi-process entry: joins the process group that torchrun's
    variables describe (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``; ``LOCAL_RANK`` picks the card, ``cli/train.py``).
    A no-op when they are unset. The group runs gloo for CPU tensors and,
    where there is a card, NCCL for CUDA ones (``make_mesh`` picks the
    data group's backend).

    A missing peer raises a one-line RuntimeError naming the rank, the
    world size and the address after ``timeout_s`` seconds (the
    TRPO_DIST_INIT_TIMEOUT variable, default 120), never a hang. The
    rendezvous (the store, the process group, a barrier through the store
    that every rank reaches) runs on a watchdog thread that this one waits
    for at most ``timeout_s``, since the store's client honours its own
    timeout only roughly (a missing master took it 6-14 s at 5 s); the
    store and the group take that timeout too. A rendezvous thread still
    waiting when the error is raised ends with the process."""
    env = os.environ
    if "RANK" not in env or "WORLD_SIZE" not in env \
            or dist.is_initialized():
        return
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    addr = env.get("MASTER_ADDR", "localhost")
    port = int(env.get("MASTER_PORT", "29500"))
    if timeout_s is None:
        timeout_s = int(env.get(TIMEOUT_ENV, DEFAULT_TIMEOUT_S))
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    timeout = datetime.timedelta(seconds=timeout_s)
    # under torchrun its agent already serves the store
    master = rank == 0 and env.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    failed = []

    def _rendezvous():
        try:
            store = dist.TCPStore(addr, port, world, is_master=master,
                                  timeout=timeout)
            dist.init_process_group(backend, store=store, rank=rank,
                                    world_size=world, timeout=timeout)
            store.add("init_distributed/arrived", 1)
            while store.add("init_distributed/arrived", 0) < world:
                time.sleep(0.01)
        except RuntimeError as e:                  # DistError is one
            failed.append(f"{type(e).__name__}: {str(e).splitlines()[0]}")

    thread = threading.Thread(target=_rendezvous, daemon=True)
    thread.start()
    thread.join(timeout_s)
    if thread.is_alive() or failed:
        raise RuntimeError(
            f"process-group rendezvous failed after {timeout_s}s: rank "
            f"{rank}/{world} could not meet its peers at {addr}:{port} - a "
            "peer is missing, unreachable, or died before the rendezvous ("
            + (failed[0] if failed else "no answer in time") + ")")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1, device=None,
              backend: Optional[str] = None) -> Mesh:
    """The mesh ('data', 'model') over the world. With no process group
    initialised it makes a world of one itself (a HashStore), so one
    process takes the mesh path. ``backend``: the groups' backend, default
    the world's (NCCL for CUDA tensors, gloo for CPU ones); where the
    world's group has another, groups of this backend are made (two ranks
    sharing one card need gloo, which takes CUDA tensors through the host).
    ``n_data * n_model`` must be the world size, else ValueError (before
    any group is made). With ``n_model = 1`` the data group spans the
    world (the world's group itself where the backend is its own); with
    ``n_model > 1`` every rank makes each data and each model group of more
    than one rank (the module's docstring)."""
    dev = resolve(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    n_data = world // n_model if n_data is None else n_data
    if n_model < 1 or n_data < 1 or n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not match the "
                         f"world size {world}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            store=dist.HashStore(), rank=0, world_size=1)
    shape = {DATA_AXIS: n_data, MODEL_AXIS: n_model}
    if n_model == 1:
        group = dist.group.WORLD
        if backend is not None and backend != dist.get_backend():
            group = dist.new_group(backend=backend)
        return Mesh(group=group, shape=shape, rank=dist.get_rank(group),
                    device=dev)
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    groups = {}
    for axis, n_groups, members in (
            (DATA_AXIS, n_model,
             lambda i: [k * n_model + i for k in range(n_data)]),
            (MODEL_AXIS, n_data,
             lambda i: [i * n_model + k for k in range(n_model)])):
        for i in range(n_groups):
            ranks = members(i)
            if len(ranks) > 1:
                g = dist.new_group(ranks, backend=backend)
                if rank in ranks:
                    groups[axis] = g
    return Mesh(group=groups.get(DATA_AXIS), shape=shape, rank=d, device=dev,
                model_group=groups.get(MODEL_AXIS), model_rank=m)


def _env_block(mesh: Mesh, n: int) -> tuple:
    """(start, length) of this rank's contiguous block of ``n`` envs."""
    n_data = mesh.shape[DATA_AXIS]
    if n % n_data:
        raise ValueError(f"{n} envs do not split evenly over the data "
                         f"axis of size {n_data}")
    m = n // n_data
    return mesh.rank * m, m


def shard_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's contiguous block of envs of a whole batch: axis 0 of the
    (N, ...) keys (views), the last axis of the feature-first (T, d, N) and
    (T, N) keys (contiguous, as the kernels read them), on the mesh's
    device. Over a world of one, the batch as it is."""
    out = {}
    for k, v in batch.items():
        axis = v.dim() - 1 if k in FF_KEYS else 0
        start, m = _env_block(mesh, v.shape[axis])
        v = v.narrow(axis, start, m).to(mesh.device)
        out[k] = v.contiguous() if k in FF_KEYS else v
    return out


def make_sharded_update(cfg, mesh: Mesh):
    """``update(params, w, batch, **kw)``: ``trpo_update`` on this rank's
    shard of a pre-collected batch (``shard_batch``), with ``axis_name``
    the mesh's 'data' group; ``kw`` as ``trpo_update`` takes them."""
    def update(params, w, batch, **kw):
        return trpo_update(cfg, params, w, batch, axis_name=mesh.group, **kw)
    return update


def make_sharded_update_tp(cfg, mesh: Mesh):
    """``update(params, w, batch, **kw)``: the tensor-parallel update
    (``parallel/tensor.py``, JAX ``mesh.py:228-254``) on this rank's
    ``shard_batch`` of a pre-collected batch: the full ``params`` sharded
    to this model rank's shard, ``trpo_update_tp`` over the mesh's data and
    model groups, the new shard gathered back to the full parameters, the
    same bits on every rank. ``kw``: ``return_directions``. A policy with
    fewer than two hidden layers, or a first hidden width that does not
    split over the model axis, raises ValueError."""
    from .tensor import (shard_policy_params, trpo_update_tp,
                         unshard_policy_params)
    n_model, idx = mesh.shape[MODEL_AXIS], mesh.model_rank

    def update(params, w, batch, **kw):
        local = shard_policy_params(params, n_model, idx)
        new, w_new, stats = trpo_update_tp(cfg, local, w, batch, mesh.group,
                                           mesh.model_group, n_model, idx,
                                           **kw)
        return (unshard_policy_params(new, n_model, idx, mesh.model_group),
                w_new, stats)
    return update


def _fold(state: bytes, tag: bytes) -> int:
    """A 63-bit seed from SHA-256 of a generator state and a tag."""
    return int.from_bytes(hashlib.sha256(state + tag).digest()[:8],
                          "little") >> 1


def rank_stream(mesh: Mesh, gen: torch.Generator) -> torch.Generator:
    """This step's rollout generator on this rank (the module's rule):
    ``gen`` itself over a world of one; else a generator seeded from
    ``gen``'s state and the rank, with ``gen`` reseeded from its state and
    "next"."""
    if mesh.shape[DATA_AXIS] == 1:
        return gen
    state = gen.get_state().numpy().tobytes()
    out = torch.Generator(device=gen.device)
    out.manual_seed(_fold(state, b"rank %d" % mesh.rank))
    gen.manual_seed(_fold(state, b"next"))
    return out


def local_envs(mesh: Mesh, n_envs: int) -> int:
    """The envs a rank rolls out: ``n_envs / n_data``; uneven envs raise
    ValueError (JAX ``mesh.py:118-120``)."""
    return _env_block(mesh, n_envs)[1]


def make_sharded_train_step(cfg, mesh: Mesh):
    """``train_step(state) -> (state, stats)`` on the mesh (JAX's
    ``make_sharded_train_step``): ``make_train_step`` over ``mesh``, each
    rank rolling out ``cfg.n_envs / n_data`` envs from its rank stream with
    the full parameters, then the data-parallel update, or with
    ``n_model > 1`` the tensor-parallel one. Uneven envs raise
    ValueError."""
    return make_train_step(cfg, mesh)


def train_sharded(cfg, mesh: Mesh, n_iters=None, seed=None, log_fn=None,
                  state: Optional[TrainState] = None,
                  checkpoint_every: int = 0, checkpoint_dir=None):
    """Training over the sharded step; returns (state, history) on every
    rank. Every rank starts from the same state (``init_state`` on the
    mesh's device, or the one given, e.g. a loaded checkpoint); rank 0
    calls ``log_fn`` and writes the checkpoints (``utils/checkpoint.py``)."""
    n_iters = cfg.n_iters if n_iters is None else n_iters
    if state is None:
        state = init_state(cfg, seed, mesh.device)
    return run_steps(cfg, make_sharded_train_step(cfg, mesh), state, n_iters,
                     log_fn if dist.get_rank() == 0 else None,
                     checkpoint_every, checkpoint_dir)
