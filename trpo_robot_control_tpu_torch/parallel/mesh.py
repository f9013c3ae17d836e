"""Data parallelism over ``torch.distributed`` (port of
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

A 'model' axis is reserved in the mesh's shape, as in JAX; ``n_model > 1``
(tensor parallelism) raises: ROADMAP A6.
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
    """The mesh over the world: ``group``, the 'data' axis's process group;
    ``shape``, {"data": n_data, "model": n_model}; ``rank``, this process's
    index on 'data'; ``device``, its device."""
    group: object
    shape: dict
    rank: int
    device: torch.device


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
    process takes the mesh path. ``backend``: the data group's backend,
    default the world's (NCCL for CUDA tensors, gloo for CPU ones); where
    the world's group has another, a group of this backend over all ranks
    is made (two ranks sharing one card need gloo, which takes CUDA
    tensors through the host). ``n_data * n_model`` must be the world
    size; ``n_model > 1`` raises NotImplementedError: ROADMAP A6."""
    if n_model > 1:
        raise NotImplementedError(
            f"n_model={n_model}: tensor parallelism (the 'model' axis) is "
            "not ported yet: ROADMAP A6")
    dev = resolve(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    n_data = world // n_model if n_data is None else n_data
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data} x {n_model} does not match the "
                         f"world size {world}")
    group = dist.group.WORLD
    if backend is not None and backend != dist.get_backend():
        group = dist.new_group(backend=backend)
    return Mesh(group=group, shape={DATA_AXIS: n_data, MODEL_AXIS: n_model},
                rank=dist.get_rank(group), device=dev)


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
    data-parallel branch, ``:166-183`` there): ``make_train_step`` over
    ``mesh``, each rank rolling out ``cfg.n_envs / n_data`` envs from its
    rank stream. Uneven envs raise ValueError."""
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
