"""Checkpoints and deterministic resume (port of
``trpo_robot_control_tpu/utils/checkpoint.py``).

A plain ``np.savez`` of the train state with a config hash, in the JAX
package's keys: ``params.<k>``, then ``w`` (linear baseline) or ``w.<k>``
(the MLP's), ``key``, ``iteration`` and ``__config_hash__``, so a
checkpoint loads in either package. The port adds its generator's state
(``gen_state``, ``gen_device``), so a resumed run is bit-identical to an
uninterrupted one, and writes as ``key`` two uint32 words derived from that
state, which the JAX loader reads. A JAX checkpoint has no generator
state: loaded here, its generator is seeded from the two words of ``key``,
so the random stream from there on differs from the one JAX would draw,
as the port's stream differs from JAX's everywhere.

Under data parallelism (``parallel/mesh.py``) every rank holds the same
state, so rank 0 writes it and every rank loads it; the sharded step
derives the ranks' rollout streams from the loaded generator.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve


def config_hash(cfg) -> str:
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


def _key_words(state_bytes: bytes) -> np.ndarray:
    """Two uint32 words from a generator state (its SHA-256's first 8
    bytes)."""
    return np.frombuffer(hashlib.sha256(state_bytes).digest()[:8],
                         dtype=">u4").astype(np.uint32)


def save_checkpoint(ckpt_dir: str, cfg, state) -> str:
    """Writes ``state`` to ``ckpt_dir/ckpt_<iteration>.npz`` and returns the
    path; in a process group only rank 0 writes (the others return the
    path)."""
    it = int(state.iteration)
    path = os.path.join(ckpt_dir, f"ckpt_{it:06d}.npz")
    if dist.is_initialized() and dist.get_rank() != 0:
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    arrays = {f"params.{k}": v.detach().cpu().numpy()
              for k, v in state.params.items()}
    if isinstance(state.w, dict):        # MLP baseline: a dict of weights
        arrays.update({f"w.{k}": v.detach().cpu().numpy()
                       for k, v in state.w.items()})
    else:
        arrays["w"] = state.w.detach().cpu().numpy()
    gen_state = state.gen.get_state().numpy()
    arrays["gen_state"] = gen_state
    arrays["gen_device"] = np.asarray(state.gen.device.type)
    arrays["key"] = _key_words(gen_state.tobytes())
    arrays["iteration"] = np.asarray(it, np.int32)
    np.savez(path, __config_hash__=config_hash(cfg), **arrays)
    return path


def load_checkpoint(path: str, cfg=None, device=None):
    """The TrainState saved at ``path``, on ``device`` (default cuda, as
    every entry point); with ``cfg``, ValueError unless its hash is the
    one the checkpoint was saved with."""
    from ..trpo.train import TrainState
    dev = resolve(device)
    data = np.load(path)
    if cfg is not None:
        stored = str(data["__config_hash__"])
        if stored != config_hash(cfg):
            raise ValueError(
                f"checkpoint config hash {stored} != current "
                f"{config_hash(cfg)}: refusing a silent mismatch")

    def tensor(name):
        return torch.from_numpy(np.array(data[name])).to(dev)

    params = {k[len("params."):]: tensor(k)
              for k in data.files if k.startswith("params.")}
    if "w" in data.files:
        w = tensor("w")
    else:                                # MLP baseline
        w = {k[len("w."):]: tensor(k)
             for k in data.files if k.startswith("w.")}
    gen = torch.Generator(device=dev)
    if "gen_state" in data.files and str(data["gen_device"]) == dev.type:
        gen.set_state(torch.from_numpy(np.array(data["gen_state"])))
    else:                                # a JAX checkpoint, or another device
        k0, k1 = (int(x) for x in np.asarray(data["key"], np.uint32))
        gen.manual_seed((k0 << 32) | k1)
    return TrainState(params=params, w=w, gen=gen,
                      iteration=int(data["iteration"]))


def latest_checkpoint(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return None
    files = sorted(f for f in os.listdir(ckpt_dir)
                   if f.startswith("ckpt_") and f.endswith(".npz"))
    return os.path.join(ckpt_dir, files[-1]) if files else None
