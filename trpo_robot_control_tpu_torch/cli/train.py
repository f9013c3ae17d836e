"""Training CLI for the PyTorch port: pick a config, train, print one line
of stats per iteration, with JSONL metrics and checkpoints.

  python -m trpo_robot_control_tpu_torch.cli.train --config c1_reacher2 --iters 50
  python -m trpo_robot_control_tpu_torch.cli.train --config c5_multitask \
      --iters 2 --device cpu --n-envs 64 --horizon 16
  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 \
      --iters 20 --done-dist 0.1
  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 \
      --baseline mlp --trpo hidden=32,32 --trpo cg_iters=20 \
      --jsonl run.jsonl --ckpt-dir ckpt --ckpt-every 10
  python -m trpo_robot_control_tpu_torch.cli.train --config c2_reacher3 \
      --resume ckpt/ckpt_000020.npz --iters 20
  torchrun --standalone --nproc_per_node 2 \
      -m trpo_robot_control_tpu_torch.cli.train --device cpu --sharded \
      --n-envs 32 --horizon 20 --iters 2
  torchrun --standalone --nproc_per_node 4 \
      -m trpo_robot_control_tpu_torch.cli.train --device cpu --n-model 2 \
      --n-envs 32 --horizon 20 --iters 2

Runs on the CUDA device unless ``--device cpu`` is given. ``--trpo
KEY=VALUE`` sets any TRPOSpec field, cast to the field's type (a tuple
field takes comma-separated integers, a bool field true/false/1/0).

Data parallelism (``parallel/mesh.py``): under torchrun (its RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) every rank joins the
process group, takes card LOCAL_RANK % the card count, and trains on its
share of the envs; ``--sharded`` takes the mesh path in one process too.
``--n-model M`` (tensor parallelism, ``parallel/tensor.py``) over 1 takes
the mesh path with a 'model' axis of M ranks: the world's size / M data
indices, each of M ranks sharing its envs and holding 1/M of the policy's
first hidden layer; the world's size must be a multiple of M. Rank 0
prints, logs and writes the checkpoints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _cast(cur, raw: str):
    """``raw`` as a value of the type of ``cur``."""
    if isinstance(cur, bool):
        if raw.lower() not in ("true", "false", "1", "0"):
            raise ValueError(f"not a bool: {raw!r}")
        return raw.lower() in ("true", "1")
    if isinstance(cur, tuple):
        return tuple(int(x) for x in raw.split(",") if x.strip())
    return type(cur)(raw)


def trpo_overrides(trpo, pairs):
    """``trpo`` with each KEY=VALUE of ``pairs`` set; exits, listing the
    fields, on a field TRPOSpec does not have."""
    fields = [f.name for f in dataclasses.fields(trpo)]
    over = {}
    for kv in pairs:
        key, sep, raw = kv.partition("=")
        if not sep or key not in fields:
            sys.exit(f"--trpo: unknown TRPOSpec field {kv!r} "
                     f"(fields: {fields})")
        try:
            over[key] = _cast(getattr(trpo, key), raw)
        except ValueError as err:
            sys.exit(f"--trpo {kv!r}: {err}")
    return dataclasses.replace(trpo, **over)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config", default="c1_reacher2",
                    help="c1_reacher2, c2_reacher3, c3_franka7, "
                         "c4_franka7_obstacle or c5_multitask")
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--n-envs", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=None)
    ap.add_argument("--done-dist", type=float, default=None,
                    help="early episode termination distance (0 = fixed "
                         "horizon; > 0 = an episode ends, and the env "
                         "starts a fresh one, on reaching the target)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (cpu runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for checkpoints (one at the end, and "
                         "every --ckpt-every iterations)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", default=None,
                    help="path to a checkpoint .npz to resume from (the "
                         "JAX package's checkpoints load too)")
    ap.add_argument("--jsonl", default=None, help="metrics JSONL path")
    ap.add_argument("--baseline", choices=("linear", "mlp"), default=None,
                    help="value baseline: linear ridge fit (default) or "
                         "small-MLP Adam refit")
    ap.add_argument("--sharded", action="store_true",
                    help="take the data-parallel mesh path even in one "
                         "process (it is taken whenever the world has more "
                         "than one rank)")
    ap.add_argument("--n-model", type=int, default=1,
                    help="tensor-parallel 'model' axis size (the policy's "
                         "first hidden layer sharded over it; "
                         "parallel/tensor.py); over 1 takes the mesh path")
    ap.add_argument("--trpo", action="append", default=[],
                    metavar="KEY=VALUE",
                    help="set a TRPOSpec field, e.g. --trpo cg_iters=20 "
                         "--trpo hidden=32,32 --trpo delta=0.005 "
                         "(repeatable; cast to the field's type)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from ..configs import CONFIGS
    from ..parallel.mesh import init_distributed, make_mesh, train_sharded
    from ..trpo.train import train
    from ..utils.checkpoint import (config_hash, load_checkpoint,
                                    save_checkpoint)
    from ..utils.metrics import JsonlLogger

    cfg = CONFIGS[args.config]
    if args.n_envs:
        cfg = cfg.replace(n_envs=args.n_envs)
    if args.horizon:
        cfg = cfg.replace(horizon=args.horizon)
    if args.done_dist is not None:
        cfg = cfg.replace(done_dist=args.done_dist)
    if args.baseline is not None:
        cfg = cfg.replace(trpo=dataclasses.replace(cfg.trpo,
                                                   baseline=args.baseline))
    if args.trpo:
        cfg = cfg.replace(trpo=trpo_overrides(cfg.trpo, args.trpo))
    early_steps = (cfg.horizon - 1) * cfg.n_envs

    init_distributed()
    world = dist.get_world_size() if dist.is_initialized() else 1
    sharded = args.sharded or world > 1 or args.n_model > 1
    lead = not dist.is_initialized() or dist.get_rank() == 0
    device = args.device
    if sharded and (device is None or device == "cuda") \
            and torch.cuda.is_available():
        local = int(os.environ.get("LOCAL_RANK", "0"))
        device = f"cuda:{local % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    logger = JsonlLogger(args.jsonl if lead else None, echo=False)
    logger.header({"config": cfg.name, "config_hash": config_hash(cfg),
                   "n_envs": cfg.n_envs, "horizon": cfg.horizon})
    state = load_checkpoint(args.resume, cfg, device) \
        if args.resume else None

    def log(s):
        logger(s)
        done = ""
        if "early_dones" in s:
            done = (f"  early dones {int(s['early_dones'])} "
                    f"({100 * s['early_dones'] / early_steps:.3f}%)")
        print(f"iter {s['iter']:4d}  return {s['mean_return']:9.3f}  "
              f"kl {s['kl']:.5f}  accepted {s['accepted']:2d}  "
              f"beta {s['beta']:.4f}  surr {s['surr']:+.5f}  "
              f"cg_res {s['cg_residual']:.3e}{done}  "
              f"{1e3 * s['wall_s']:.1f} ms", flush=True)

    run = dict(n_iters=args.iters, seed=args.seed, log_fn=log, state=state,
               checkpoint_every=args.ckpt_every, checkpoint_dir=args.ckpt_dir)
    if sharded:
        mesh = make_mesh(n_model=args.n_model, device=device)
        if lead:
            kind = torch.cuda.get_device_name(mesh.device) \
                if mesh.device.type == "cuda" else "cpu"
            print(f"mesh: {mesh.shape} over {world} rank(s), "
                  f"{dist.get_backend(mesh.group)}, {kind}", file=sys.stderr)
        state, _ = train_sharded(cfg, mesh, **run)
    else:
        state, _ = train(cfg, device=device, **run)
    if args.ckpt_dir:
        path = save_checkpoint(args.ckpt_dir, cfg, state)
        if lead:
            print(f"checkpoint: {path}", file=sys.stderr)
    logger.close()
    if sharded:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
